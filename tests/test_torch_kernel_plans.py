"""The launch plans of the port's two CUDA kernels, walked on the CPU.

The kernels themselves run only on a card, but every index they compute
comes from the plan their wrappers build in Python (``fir_plan``,
``bias_act_plan``). Here each plan is walked in numpy block by block, tile
by tile and phase by phase, reading exactly what the kernel reads (the
staged window, the intermediate rows, the 16-byte runs), and the result is
held against the JAX package's ``upfirdn2d_pallas`` (interpreted on the
CPU, as its own tests run it) and ``upfirdn2d_ref``, and against the plain
``bias_act``. At the serving path's full-width shapes only the geometry is
checked: each output written exactly once, every window inside the padded
input, shared memory within the card's 227 KB, and which instantiation runs.
The backward's two FIR calls (the adjoints of the path's two) are walked and
checked the same way.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_ops import F1D, UPFIRDN_CASES
from viscoin_tpu.ops.upfirdn2d import upfirdn2d_ref as jax_upfirdn2d_ref
from viscoin_tpu.ops.upfirdn2d_pallas import upfirdn2d_pallas as jax_upfirdn2d_pallas
from viscoin_tpu_torch.ops.bias_act import (
    BIAS_ACT_ITEMS,
    BIAS_ACT_THREADS,
    bias_act_plain,
    bias_act_plan,
    vector_aligned,
)
from viscoin_tpu_torch.ops.upfirdn2d import (
    RUN_ROWS,
    RUNTIME_VARIANT,
    SMEM_LIMIT,
    VARIANTS,
    _taps,
    adjoint_padding,
    fir_plan,
    output_size,
    setup_filter,
)

# The kernels' element types: fp32 and the two 16-bit ones (a 16-bit plan,
# 16-byte runs of 8 outputs, is the same for bf16 and fp16; each is walked).
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
DTYPE_IDS = ["fp32", "bf16", "fp16"]

# The flagship generator (256², channel_base 16384, channel_max 512, batch 8):
# the FIR after each up-conv sees (8, C_r, r+1, r+1), the skip-image
# upsample (8, 3, r/2, r/2), for r = 8 .. 256.
RESOLUTIONS = (8, 16, 32, 64, 128, 256)
CONV_FIR = dict(up=1, down=1, padding=1, gain=4.0)
SKIP_UP = dict(up=2, down=1, padding=(2, 1, 2, 1), gain=4.0)
# Their adjoints, which the backward runs on the output gradients
# (8, C_r, r, r) and (8, 3, r, r): pad 2 back to r + 1, and a down-2 FIR
# with pad 1 back to r / 2; both with the taps flipped.
CONV_FIR_ADJ = dict(up=1, down=1, padding=(2, 2, 2, 2), gain=4.0, flip_filter=True)
SKIP_UP_ADJ = dict(up=1, down=2, padding=(1, 1, 1, 1), gain=4.0, flip_filter=True)


def channels(res: int) -> int:
    return min(16384 // res, 512)


def path_fir_calls():
    return ([((8, channels(r), r + 1, r + 1), CONV_FIR) for r in RESOLUTIONS]
            + [((8, 3, r // 2, r // 2), SKIP_UP) for r in RESOLUTIONS])


def path_adjoint_calls():
    return ([((8, channels(r), r, r), CONV_FIR_ADJ) for r in RESOLUTIONS]
            + [((8, 3, r, r), SKIP_UP_ADJ) for r in RESOLUTIONS])


# The discriminator (256², channel_base 16384, batch 16) filters before each
# stride-2 conv: conv1's 3x3 with FIR pad 2 ((16, C_r, r, r) -> r + 1) and
# the 1x1 skip with FIR pad 1 (r -> r - 1); their adjoints take the flipped
# taps with pad 1 (r + 1 -> r) and pad 2 (r - 1 -> r). R1's second order
# runs the adjoint's adjoint, the forward geometry again.
D_CONV_FIR = dict(up=1, down=1, padding=(2, 2, 2, 2), gain=1.0)
D_SKIP_FIR = dict(up=1, down=1, padding=(1, 1, 1, 1), gain=1.0)
D_CONV_FIR_ADJ = dict(up=1, down=1, padding=(1, 1, 1, 1), gain=1.0, flip_filter=True)
D_SKIP_FIR_ADJ = dict(up=1, down=1, padding=(2, 2, 2, 2), gain=1.0, flip_filter=True)


def d_fir_calls():
    """(input shape, call, output side) of the discriminator's FIRs and their
    adjoints at full width."""
    calls = []
    for r in RESOLUTIONS:
        c = channels(r)
        calls += [((16, c, r, r), D_CONV_FIR, r + 1), ((16, c, r, r), D_SKIP_FIR, r - 1),
                  ((16, c, r + 1, r + 1), D_CONV_FIR_ADJ, r),
                  ((16, c, r - 1, r - 1), D_SKIP_FIR_ADJ, r)]
    return calls


def path_bias_act_shapes():
    """13 synthesis layers, 7 ToRGB, 20 affines, 2 mapping groups (42)."""
    synth = [(8, 512, 4, 4)] + [(8, channels(r), r, r) for r in RESOLUTIONS for _ in range(2)]
    torgb = [(8, 3, r, r) for r in (4,) + RESOLUTIONS]
    affine = [(8, 512)] * 20
    mapping = [(8, 12, 512), (8, 2, 512)]
    return synth + torgb + affine + mapping


# ------------------------------- upfirdn2d walk ------------------------------ #


def walk_fir(plan, x: np.ndarray) -> np.ndarray:
    """Run ``plan`` over NCHW ``x`` the way csrc/upfirdn2d.cu does: block ->
    (plane group, tile), stage the zero-filled window, vertical pass into an
    intermediate buffer (NaN where the kernel never writes, so a read of it
    that reaches an output shows), horizontal pass, store. Asserts that every
    read lies inside its buffer and every output is written exactly once."""
    B, C, H, W = x.shape
    planes = x.reshape(B * C, H, W).astype(np.float64)
    k = len(plan.taps)
    (uy, ux), (dy, dx) = plan.up, plan.down
    ty = np.asarray(plan.taps, np.float32).astype(np.float64)
    tx = (np.asarray(plan.taps, np.float32) * np.float32(plan.gain)).astype(np.float64)
    y = np.full((plan.planes, plan.ho, plan.wo), np.nan)
    written = np.zeros(y.shape, np.int64)
    assert plan.xs_floats % 4 == 0 and plan.lwp % 4 == 0
    assert 4 * (plan.xs_floats + plan.ppb * plan.th * plan.lwp) == plan.smem_bytes <= SMEM_LIMIT
    for b in range(plan.blocks):
        tile_x, rest = b % plan.tiles_x, b // plan.tiles_x
        tile_y, plane0 = rest % plan.tiles_y, (rest // plan.tiles_y) * plan.ppb
        n = min(plan.ppb, plan.planes - plane0)
        oy0, ox0 = tile_y * plan.th, tile_x * plan.tw
        iy0, ix0 = plan.window_origin(0, tile_y), plan.window_origin(1, tile_x)

        # 1. stage the window, zero outside the input
        xs = np.zeros((n, plan.lh, plan.lw))
        gy, gx = iy0 + np.arange(plan.lh), ix0 + np.arange(plan.lw)
        iy, ix = np.nonzero((gy >= 0) & (gy < H))[0], np.nonzero((gx >= 0) & (gx < W))[0]
        xs[:, iy[:, None], ix[None, :]] = planes[plane0:plane0 + n][:, gy[iy][:, None],
                                                                    gx[ix][None, :]]
        # 2. vertical pass
        tmp = np.full((n, plan.th, plan.lwp), np.nan)
        if plan.sliding:
            nw = (RUN_ROWS - 1) * dy + k
            for run in range(plan.th // RUN_ROWS):
                base = run * RUN_ROWS * dy
                assert base + nw <= plan.lh
                win = xs[:, base:base + nw]
                for r in range(RUN_ROWS):
                    acc = np.zeros((n, plan.lw))
                    for j in range(k):
                        acc += ty[j] * win[:, r * dy + j]
                    tmp[:, run * RUN_ROWS + r, :plan.lw] = acc
        else:
            for r in range(plan.th):
                j0, first = plan.phase(0, oy0 + r, iy0)
                acc = np.zeros((n, plan.lw))
                for m, j in enumerate(range(j0, k, uy)):
                    assert 0 <= first + m < plan.lh
                    acc += ty[j] * xs[:, first + m]
                tmp[:, r, :plan.lw] = acc
        # 3. horizontal pass, vo outputs per thread
        for r in range(plan.th):
            oy = oy0 + r
            for xo in range(0, plan.tw, plan.vo):
                ox = ox0 + xo
                if oy >= plan.ho or ox >= plan.wo:
                    continue
                out = np.zeros((plan.vo, n))
                if plan.sliding:
                    start = xo * dx
                    assert start % 4 == 0 and start + 4 * plan.nv4 <= plan.lwp
                    win = tmp[:, r, start:start + 4 * plan.nv4]
                    for v in range(plan.vo):
                        for j in range(k):
                            out[v] += tx[j] * win[:, v * dx + j]
                else:
                    for v in range(plan.vo):
                        j0, first = plan.phase(1, ox + v, ix0)
                        for m, j in enumerate(range(j0, k, ux)):
                            assert 0 <= first + m < plan.lw
                            out[v] += tx[j] * tmp[:, r, first + m]
                stored = min(plan.vo, plan.wo - ox)
                assert not plan.vec_store or stored == plan.vo
                y[plane0:plane0 + n, oy, ox:ox + stored] = out[:stored].T
                written[plane0:plane0 + n, oy, ox:ox + stored] += 1
    assert (written == 1).all(), "an output was not written exactly once"
    return y.reshape(B, C, plan.ho, plan.wo)


def check_fir(x_nhwc: np.ndarray, taps, *, pallas: bool = True, **kw):
    """Each dtype's plan (fp32, and the 16-bit bf16 and fp16) walked against
    the JAX kernel and oracle; 1e-5."""
    x = np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2))
    f = setup_filter(taps)
    want = jax_upfirdn2d_ref(x_nhwc, np.outer(f.numpy(), f.numpy()), **kw)
    wants = [want]
    if pallas:
        wants.append(np.asarray(jax_upfirdn2d_pallas(jnp.asarray(x_nhwc), list(taps), **kw)))
    plans = []
    for dtype in DTYPES:
        plan = fir_plan(x.shape, _taps(f), dtype=dtype, **kw)
        got = walk_fir(plan, x).transpose(0, 2, 3, 1)
        for w in wants:
            assert got.shape == w.shape
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-5)
        plans.append(plan)
    return plans


@pytest.mark.parametrize("case", UPFIRDN_CASES, ids=str)
def test_fir_plan_walk_matches_jax(case):
    """The six configurations of test_torch_ops.py; the bf16 plan (16-byte
    runs of 8 outputs) walks other tiles than the fp32 one."""
    x = np.random.default_rng(3).standard_normal((2, 8, 12, 8)).astype(np.float32)
    plans = check_fir(x, F1D, **case)
    key = (4, case["up"], case["down"])
    assert {p.variant for p in plans} == {VARIANTS[key]}


@pytest.mark.parametrize("flip", [False, True])
def test_fir_plan_walk_asymmetric_taps(flip):
    x = np.random.default_rng(4).standard_normal((1, 10, 10, 4)).astype(np.float32)
    check_fir(x, [1.0, 2.0, 4.0, 8.0], up=2, padding=(3, 2, 3, 2), gain=4.0, flip_filter=flip)


def test_fir_plan_walk_odd_channels():
    x = np.random.default_rng(5).standard_normal((1, 6, 7, 3)).astype(np.float32)
    check_fir(x, F1D, up=2, padding=(2, 1, 2, 1), gain=4.0)


@pytest.mark.parametrize("case", UPFIRDN_CASES, ids=str)
def test_fir_plan_walk_ragged_tiles(case):
    """(3, 5, 37, 41): tiles that overhang the plane on both axes."""
    x = np.random.default_rng(6).standard_normal((3, 37, 41, 5)).astype(np.float32)
    check_fir(x, F1D, pallas=False, **case)


@pytest.mark.parametrize("taps,kw", [
    ([1.0, 1.0], dict(up=2, padding=(1, 0, 1, 0))),
    ([1.0, 2.0, 1.0], dict(down=2, padding=1)),
    ([1.0, 4.0, 6.0, 4.0, 1.0], dict(up=2, padding=(2, 2, 2, 2), gain=4.0)),
    (list(range(1, 17)), dict(padding=(8, 7, 8, 7))),
    ([1.0, 3.0, 3.0, 1.0], dict(up=(2, 1), down=(1, 2), padding=(1, 0, 2, 1))),
    ([1.0, 2.0, 3.0], dict(up=3, down=2, padding=(2, -1, 1, 0))),
], ids=["k2-up2", "k3-down2", "k5-up2", "k16", "mixed-axes", "k3-up3-down2"])
def test_fir_plan_walk_runtime_instantiation(taps, kw):
    """Other tap counts and per-axis factors take the runtime instantiation
    of the same tiled kernel."""
    x = np.random.default_rng(7).standard_normal((2, 9, 11, 3)).astype(np.float32)
    plans = check_fir(x, taps, pallas=len(taps) <= 5, **kw)
    assert {p.variant for p in plans} == {RUNTIME_VARIANT}


def test_fir_plan_many_planes():
    """More planes than gridDim.y could hold: planes ride the block index."""
    plan = fir_plan((1, 70000, 3, 3), _taps(setup_filter(F1D)), padding=1)
    x = np.random.default_rng(8).standard_normal((1, 70000, 3, 3)).astype(np.float32)
    blocks = np.arange(plan.blocks)
    rest = blocks // plan.tiles_x
    plane0 = (rest // plan.tiles_y) * plan.ppb
    assert plane0.max() + plan.ppb >= 70000 > 65535
    f = setup_filter(F1D).numpy()
    want = jax_upfirdn2d_ref(x.transpose(0, 2, 3, 1), np.outer(f, f), padding=1)
    np.testing.assert_allclose(walk_fir(plan, x), want.transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)


# ------------------------ upfirdn2d at full width ---------------------------- #


def axis_check(plan, axis: int, n_in: int, n_out: int, pad1: int):
    """Along one axis: tiles cover [0, n_out) exactly once, each tile's reads
    stay inside its window, and the window inside the padded input."""
    t = plan.th if axis == 0 else plan.tw
    tiles = plan.tiles_y if axis == 0 else plan.tiles_x
    size = plan.lh if axis == 0 else plan.lw
    up, down, pad0 = plan.up[axis], plan.down[axis], plan.pad0[axis]
    cover = np.zeros(n_out, np.int64)
    for tile in range(tiles):
        origin = plan.window_origin(axis, tile)
        assert origin * up >= -pad0
        assert (origin + size - 1) * up <= n_in * up - 1 + pad1
        for o in range(tile * t, (tile + 1) * t):
            j0, first = plan.phase(axis, o, origin)
            ntaps = len(range(j0, len(plan.taps), up))
            assert first >= 0 and first + ntaps <= size, (axis, tile, o)
            if o < n_out:
                cover[o] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("shape,kw", path_fir_calls(),
                         ids=[f"{s}-up{kw['up']}" for s, kw in path_fir_calls()])
def test_fir_plan_geometry_at_path_shapes(shape, kw, dtype):
    plan = fir_plan(shape, _taps(setup_filter(F1D)), dtype=dtype, **kw)
    assert plan.variant == VARIANTS[(4, kw["up"], 1)]
    assert plan.sliding == (kw["up"] == 1)
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.vec_store and plan.ho % plan.th == 0 and plan.wo % plan.tw == 0
    px0, px1, py0, py1 = (1, 1, 1, 1) if kw["up"] == 1 else (2, 1, 2, 1)
    axis_check(plan, 0, shape[2], plan.ho, py1)
    axis_check(plan, 1, shape[3], plan.wo, px1)
    # Block -> (plane group, tile) is a bijection onto the groups and tiles.
    blocks = np.arange(plan.blocks)
    tile_x, rest = blocks % plan.tiles_x, blocks // plan.tiles_x
    tile_y, group = rest % plan.tiles_y, rest // plan.tiles_y
    ids = (group * plan.tiles_y + tile_y) * plan.tiles_x + tile_x
    assert np.array_equal(np.sort(ids), blocks)
    assert group.max() == math.ceil(plan.planes / plan.ppb) - 1
    if plan.wo >= 64:  # large planes: one plane per block, tiles up to 32 x 128
        assert (plan.ppb, plan.th, plan.tw) == (1, 32, min(plan.wo, 128))
    else:  # small planes: several whole planes per block
        assert (plan.th, plan.tw) == (plan.ho, max(plan.wo, plan.vo)) and plan.ppb > 1


def ragged_axis_check(plan, axis: int, n_in: int, n_out: int, pad1: int):
    """As :func:`axis_check` where the last tile overhangs the plane (its
    window then reaches past the padded input, where staging reads zeros):
    tiles cover [0, n_out) once, every read stays in the window, and the
    reads of every real output stay inside the padded input."""
    t = plan.th if axis == 0 else plan.tw
    tiles = plan.tiles_y if axis == 0 else plan.tiles_x
    size = plan.lh if axis == 0 else plan.lw
    up, pad0 = plan.up[axis], plan.pad0[axis]
    cover = np.zeros(n_out, np.int64)
    for tile in range(tiles):
        origin = plan.window_origin(axis, tile)
        for o in range(tile * t, (tile + 1) * t):
            j0, first = plan.phase(axis, o, origin)
            ntaps = len(range(j0, len(plan.taps), up))
            assert first >= 0 and first + ntaps <= size, (axis, tile, o)
            if o < n_out:
                cover[o] += 1
                assert (origin + first) * up >= -pad0
                assert (origin + first + ntaps - 1) * up <= n_in * up - 1 + pad1
    assert (cover == 1).all()


@pytest.mark.parametrize("case,x_shape,down", [(CONV_FIR_ADJ, (2, 9, 9), 1),
                                               (SKIP_UP_ADJ, (2, 4, 4), 2)],
                         ids=["conv-fir-adjoint", "skip-up-adjoint"])
def test_fir_plan_walk_adjoint_plans(case, x_shape, down):
    """The backward's two FIR plans walked against the JAX kernel and oracle,
    at a ragged (9 -> 10) and a small (8 -> 4) plane; their padding is what
    adjoint_padding gives for the forward call."""
    b, h, w = x_shape
    fwd = CONV_FIR if down == 1 else SKIP_UP
    y_hw = h if down == 1 else 2 * h
    f = setup_filter(F1D)
    p = adjoint_padding((b, 3, h + (down == 1), w + (down == 1)) if down == 1 else (b, 3, h, w),
                        (b, 3, y_hw, y_hw), f, **{k: v for k, v in fwd.items() if k != "gain"})
    assert p == case["padding"]
    dy = np.random.default_rng(9).standard_normal((b, y_hw, y_hw, 3)).astype(np.float32)
    plans = check_fir(dy, F1D, **case)
    assert {pl.variant for pl in plans} == {VARIANTS[(4, 1, down)]}
    assert all(pl.ho == (h + 1 if down == 1 else h) for pl in plans)


@pytest.mark.parametrize("case,side", [(D_CONV_FIR, 9), (D_SKIP_FIR, 9),
                                       (D_CONV_FIR_ADJ, 10), (D_SKIP_FIR_ADJ, 8)],
                         ids=["conv1-fir", "skip-fir", "conv1-fir-adjoint", "skip-fir-adjoint"])
def test_fir_plan_walk_discriminator_plans(case, side):
    """The discriminator's FIR calls and their adjoints walked against the
    JAX kernel and oracle on ragged planes; the adjoints' paddings are what
    adjoint_padding gives for the forward calls (the discriminator's conv,
    down 2, through conv2d_resample: FIR pad 2 or 1, then the strided conv)."""
    f = setup_filter(F1D)
    assert adjoint_padding((2, 3, 9, 9), (2, 3, 10, 10), f, padding=2) == (1, 1, 1, 1)
    assert adjoint_padding((2, 3, 9, 9), (2, 3, 8, 8), f, padding=1) == (2, 2, 2, 2)
    x = np.random.default_rng(10).standard_normal((2, side, side, 3)).astype(np.float32)
    plans = check_fir(x, F1D, **case)
    assert {pl.variant for pl in plans} == {VARIANTS[(4, 1, 1)]}


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("shape,kw,side", d_fir_calls(),
                         ids=[f"{s}-pad{kw['padding'][0]}{'-adj' if 'flip_filter' in kw else ''}"
                              for s, kw, _ in d_fir_calls()])
def test_fir_plan_geometry_at_discriminator_shapes(shape, kw, side, dtype):
    """The discriminator's FIRs and their adjoints at every full-width shape
    (batch 16): the compiled (4, 1, 1) instantiation, each output once,
    every read in its window, shared memory within the card's limit."""
    plan = fir_plan(shape, _taps(setup_filter(F1D)), dtype=dtype, **kw)
    assert plan.variant == VARIANTS[(4, 1, 1)] and plan.sliding
    assert plan.smem_bytes <= SMEM_LIMIT
    assert (plan.ho, plan.wo) == (side, side)
    ragged_axis_check(plan, 0, shape[2], plan.ho, kw["padding"][3])
    ragged_axis_check(plan, 1, shape[3], plan.wo, kw["padding"][1])


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("shape,kw", path_adjoint_calls(),
                         ids=[f"{s}-down{kw['down']}" for s, kw in path_adjoint_calls()])
def test_fir_adjoint_plan_geometry_at_path_shapes(shape, kw, dtype):
    """The backward's FIR at every full-width path shape: the compiled
    (4, 1, 1) or (4, 1, 2) instantiation, each output once, every read in
    its window, shared memory within the card's limit."""
    plan = fir_plan(shape, _taps(setup_filter(F1D)), dtype=dtype, **kw)
    assert plan.variant == VARIANTS[(4, 1, kw["down"])] and plan.sliding
    assert plan.smem_bytes <= SMEM_LIMIT
    r = shape[2]
    assert (plan.ho, plan.wo) == ((r + 1, r + 1) if kw["down"] == 1 else (r // 2, r // 2))
    ragged_axis_check(plan, 0, shape[2], plan.ho, kw["padding"][3])
    ragged_axis_check(plan, 1, shape[3], plan.wo, kw["padding"][1])
    blocks = np.arange(plan.blocks)
    tile_x, rest = blocks % plan.tiles_x, blocks // plan.tiles_x
    tile_y, group = rest % plan.tiles_y, rest // plan.tiles_y
    ids = (group * plan.tiles_y + tile_y) * plan.tiles_x + tile_x
    assert np.array_equal(np.sort(ids), blocks)
    assert group.max() == math.ceil(plan.planes / plan.ppb) - 1


# --------------------------------- bias_act ---------------------------------- #


def walk_bias_act(plan, x: torch.Tensor, b, **kw) -> torch.Tensor:
    """Run ``plan`` the way csrc/bias_act.cu does: block -> (row block,
    chunk), thread -> (row, vectors), bias index per element; then the
    kernel's fp32 arithmetic on the gathered bias."""
    flat = x.reshape(-1)
    bias_of = np.full(flat.numel(), -1, np.int64)
    hits = np.zeros(flat.numel(), np.int64)
    nvec = plan.row_len // plan.vec
    tx_, ty_ = np.meshgrid(np.arange(plan.block_x), np.arange(plan.block_y))
    for blk in range(plan.blocks):
        rowblk, chunk = divmod(blk, plan.chunks)
        row = rowblk * plan.block_y + ty_
        for item in range(BIAS_ACT_ITEMS):
            v = chunk * plan.block_x * BIAS_ACT_ITEMS + tx_ + item * plan.block_x
            ok = (row < plan.rows) & (v < nvec)
            for e in range(plan.vec):
                col = v[ok] * plan.vec + e
                idx = row[ok] * plan.row_len + col
                hits[idx] += 1
                bias_of[idx] = row[ok] % plan.channels if plan.bias_mode == 0 else col
    assert (hits == 1).all()
    y = flat.float()
    if b is not None:
        y = y + b.to(x.dtype).float()[torch.from_numpy(bias_of)]
    act, alpha, gain, clamp = kw["act"], kw.get("alpha"), kw["gain"], kw.get("clamp")
    if act == "relu":
        y = torch.where(y > 0, y, torch.zeros_like(y))
    elif act == "lrelu":
        y = torch.where(y >= 0, y, y * (0.2 if alpha is None else alpha))
    y = y * gain
    if clamp is not None:
        y = y.clamp(-clamp, clamp)
    return y.to(x.dtype).reshape(x.shape)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("shape", [(2, 5, 4, 3), (2, 3, 8, 8), (3, 16), (3, 7), (2, 4, 40),
                                   (2, 6, 1, 1)], ids=str)
def test_bias_act_plan_walk_is_bit_equal_to_plain(shape, dtype):
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(shape, generator=gen) * 2).to(dtype)
    b = torch.randn(shape[1], generator=gen)
    for aligned in (True, False):
        plan = bias_act_plan(shape, dtype != torch.float32, aligned)
        for kw in (dict(act="lrelu", gain=math.sqrt(2.0)), dict(act="linear", gain=1.0, clamp=0.5),
                   dict(act="relu", gain=1.5), dict(act="lrelu", alpha=0.05, gain=1.0, clamp=1.0)):
            got = walk_bias_act(plan, x, b, **kw)
            assert torch.equal(got, bias_act_plain(x, b, **kw))
            got = walk_bias_act(plan, x, None, **kw)
            assert torch.equal(got, bias_act_plain(x, None, **kw))


def walk_bias_act_db(plan, g: np.ndarray) -> np.ndarray:
    """db as csrc/bias_act.cu's backward sums it: a partial per (row, chunk)
    of the fp32 dx in mode 0 (the dx itself in mode 1), at the index the
    kernel writes, then per channel over the partials in the order
    bias_act_grad_db_kernel reads them. Asserts every element lands in
    exactly one partial and every partial is read exactly once."""
    rows = g.reshape(plan.rows, plan.row_len).astype(np.float64)
    if plan.bias_mode == 0:
        per = plan.block_x * BIAS_ACT_ITEMS * plan.vec  # elements of a chunk
        n = plan.rows * plan.chunks
        partial, seen = np.zeros(n), np.zeros(plan.row_len, np.int64)
        for k in range(plan.chunks):
            seen[k * per:(k + 1) * per] += 1
        assert (seen == 1).all()
        for r in range(plan.rows):
            for k in range(plan.chunks):
                partial[r * plan.chunks + k] = rows[r, k * per:(k + 1) * per].sum()
        outer, inner = plan.rows // plan.channels, plan.chunks
    else:
        partial, n = rows.reshape(-1), plan.rows * plan.row_len
        outer, inner = plan.rows, 1
    db, read = np.zeros(plan.channels), np.zeros(n, np.int64)
    for c in range(plan.channels):
        for i in range(outer):
            for k in range(inner):
                db[c] += partial[(i * plan.channels + c) * inner + k]
                read[(i * plan.channels + c) * inner + k] += 1
    assert (read == 1).all()
    return db


@pytest.mark.parametrize("is_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 5, 4, 3), (1, 2, 128, 128), (3, 16), (2, 4, 40),
                                   (16, 512), (2, 6, 1, 1)], ids=str)
def test_bias_act_grad_db_walk_sums_each_element_once(shape, is_bf16):
    """The backward's deterministic db (no atomics): partials per (row,
    chunk), several chunks per row included ((1, 2, 128, 128) in fp32), then
    a fixed-order sum per channel; equal to the sum of dx over every dim but
    1 (float64 walk, 1e-12)."""
    g = np.random.default_rng(1).standard_normal(shape)
    plan = bias_act_plan(shape, is_bf16, aligned=True)
    if shape == (1, 2, 128, 128) and not is_bf16:
        assert plan.chunks > 1
    want = g.sum(axis=tuple(d for d in range(g.ndim) if d != 1))
    np.testing.assert_allclose(walk_bias_act_db(plan, g), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("is_bf16", [False, True], ids=["fp32", "bf16"])
def test_bias_act_plan_at_path_shapes(is_bf16):
    """Every path shape takes the 16-byte variant: planes by row with the
    channel once per thread, (B, F) features by column."""
    shapes = path_bias_act_shapes()
    assert len(shapes) == 42
    width = 8 if is_bf16 else 4
    for shape in shapes:
        plan = bias_act_plan(shape, is_bf16, aligned=True)
        assert plan.vec == width, shape
        assert plan.block_x * plan.block_y == BIAS_ACT_THREADS
        assert plan.bias_mode == (1 if len(shape) == 2 else 0), shape
        nvec = plan.row_len // plan.vec
        assert plan.chunks * plan.block_x * BIAS_ACT_ITEMS >= nvec
        assert math.ceil(plan.rows / plan.block_y) * plan.chunks == plan.blocks
        if len(shape) == 4 and shape[2] >= 64:  # large planes: whole blocks per plane chunk
            assert (plan.block_x, plan.block_y) == (256, 1)
        if shape == (8, 512, 4, 4):  # small planes share a block
            assert plan.block_y == BIAS_ACT_THREADS * plan.vec // 16


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_bias_act_alignment_check_refuses_misaligned_view(dtype):
    """A contiguous view one element into its storage is not 16-byte aligned:
    the wrapper's check sends it to the scalar variant; so does a (B, F)
    bias that is a misaligned view."""
    shape = (2, 4, 8, 8)
    base = torch.zeros(math.prod(shape) + 1, dtype=dtype)
    x = base[1:].view(shape)
    y = torch.empty_like(x)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert not vector_aligned(x, None, y)
    assert bias_act_plan(shape, dtype != torch.float32, vector_aligned(x, None, y)).vec == 1
    x0 = base[:-1].view(shape)
    assert vector_aligned(x0, None, y)
    assert bias_act_plan(shape, dtype != torch.float32, True).vec > 1
    feats = torch.zeros(2, 64, dtype=dtype)
    b = torch.zeros(65, dtype=dtype)[1:]
    assert not vector_aligned(feats, b, torch.empty_like(feats))
    assert vector_aligned(x0, b[:4], y)  # a per-plane bias is read as a scalar


# ---------------------- upfirdn2d on H-sharded rows ------------------------- #

# The FIR calls of model parallelism (ops/conv2d_resample.py and upfirdn2d's
# ``sp``): G's up-conv FIR on a rank's rows, its halo of 3 rows included
# (window(6, 2, 1, 3): the transposed conv's output cropped by 3 rows at the
# top and 1 at the bottom, as negative padding), and the skip upsample (one
# halo row each side, the last output row cropped); with their adjoints.
SHARD_CONV_FIR = dict(up=1, down=1, padding=(1, 1, -3, -1), gain=4.0)
SHARD_SKIP_UP = dict(up=2, down=1, padding=(2, 1, 0, -1), gain=4.0)


@pytest.mark.parametrize("case,x_hw,adjoint", [
    (SHARD_CONV_FIR, (2 * (4 + 3) + 1, 9), False), (SHARD_CONV_FIR, (2 * (4 + 3) + 1, 9), True),
    (SHARD_SKIP_UP, (4 + 2, 4), False), (SHARD_SKIP_UP, (4 + 2, 4), True)],
    ids=["conv-fir", "conv-fir-adjoint", "skip-up", "skip-up-adjoint"])
def test_fir_plan_walk_shard_plans(case, x_hw, adjoint):
    """A rank's 4 rows of a sharded plane: the plan of each call (negative
    padding crops) and of its adjoint walked against the JAX oracle; each
    forward gives the rank's 8 output rows."""
    f = setup_filter(F1D)
    h, w = x_hw
    ho, wo = output_size(h, w, 4, case["up"], case["down"], case["padding"])
    assert ho == 8
    if adjoint:
        p = adjoint_padding((2, 3, h, w), (2, 3, ho, wo), f, up=case["up"], down=case["down"],
                            padding=case["padding"])
        case = dict(up=case["down"], down=case["up"], padding=p, gain=case["gain"],
                    flip_filter=True)
        h, w = ho, wo
    x = np.random.default_rng(11).standard_normal((2, h, w, 3)).astype(np.float32)
    plans = check_fir(x, F1D, pallas=False, **case)
    if adjoint:
        assert all(pl.ho == x_hw[0] and pl.wo == x_hw[1] for pl in plans)


# The discriminator's FIRs on a rank's rows (ops/conv2d_resample.py's down
# path): conv1's and the skip's FIR and stride-2 conv read one window, so the
# FIR sees the rank's rows with 2 (conv1) or 1 (skip) halo rows each side and
# pads only along W; conv1's gives rows + 1 rows, the skip's rows - 1. R1's
# second order runs each adjoint's adjoint, the forward's geometry again.
SHARD_D_CONV_FIR = dict(up=1, down=1, padding=(2, 2, 0, 0), gain=1.0)
SHARD_D_SKIP_FIR = dict(up=1, down=1, padding=(1, 1, 0, 0), gain=1.0)


@pytest.mark.parametrize("order", [0, 1, 2], ids=["forward", "adjoint", "adjoint-adjoint"])
@pytest.mark.parametrize("case,x_hw,ho", [(SHARD_D_CONV_FIR, (4 + 4, 9), 4 + 1),
                                          (SHARD_D_SKIP_FIR, (4 + 2, 9), 4 - 1)],
                         ids=["d-conv1-fir", "d-skip-fir"])
def test_fir_plan_walk_discriminator_shard_plans(case, x_hw, ho, order):
    """A rank's 4 rows of a D plane, halo-extended: the FIR's plan, its
    adjoint's and the adjoint's adjoint's (the same padding as the forward,
    as R1's second order calls it) walked against the JAX oracle."""
    f = setup_filter(F1D)
    h, w = x_hw
    calls = [(case, (h, w))]
    for _ in range(order):
        kw, (hi, wi) = calls[-1]
        hj, wj = output_size(hi, wi, 4, kw["up"], kw["down"], kw["padding"])
        p = adjoint_padding((2, 3, hi, wi), (2, 3, hj, wj), f, up=kw["up"], down=kw["down"],
                            padding=kw["padding"])
        calls.append((dict(up=kw["down"], down=kw["up"], padding=p, gain=kw["gain"],
                           flip_filter=not kw.get("flip_filter", False)), (hj, wj)))
    kw, (hi, wi) = calls[-1]
    assert output_size(h, w, 4, 1, 1, case["padding"])[0] == ho
    if order == 2:
        assert kw["padding"] == case["padding"] and not kw["flip_filter"]
    x = np.random.default_rng(12).standard_normal((2, hi, wi, 3)).astype(np.float32)
    plans = check_fir(x, F1D, pallas=False, **kw)
    assert {pl.variant for pl in plans} == {VARIANTS[(4, 1, 1)]}
    assert all((pl.ho, pl.wo) == ((ho, w - 3 + 2 * case["padding"][0]) if order != 1
                                  else (h, w)) for pl in plans)
