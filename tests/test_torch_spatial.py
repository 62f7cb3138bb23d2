"""The port's spatial sharding (``viscoin_tpu_torch/parallel/spatial.py``) on
the CPU: four gloo processes (``tests/torch_dp_worker.py``, one spawn for the
module) as a (1, 4) and a (2, 2) mesh, each rank on its rows of the same
float64 tensors, against the unsharded ops in this process:

  * the halo exchange against a slice of the padded tensor (zero and -inf
    fills), its adjoint (<y, A x> = <A^T y, x> summed over the ranks) and a
    second-order gradient through it;
  * scatter_rows / gather_rows and their backwards;
  * the sharded convs (3x3/1, 7x7/2, 5x5/4, 1x1/2, 3x3/2, 1x1/1), the max
    pools, StyleGAN's up-conv, the discriminator's down-2 convs (a 4-tap FIR
    then a stride-2 3x3 or 1x1, one window) and the FIR at several paddings
    (up 2, up 1, down 2), forward and the gradients of a weighted sum of the
    output (the input's rows; the weights' summed over the ranks); the down
    convs also to second order;
  * gather_rows, scatter_rows and model_sum differentiated twice;
  * the minibatch stddev over the data axis's batch with its mean over the
    model group, the ADA pipe on rows (bit-equal), and the toy
    discriminator on rows, with its natural plan and with its 8² and 4²
    planes whole (b16's output gathered);
  * the shard plans at 256² (model 2 and 4) and at the toy 32² geometry,
    and the discriminator's planes where they stop.

Float64 where the ops allow it: the sharded ops add the same products in the
same order as the whole ones up to the model-group sums, so the tolerance is
1e-10 relative to each output's scale. The minibatch stddev takes its
statistics in fp32 (so does the discriminator's), and the ADA pipe runs in
fp32: their tolerances are stated at their tests."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_dp_worker import run_ranks
from viscoin_tpu_torch.models.bundle import init_models
from viscoin_tpu_torch.models.stylegan import Discriminator, MinibatchStdLayer
from viscoin_tpu_torch.ops import conv2d_resample, setup_filter, upfirdn2d
from viscoin_tpu_torch.parallel import spatial as S
from viscoin_tpu_torch.train import augment as TA

H, W = 16, 8
MESHES = {"spatial_1x4": (1, 4), "spatial_2x2": (2, 2)}
HALOS = [(1, 1, 0.0), (2, 1, 0.0), (3, 2, 0.0), (0, 2, 0.0), (1, 0, float("-inf"))]
ADJOINT_HALO = (2, 3)
FIR = setup_filter([1, 3, 3, 1])
TOL = 1e-10
ADA_P, ADA_SEED = 0.9, 1  # draws in which one image takes the final rot90 and one does not
MBSTD_TOL = 1e-6  # fp32 statistics, the model group's partial sums
DISC_TOL = 1e-5


def _disc() -> Discriminator:
    """The toy discriminator (16², channel_base 256, channel_max 16, mbstd
    groups of 2) in float64, its weights perturbed."""
    d = init_models(Discriminator(img_resolution=H, channel_base=256, channel_max=16,
                                  mbstd_group_size=2, device="cpu"), 5).double()
    g = _g(6)
    with torch.no_grad():
        for p in d.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g, dtype=p.dtype))
    return d


def _g(seed: int):
    return torch.Generator().manual_seed(seed)


def _ops() -> dict:
    """name -> (the op on whole tensors, its case for the workers)."""
    g = _g(3)
    cases = {}
    for k, stride, pad in ((3, 1, 1), (7, 2, 3), (5, 4, 2), (1, 2, 0), (3, 2, 1), (1, 1, 0)):
        cases[f"conv{k}x{k}/{stride}"] = dict(kind="conv", stride=stride, padding=pad,
                                             w=torch.randn(4, 3, k, k, generator=g,
                                                           dtype=torch.float64))
    for k, stride, pad in ((3, 2, 1), (2, 2, 0)):
        cases[f"maxpool{k}/{stride}"] = dict(kind="maxpool", k=k, stride=stride, padding=pad)
    cases["upconv"] = dict(kind="upconv", f=FIR, padding=1,
                           w=torch.randn(4, 3, 3, 3, generator=g, dtype=torch.float64))
    for k in (3, 1):  # the discriminator's conv1 and skip
        cases[f"downconv{k}x{k}"] = dict(kind="downconv", f=FIR, padding=k // 2,
                                         w=torch.randn(4, 3, k, k, generator=g,
                                                       dtype=torch.float64))
    for name, up, down, pads, gain in (("up2 (2,1)", 2, 1, (2, 1), 4.0),
                                       ("up1 (1,2)", 1, 1, (1, 2), 1.0),
                                       ("up1 (2,1)", 1, 1, (2, 1), 1.0),
                                       ("up1 (0,3)", 1, 1, (0, 3), 1.0),
                                       ("down2 (1,1)", 1, 2, (1, 1), 1.0),
                                       ("down2 (2,0)", 1, 2, (2, 0), 1.0)):
        cases[f"fir {name}"] = dict(kind="fir", f=FIR, up=up, down=down, gain=gain,
                                    fir_padding=(pads[0], pads[1], pads[0], pads[1]))
    return cases


def _whole(case: dict, x: torch.Tensor, w: torch.Tensor | None) -> torch.Tensor:
    kind = case["kind"]
    if kind == "conv":
        return F.conv2d(x, w, stride=case["stride"], padding=case["padding"])
    if kind == "maxpool":
        return F.max_pool2d(x, case["k"], stride=case["stride"], padding=case["padding"])
    if kind == "upconv":
        return conv2d_resample(x, w, f=case["f"], up=2, padding=case["padding"],
                               flip_weight=False)
    if kind == "downconv":
        return conv2d_resample(x, w, f=case["f"], down=2, padding=case["padding"])
    return upfirdn2d(x, case["f"], up=case["up"], down=case["down"],
                     padding=case["fir_padding"], gain=case["gain"])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    g = _g(0)
    x = torch.randn(2, 3, H, W, generator=g, dtype=torch.float64)
    ops = _ops()
    for case in ops.values():
        w = case.get("w")
        with torch.no_grad():
            shape = _whole(case, x, w).shape
        case["u"] = torch.randn(shape, generator=g, dtype=torch.float64)
    base = dict(x=x, halos=HALOS, adjoint_halo=ADJOINT_HALO, ops=ops,
                v=torch.randn(2, 3, H, W, generator=g, dtype=torch.float64),
                u=torch.randn(4, 2, 3, H, W, generator=g, dtype=torch.float64),
                mbstd_x=torch.randn(8, 6, H, 4, generator=g, dtype=torch.float64),
                mbstd_w=torch.randn(8, 7, H, 4, generator=g, dtype=torch.float64),
                ada_x=torch.rand(2, 3, H, H, generator=g) * 2 - 1,
                ada_u=torch.randn(2, 3, H, H, generator=g), ada_p=ADA_P,
                ada_draws=TA.draw_augment(2, _g(ADA_SEED)), disc=_disc(),
                disc_x=torch.rand(4, 3, H, H, generator=g, dtype=torch.float64) * 2 - 1)
    inputs = {}
    for name, mesh in MESHES.items():  # y, w: per rank, of its extended rows
        ext = H // mesh[1] + sum(ADJOINT_HALO)
        inputs[name] = dict(base, fn="spatial_ops", mesh2d=mesh,
                            y=torch.randn(4, 2, 3, ext, W, generator=g, dtype=torch.float64),
                            w=torch.randn(4, 2, 3, ext, W, generator=g, dtype=torch.float64))
    outs = run_ranks(tmp_path_factory.mktemp("spatial"), inputs, world=4, timeout=240)
    return inputs, outs


def _model_ranks(mesh):
    """(global rank, model rank) of every rank of the mesh."""
    data, model = mesh
    return [(r, r % model) for r in range(data * model)]


def _close(got, want, what):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max()) / scale
    assert err <= TOL, (what, err)


@pytest.mark.parametrize("name", MESHES)
def test_halo_exchange_is_a_slice_of_the_padded_plane(ranks, name):
    inputs, outs = ranks
    base = inputs[name]
    model = MESHES[name][1]
    h = H // model
    for r, m in _model_ranks(MESHES[name]):
        for top, bottom, fill in HALOS:
            padded = F.pad(base["x"], (0, 0, top, bottom), value=fill)
            want = padded[:, :, m * h: m * h + h + top + bottom]
            got = outs[r][name]["halo"][(top, bottom, fill)]
            assert torch.equal(got, want), (name, r, top, bottom, fill)


@pytest.mark.parametrize("name", MESHES)
def test_halo_adjoint_and_second_order(ranks, name):
    """<y, A x> = <A^T y, x> over a model group; the gradient of
    sum_r sum(w_r * A_r(x)^3) and of its gradient's weighted squared norm
    against the same loss on the whole tensor (A_r: rank r's padded rows)."""
    inputs, outs = ranks
    base = inputs[name]
    data, model = MESHES[name]
    h, (top, bottom) = H // model, ADJOINT_HALO
    for d in range(data):
        group = range(d * model, (d + 1) * model)
        lhs = sum(outs[r][name]["inner"][0] for r in group)
        rhs = sum(outs[r][name]["inner"][1] for r in group)
        assert abs(lhs - rhs) <= TOL * max(abs(lhs), 1.0), (name, lhs, rhs)
    x = base["x"].clone().requires_grad_(True)
    padded = F.pad(x, (0, 0, top, bottom))
    loss = sum((base["w"][m] * padded[:, :, m * h: m * h + h + top + bottom] ** 3).sum()
               for m in range(model))
    (g,) = torch.autograd.grad(loss, x, create_graph=True)
    (hh,) = torch.autograd.grad((g ** 2 * base["v"]).sum(), x)
    for r, m in _model_ranks(MESHES[name]):
        rows = slice(m * h, (m + 1) * h)
        _close(outs[r][name]["g"], g.detach()[:, :, rows], (name, r, "grad"))
        _close(outs[r][name]["h"], hh[:, :, rows], (name, r, "second order"))


@pytest.mark.parametrize("name", MESHES)
def test_scatter_and_gather_rows(ranks, name):
    """gather_rows: the whole plane on every rank; its backward sums the
    group's gradients and keeps the rank's rows. scatter_rows: the rank's
    rows; its backward is the gradient in those rows, zero elsewhere."""
    inputs, outs = ranks
    base = inputs[name]
    data, model = MESHES[name]
    h = H // model
    for r, m in _model_ranks(MESHES[name]):
        rows = slice(m * h, (m + 1) * h)
        group = range((r // model) * model, (r // model + 1) * model)
        out = outs[r][name]
        assert torch.equal(out["gathered"], base["x"])
        want = sum(base["u"][q] for q in group)[:, :, rows]
        _close(out["gather_grad"], want, (name, r, "gather backward"))
        assert torch.equal(out["scattered"], base["x"][:, :, rows])
        want = torch.zeros_like(base["x"])
        want[:, :, rows] = base["v"][:, :, rows]
        assert torch.equal(out["scatter_grad"], want)


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("op", list(_ops()))
def test_sharded_ops_match_the_whole_op(ranks, name, op):
    inputs, outs = ranks
    base = inputs[name]
    data, model = MESHES[name]
    case = base["ops"][op]
    x = base["x"].clone().requires_grad_(True)
    w = case.get("w")
    w = None if w is None else w.clone().requires_grad_(True)
    y = _whole(case, x, w)
    grads = torch.autograd.grad((y * case["u"]).sum(), [t for t in (x, w) if t is not None])
    h, ho = H // model, y.shape[2] // model
    gw = 0
    for r, m in _model_ranks(MESHES[name]):
        got = outs[r][name]["ops"][op]
        _close(got["y"], y.detach()[:, :, m * ho: (m + 1) * ho], (name, op, r, "forward"))
        _close(got["gx"], grads[0][:, :, m * h: (m + 1) * h], (name, op, r, "input grad"))
        if w is not None and r < model:
            gw = gw + got["gw"]
    if w is not None:
        _close(gw, grads[1], (name, op, "weight grad summed over the group"))


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("op", ["downconv3x3", "downconv1x1"])
def test_sharded_down_convs_second_order(ranks, name, op):
    """The discriminator's down-2 convs on rows, to second order: the
    gradient g of <u, y^2> with respect to the input, then the gradients of
    <v, g^2> with respect to the input (the rank's rows) and the weight
    (summed over the group), against the whole op's."""
    inputs, outs = ranks
    base = inputs[name]
    data, model = MESHES[name]
    case = base["ops"][op]
    x = base["x"].clone().requires_grad_(True)
    w = case["w"].clone().requires_grad_(True)
    y = _whole(case, x, w)
    (g,) = torch.autograd.grad((y ** 2 * case["u"]).sum(), x, create_graph=True)
    hx, hw = torch.autograd.grad((g ** 2 * base["v"]).sum(), [x, w])
    h = H // model
    gw = 0
    for r, m in _model_ranks(MESHES[name]):
        got_x, got_w = outs[r][name]["ops"][op]["second"]
        _close(got_x, hx[:, :, m * h: (m + 1) * h], (name, op, r, "second order, input"))
        if r < model:
            gw = gw + got_w
    _close(gw, hw, (name, op, "second order, weight summed over the group"))


@pytest.mark.parametrize("name", MESHES)
def test_collectives_differentiate_twice(ranks, name):
    """Through gather_rows, scatter_rows and model_sum a rank's loss is the
    whole one; its gradient is ``model`` times its rows of the whole
    gradient (the gradient rule), and the gradient of <v, g^2> ``model``²
    times the whole one's."""
    inputs, outs = ranks
    base = inputs[name]
    data, model = MESHES[name]
    x = base["x"].clone().requires_grad_(True)
    loss = (((x ** 3) * base["u"][0]).sum(dim=(2, 3)) ** 2).sum()
    (g,) = torch.autograd.grad(loss, x, create_graph=True)
    (hh,) = torch.autograd.grad((g ** 2 * base["v"]).sum(), x)
    h = H // model
    for r, m in _model_ranks(MESHES[name]):
        got = outs[r][name]["double"]
        rows = slice(m * h, (m + 1) * h)
        _close(got["loss"], loss.detach(), (name, r, "loss"))
        _close(got["g"] / model, g.detach()[:, :, rows], (name, r, "first order"))
        _close(got["h"] / model ** 2, hh[:, :, rows], (name, r, "second order"))


def _data_rows(t: torch.Tensor, r: int, mesh) -> torch.Tensor:
    data, model = mesh
    n = t.shape[0] // data
    return t[(r // model) * n: (r // model + 1) * n]


@pytest.mark.parametrize("name", MESHES)
def test_minibatch_std_on_a_2d_mesh(ranks, name):
    """Groups of 4 over the global batch of 8 (on (2, 2) each group spans
    both data shards), the mean over (C, H, W) summed over the model group:
    each rank's samples and rows of the whole layer's output and of the
    input's gradient, each image counted once (fp32 statistics: 1e-6)."""
    inputs, outs = ranks
    base = inputs[name]
    data, model = MESHES[name]
    x = base["mbstd_x"].clone().requires_grad_(True)
    y = MinibatchStdLayer(group_size=4)(x)
    (g,) = torch.autograd.grad((y ** 2 * base["mbstd_w"]).sum(), x)
    h = H // model
    for r, m in _model_ranks(MESHES[name]):
        got = outs[r][name]["mbstd"]
        rows = slice(m * h, (m + 1) * h)
        for what, want in (("y", y.detach()), ("g", g)):
            want = _data_rows(want, r, MESHES[name])[:, :, rows]
            err = float((got[what] - want).abs().max() / want.abs().max())
            assert err <= MBSTD_TOL, (name, r, what, err)


@pytest.mark.parametrize("name", MESHES)
def test_ada_pipe_on_rows_is_the_whole_pipe(ranks, name):
    """The ADA pipe at p = 0.9 (one image warped with the final rot90, one
    without, both recoloured) on each rank's rows: bit-equal to the rows of
    the whole pipe's output; the input's gradient of a weighted sum within
    1e-6 of its scale."""
    inputs, outs = ranks
    base = inputs[name]
    data, model = MESHES[name]
    _, _, use_k1, skip = TA._spatial(base["ada_draws"], ADA_P, H, H)
    assert use_k1.tolist() == [True, False] and not bool(skip.any())
    x = base["ada_x"].clone().requires_grad_(True)
    y = TA.augment(x, ADA_P, base["ada_draws"])
    (g,) = torch.autograd.grad((y * base["ada_u"]).sum(), x)
    h = H // model
    for r, m in _model_ranks(MESHES[name]):
        got = outs[r][name]["ada"]
        rows = slice(m * h, (m + 1) * h)
        assert torch.equal(got["y"], y.detach()[:, :, rows]), (name, r)
        err = float((got["g"] - g[:, :, rows]).abs().max() / g.abs().max())
        assert err <= 1e-6, (name, r, err)


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("plan", ["plan", "gathered"])
def test_discriminator_on_rows(ranks, name, plan):
    """The toy discriminator on each rank's samples and rows (its plan, and
    the plan with its 8² and 4² planes whole): every rank of a model group
    holds its samples' whole logits, and its input gradient of their sum is
    ``model`` times its rows of the whole one (R1's rule); within 1e-5 of
    the scale (its minibatch stddev is fp32)."""
    inputs, outs = ranks
    base = inputs[name]
    data, model = MESHES[name]
    x = base["disc_x"].clone().requires_grad_(True)
    logits = base["disc"](x)
    (g,) = torch.autograd.grad(logits.sum(), x)
    h = H // model
    for r, m in _model_ranks(MESHES[name]):
        got = outs[r][name]["disc"][plan]
        want = _data_rows(logits.detach(), r, MESHES[name])
        err = float((got["logits"] - want).abs().max() / want.abs().max())
        assert err <= DISC_TOL, (name, plan, r, "logits", err)
        want = _data_rows(g, r, MESHES[name])[:, :, m * h: (m + 1) * h]
        err = float((got["g"] / model - want).abs().max() / want.abs().max())
        assert err <= DISC_TOL, (name, plan, r, "input gradient", err)


def test_counts_tally_the_exchanges(ranks):
    """Every rank counted its halo exchanges (forward and adjoint), the
    gather and its backward sum, the scatter; bytes are those reduced."""
    _, outs = ranks
    for out in outs:
        c = out["spatial_1x4"]["counts"]
        assert c["halo"] > len(HALOS) and c["halo_bytes"] > 0, c
        assert c["gather"] == 1 and c["scatter"] == 1 and c["sum"] >= 1, c


def test_window():
    """The halo and the local padding of a rank for the ops of the plan."""
    assert S.window(3, 1, 1, 1) == (1, 1, 0, 0)
    assert S.window(7, 1, 2, 3) == (3, 2, 0, 0)
    assert S.window(5, 1, 4, 2) == (2, 0, 0, -1)
    assert S.window(1, 1, 2, 0) == (0, 0, 0, -1)
    assert S.window(6, 2, 1, 3) == (2, 1, -1, 0)  # G's up-conv (3x3 + 4-tap FIR)
    assert S.window(4, 2, 1, 2) == (1, 1, 0, -1)  # the skip upsample
    assert S.window(2, 1, 2, 0) == (0, 0, 0, 0)


FLAGSHIP_2 = dict.fromkeys(
    ["image", "f.stem", "f.pool", "f.stage0", "f.stage1", "f.stage2", "f.stage3",
     "psi.latent", "g.4", "g.8", "g.16", "g.32", "g.64", "g.128", "g.256",
     "lpips.0", "lpips.1", "lpips.2", "lpips.3", "lpips.4", "d.256", "d.128", "d.64", "d.32",
     "d.16", "d.8", "d.4"], True)
TOY_2 = dict(FLAGSHIP_2, **{"f.stage1": False, "f.stage2": False, "f.stage3": False,
                            "psi.latent": False})
for _res in (64, 128, 256):
    del TOY_2[f"g.{_res}"], TOY_2[f"d.{_res}"]


@pytest.mark.parametrize("size, model, depths, want", [
    # 256², model 2: every plane from G's 4² const up, and f's 8² stage4.
    (256, 2, (3, 4, 6, 3), FLAGSHIP_2),
    # model 4: G's 4² holds 1 row against the up-conv's halo of 2.
    (256, 4, (3, 4, 6, 3), dict(FLAGSHIP_2, **{"g.4": False})),
    # 32² (tests/test_spatial_sharding.py's toy): f's 4² stage2 has 2 rows,
    # which Psi's 5x5/4 conv1 cannot stride over; the smaller planes follow.
    (32, 2, (1, 1, 1, 1), TOY_2),
    (32, 4, (1, 1, 1, 1), dict(TOY_2, **{"g.4": False, "lpips.3": False, "lpips.4": False})),
])
def test_shard_plans(size, model, depths, want):
    assert S.shard_plan(size, model, resnet_depths=depths) == want


def test_discriminator_planes():
    """D's planes shrink like f's: 32² over 8 ranks shards its 32² and 16²
    planes (4 and 2 rows: conv1's window reads 2 halo rows each side) and
    gathers b16's output (8² of 1 row each); 4 ranks hold 1 row of the 4²
    epilogue (its 3x3 reads 1 each side). ``gan_spatial`` refuses images
    that D or G cannot shard."""
    plan = S.shard_plan(32, 8, resnet_depths=(1, 1, 1, 1))
    assert [plan[f"d.{r}"] for r in (32, 16, 8, 4)] == [True, True, False, False]
    assert S.shard_plan(16, 4, resnet_depths=(1, 1, 1, 1))["d.4"]
    from viscoin_tpu_torch.parallel.mesh import Mesh2D

    mesh = Mesh2D(rank=0, world=8, device=torch.device("cpu"), data=1, model=8)
    with pytest.raises(ValueError, match="cannot be H-sharded over 8"):
        S.gan_spatial(mesh, 8)
    sp = S.gan_spatial(Mesh2D(rank=0, world=2, device=torch.device("cpu"), data=1, model=2), 16)
    assert sp.model == 2 and all(sp.plan[f"d.{r}"] for r in (16, 8, 4))
    assert S.gan_spatial(None, 16) is None


def test_unshardable_geometries_are_refused():
    """Images of too few rows per rank are refused, not gathered."""
    from viscoin_tpu_torch.parallel.mesh import Mesh, Mesh2D

    mesh = Mesh2D(rank=0, world=8, device=torch.device("cpu"), data=1, model=8)
    assert isinstance(mesh.model_axis, Mesh) and mesh.model_axis.world == 8
    with pytest.raises(ValueError, match="cannot be H-sharded over 8"):
        S.spatial_for(mesh, 16)
    assert S.spatial_for(None, 16) is None
    assert S.spatial_for(Mesh(rank=0, world=2, device=torch.device("cpu")), 16) is None
    assert not S.qualifies(12, 8, [])
    assert np.all([S.qualifies(16, 4, [(3, 1, 1, 1)]), not S.qualifies(8, 8, [(3, 1, 2, 1)])])
