"""The port's model parallelism of the GAN trainer (``train/gan.py`` on a 2-D
``(data, model)`` mesh, ``parallel/spatial.py``) against the JAX package's
``make_gan_train_step(mesh=make_mesh_2d(2, 2))`` over forced host devices and
against the port's own one process, on the CPU.

The toy GAN of tests/test_torch_gan.py (16², z 8, w 16, channel_base 256,
channel_max 16, mbstd groups of 2, global batch 4), its JAX variables
perturbed and carried across, runs as four gloo processes
(``tests/torch_dp_worker.py``, one spawn for the module) on a (2, 2) mesh:
each data shard holds 2 images, so every mbstd group spans both data shards,
and each model rank 8 of their 16 rows. Every plane of the geometry is
sharded: G's 4², 8² and 16² (the 4² const scattered), D's blocks b16 and b8
(fromrgb, conv0, and conv1 and skip down 2 on their rows) and the 4²
epilogue, gathered whole for ``fc``.

Two steps from JAX's keys (``port_draws``, style mixing on): step 0 with R1
and the path length, step 1 with neither; ADA at p = 0.8, so that the warp
(with a final rot90) and the colour stage run on every pass. The noise
strengths and the noise are zero in both packages (the port's constant
noise buffers zeroed, JAX's synthesis draws replaced by zeros), so that
neither the forward nor a noise strength's gradient depends on a stream the
two packages draw differently.

Checks: the step-0 metrics within rtol 1e-3 and the step-1 metrics within
5e-2 of JAX's 2-D step, the parameters after step 1 within 5 lr (JAX's own
bounds for its 2-D step against one device, tests/test_gan_training.py);
each network's gradient at both steps within 1e-4 of its norm of the
one-process port step's; every rank's parameters bit-equal; and a planted
fault, the path-length gradient left un-reduced over the model group, moves
the step-0 metrics by more than 1e-2."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from test_torch_gan import B, IMG, jax_nets, torch_nets
from test_torch_gan_step import port_draws
from torch_dp_worker import Ranks, run_mp_gan_steps
from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from viscoin_tpu.parallel.mesh import make_mesh_2d, replicate, shard_batch
from viscoin_tpu.train import gan as jgan
from viscoin_tpu_torch.train import augment as TA
from viscoin_tpu_torch.utils.weights import tree_to_state_dict

MP_CFG = dict(batch_size=B, augment_p=0.8, style_mixing_prob=1.0)
MESH = (2, 2)
STEP0_RTOL, STEP1_RTOL = 1e-3, 5e-2  # tests/test_gan_training.py's, its 2-D mesh vs one device
GRAD_TOL = 1e-4  # each network's gradient, ||2-D - one process|| / ||one process||
FAULT_MIN = 1e-2


def _zero_noise_strength(tree):
    return jax.tree_util.tree_map_with_path(
        lambda p, x: np.zeros_like(x) if getattr(p[-1], "key", None) == "noise_strength" else x,
        tree)


def _zero_synthesis_noise(mp: pytest.MonkeyPatch) -> None:
    """JAX's synthesis noise draws (the only (B, res, res, 1) normals) give zeros."""
    real = jax.random.normal

    def normal(key, shape=(), dtype=jnp.float32):
        if len(shape) == 4 and shape[-1] == 1:
            return jnp.zeros(shape, dtype)
        return real(key, shape, dtype)

    mp.setattr(jax.random, "normal", normal)


def _worker_inputs(gv, dv, draws, images) -> dict:
    g, d = torch_nets(gv, dv)
    with torch.no_grad():
        for name, buf in g.named_buffers():
            if name.endswith("noise_const"):
                buf.zero_()
    step = dict(fn="mp_gan_steps", mesh2d=MESH, g=g, d=d, cfg=MP_CFG, draws=draws,
                images=torch.from_numpy(images))
    return {"step": step, "fault_ppl": dict(step, draws=draws[:1], images=step["images"][:1],
                                            kw=dict(fault="ppl"))}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The port's draws from JAX's keys, the four worker processes started on
    them, and while they run the port's one process and JAX's 2-D mesh step
    (compiled once, run at steps 0 and 1). Returns (JAX's results, the one
    process's outputs, each rank's outputs, the inputs)."""
    jg, jd, gv, dv = jax_nets()
    gv = dict(gv, params=_zero_noise_strength(gv["params"]))
    images = np.random.default_rng(50).integers(0, 256, (2, B, IMG, IMG, 3), dtype=np.uint8)
    rngs = [jax.random.PRNGKey(60 + i) for i in range(2)]
    draws = [port_draws(k, (B, IMG, IMG, 3), MP_CFG["style_mixing_prob"]) for k in rngs]
    inputs = _worker_inputs(gv, dv, draws, images)
    workers = Ranks(tmp_path_factory.mktemp("mp_gan"), inputs, world=4)

    one = run_mp_gan_steps(copy.deepcopy(inputs["step"]), None)

    jcfg = jgan.GANTrainingParams(**MP_CFG)
    g_tx, d_tx = jgan._optimizers(jcfg)
    mesh = make_mesh_2d(*MESH)
    state = replicate(mesh, jgan.GANTrainState(
        step=jnp.zeros((), jnp.int32), g_params=gv["params"], d_params=dv["params"],
        g_opt_state=g_tx.init(gv["params"]), d_opt_state=d_tx.init(dv["params"]),
        g_ema_params=jax.tree_util.tree_map(jnp.copy, gv["params"]),
        w_avg=jnp.zeros((jg.w_dim,), jnp.float32), pl_mean=jnp.zeros((), jnp.float32),
        ada_p=jnp.asarray(jcfg.augment_p, jnp.float32), ada_rt=jnp.zeros((), jnp.float32)))
    extras = replicate(mesh, {k: v for k, v in gv.items() if k != "params"})
    placed = [shard_batch(mesh, im, specs=(P("data", "model", None, None),)) for im in images]
    mp = pytest.MonkeyPatch()
    _zero_synthesis_noise(mp)
    try:
        step = jgan.make_gan_train_step(jg, jd, jcfg, mesh=mesh)
        compiled = step.lower(state, extras, placed[0], rngs[0]).compile(
            {"xla_backend_optimization_level": 0})
    finally:
        mp.undo()
    metrics = []
    for im, key in zip(placed, rngs):
        state, m = compiled(state, extras, im, key)
        metrics.append({k: float(v) for k, v in m.items()})
    ref = {"metrics": metrics,
           "g": tree_to_state_dict({"params": jax.device_get(state.g_params)}),
           "d": tree_to_state_dict({"params": jax.device_get(state.d_params)}),
           "lr": jcfg.learning_rate}
    return ref, one, workers.join(timeout=240), inputs


def test_draws_run_the_warp_rot90_and_colour_stage(setup):
    """Every augmentation pass of both steps warps some image, a final rot90
    among them, and recolours some image (the pipe's gather, scatter and
    per-row colour products all run); style mixing cuts every step."""
    *_, inputs = setup
    num_ws = 2 * int(np.log2(IMG)) - 2
    for draws in inputs["step"]["draws"]:
        assert draws.cutoff < num_ws and draws.cutoff2 < num_ws
        for aug in (draws.aug_g, draws.aug_df, draws.aug_dr):
            _, _, use_k1, skip = TA._spatial(aug, MP_CFG["augment_p"], IMG, IMG)
            assert not bool(skip.all()) and bool(use_k1.any())
            assert not bool((TA._color(aug, MP_CFG["augment_p"]) == torch.eye(4)).all())


def test_gan_step_matches_the_jax_2d_mesh(setup):
    """Four ranks, (2, 2), against JAX's step on its 2-D mesh from the same
    state and draws: step 0 (R1 and the path length) within rtol 1e-3,
    step 1 within 5e-2 (it sees step 0's update), every G and D parameter
    after step 1 within 5 lr; the regularisers live at step 0 only."""
    ref, _, ranks, _ = setup
    assert ref["metrics"][0]["r1"] > 0 and ref["metrics"][0]["pl_lengths"] > 0
    assert ref["metrics"][1]["r1"] == 0 and ref["metrics"][1]["pl_lengths"] == 0
    for r, out in enumerate(ranks):
        got = out["step"]
        for j, rtol in enumerate((STEP0_RTOL, STEP1_RTOL)):
            assert set(got["metrics"][j]) == set(ref["metrics"][j])
            for k, v in ref["metrics"][j].items():
                np.testing.assert_allclose(got["metrics"][j][k], v, rtol=rtol, atol=1e-6,
                                           err_msg=f"rank {r} step {j} {k}")
        for part in ("g", "d"):
            for name, want in ref[part].items():
                np.testing.assert_allclose(got[part][name].numpy(), want,
                                           atol=5 * ref["lr"], err_msg=f"rank {r} {part}.{name}")


def _grad_deviation(got: dict, want: dict) -> dict[str, float]:
    """||got - want|| / ||want|| of G's and D's gradients."""
    out = {}
    for who in "GD":
        keys = [k for k in want if k.startswith(who + ".")]
        diff = sum(float((got[k].double() - want[k].double()).square().sum()) for k in keys)
        norm = sum(float(want[k].double().square().sum()) for k in keys)
        out[who] = (diff / norm) ** 0.5
    return out


def test_gan_step_gradients_match_one_process(setup):
    """Each network's gradient (averaged over the four ranks) at both steps
    within 1e-4 of its norm of the one process's on the global batch; the
    metrics within 1e-5; every rank's parameters bit-equal; the spatial
    collectives ran (halo exchanges, the warp's and the epilogue's gathers,
    the model-group sums of mbstd, R1 and the path length)."""
    _, one, ranks, _ = setup
    for r, out in enumerate(ranks):
        got = out["step"]
        for j in range(2):
            dev = _grad_deviation(got["grads"][j], one["grads"][j])
            assert max(dev.values()) <= GRAD_TOL, (r, j, dev)
            for k, v in one["metrics"][j].items():
                np.testing.assert_allclose(got["metrics"][j][k], v, rtol=1e-5, atol=1e-7,
                                           err_msg=f"rank {r} step {j} {k}")
        for part in ("g", "d"):
            for name, t in got[part].items():
                assert torch.equal(t, ranks[0]["step"][part][name]), (r, part, name)
        c = got["counts"][0]
        assert c["halo"] > 0 and c["gather"] >= 6 and c["sum"] > 0 and c["scatter"] > 0, c


def test_planted_fault_moves_the_metrics(setup):
    """The path-length gradient left un-reduced over the model group (each
    rank keeps its rows' part): step 0's metrics move by more than 1e-2 from
    the one process's on every rank."""
    _, one, ranks, _ = setup
    for r, out in enumerate(ranks):
        got, want = out["fault_ppl"]["metrics"][0], one["metrics"][0]
        worst = max(abs(got[k] - v) / max(abs(v), 1e-6) for k, v in want.items())
        assert worst > FAULT_MIN, (r, worst)
