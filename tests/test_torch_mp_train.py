"""The port's model parallelism (a 2-D ``(data, model)`` mesh,
``viscoin_tpu_torch/parallel/spatial.py``) against the JAX package's 2-D
mesh over forced host devices, on the CPU, at the toy geometry of
tests/test_spatial_sharding.py (32², 8 concepts, the ResNet of depths
(1, 1, 1, 1) and widths (8, 16, 32, 64), G at channel_base 256 and
channel_max 16) with perturbed weights. The port runs as four gloo
processes (``tests/torch_dp_worker.py``, one spawn for the module):

  * the reconstruction (``GeneratorAdapted``, constant noise, noise
    strengths perturbed) on a (2, 2) and a (1, 4) mesh against
    ``jax.jit(..., out_shardings=image_sharding(mesh))``: each rank's rows;
  * the full VisCoIN step on a (2, 2) mesh, global batch 2 real + 2
    synthetic, against ``make_jitted_train_step(mesh=make_mesh_2d(2, 2),
    external_fakes=True)``: the synthetic batch given, the noise strengths
    zero (the step draws its noise at random), JAX's dropout mask replayed;
  * ``test_viscoin`` with FID (the tiny detector of tests/test_eval.py) on a
    (2, 2) mesh against JAX's 2-D eval, and the faithfulness probe against
    one process;
  * the step with every remat target against the step without;
  * two planted faults, the halo exchange replaced by zeros and the
    gradients averaged over the data axis only, each of which fails the
    step's check.

Tolerances (fp32) are stated at each check."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from torch_dp_worker import Ranks
from torch_port_helpers import IMG, NC, NK, bundle_pair, images, nchw, run_once
from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from viscoin_tpu.data.datasets import SyntheticDataset as JSynthetic
from viscoin_tpu.data.loader import DataLoader as JLoader
from viscoin_tpu.eval import viscoin as JE
from viscoin_tpu.models.lpips import LPIPS
from viscoin_tpu.parallel.mesh import image_sharding, image_spec, make_mesh_2d, replicate
from viscoin_tpu.parallel.mesh import shard_batch
from viscoin_tpu.train.viscoin import VisCoINTrainingParams as JParams
from viscoin_tpu.train.viscoin import create_train_state as jax_create_train_state
from viscoin_tpu.train.viscoin import make_frozen as jax_make_frozen
from viscoin_tpu.train.viscoin import make_jitted_train_step
from viscoin_tpu_torch.eval import viscoin as TE
from viscoin_tpu_torch.models.lpips import LPIPS as TLPIPS
from viscoin_tpu_torch.utils.weights import load_jax_tree, tree_to_state_dict

B = 2  # real images per step (as many synthetic ones): one of each per data shard
LR = 1e-4
NETWORKS = ("concept_extractor", "explainer", "mapping")
STEP_RTOL = 1e-4  # total_loss and every term, port 2-D against JAX 2-D
GRAD_TOL = 1e-4  # each network's gradient: ||difference|| / ||JAX's||
N_EVAL, EVAL_BATCH = 10, 4


def _zero_noise_strength(tree):
    return jax.tree_util.tree_map_with_path(
        lambda p, x: np.zeros_like(x) if getattr(p[-1], "key", None) == "noise_strength" else x,
        tree)


def _adam_mu(opt_state) -> dict:
    return next(s.mu for s in opt_state if hasattr(s, "mu"))


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _worker_inputs(ref: dict) -> dict:
    """Every scenario of the four worker processes: the port's bundle (its
    noise strengths zeroed for the step), LPIPS, the inputs of ``ref``."""
    tm = ref["tm"]
    lpips = load_jax_tree(TLPIPS(device="cpu"), {"params": ref["lparams"]}).eval()
    ts = copy.deepcopy(tm)
    with torch.no_grad():
        for name, p in ts.gan.named_parameters():
            if name.endswith("noise_strength"):
                p.zero_()
    step = dict(fn="mp_step", mesh2d=(2, 2), models=ts, lpips=lpips,
                cfg=dict(batch_size=B, cd_fid_iteration=-1),
                real=nchw(ref["real"]), fake=nchw(ref["fake"]),
                labels=torch.from_numpy(ref["labels"]).long(), mask=nchw(ref["mask"]))
    rec = dict(fn="mp_reconstruct", models=tm, phi=nchw(ref["phi"]),
               phi_prime=torch.from_numpy(ref["pp"]))
    return {
        "rec_2x2": dict(rec, mesh2d=(2, 2)),
        "rec_1x4": dict(rec, mesh2d=(1, 4)),
        "step": step,
        "fault_halo": dict(step, kw=dict(fault="halo")),
        "fault_grads": dict(step, kw=dict(fault="grads")),
        # remat of every target: the recompute exchanges the same halos again
        "step_remat": dict(step, cfg=dict(step["cfg"], remat="lpips+classifier+gan")),
        "eval": dict(fn="mp_eval", mesh2d=(2, 2), models=tm, lpips=lpips, n=N_EVAL,
                     n_classes=NC, size=IMG, batch=EVAL_BATCH,
                     probe_images=torch.from_numpy(images(4, IMG, 9))),
    }


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs, then the four worker processes started on them, and,
    while they run, the JAX side: the reconstructions on both meshes, one
    step of the 2-D mesh-jitted train step (noise strengths zero) and the
    2-D eval. Returns (JAX's results, each rank's outputs)."""
    jm, tm = bundle_pair(seed=12)
    # LPIPS as tests/test_spatial_sharding.py initialises it (zero biases):
    # with perturbed biases some 2x2 feature map of the last VGG slice at
    # 32² is zero in every channel, where the one-pass distance is not
    # finite in either package (ROADMAP.md §3).
    x = jnp.zeros((1, IMG, IMG, 3))
    lparams = _host(run_once(LPIPS().init, jax.random.PRNGKey(2), x, x)["params"])
    rng = np.random.default_rng(13)
    out = dict(jm=jm, tm=tm, lparams=lparams,
               phi=rng.standard_normal((4, 3, 3, NK)).astype(np.float32),
               pp=rng.standard_normal((4, 9 * NK)).astype(np.float32),
               real=rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32),
               fake=rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32),
               labels=rng.integers(0, NC, B).astype(np.int32))
    # JAX's step draws its dropout mask from this key: the port replays it.
    key = jax.random.PRNGKey(5)
    _, _, _, k_drop = jax.random.split(key, 4)
    _, inter = jm.explainer.apply({"params": jm.explainer_params},
                                  jnp.ones((2 * B, 3, 3, NK)), train=True,
                                  rngs={"dropout": k_drop}, capture_intermediates=True)
    out["mask"] = np.asarray(jax.tree_util.tree_leaves(inter["intermediates"]["Dropout_0"])[0]) > 0
    workers = Ranks(tmp_path_factory.mktemp("mp_train"), _worker_inputs(out), world=4)

    out["rebuilt"] = {}
    for mesh_shape in ((2, 2), (1, 4)):
        mesh = make_mesh_2d(*mesh_shape)
        fn = jax.jit(lambda v, a, b: jm.gan.apply(v, a, b, noise_mode="const"),
                     out_shardings=image_sharding(mesh))
        img = fn(jm.gan_vars, out["phi"], out["pp"])
        assert img.sharding.is_equivalent_to(image_sharding(mesh), 4)
        out["rebuilt"][mesh_shape] = np.asarray(img)

    js = copy.copy(jm)
    js.gan_vars = _zero_noise_strength(jm.gan_vars)
    cfg = JParams(batch_size=B, cd_fid_iteration=-1)
    mesh = make_mesh_2d(2, 2)
    step = make_jitted_train_step(js, None, LPIPS(), cfg, mesh=mesh, preprocess=False,
                                  external_fakes=True)
    state = replicate(mesh, jax_create_train_state(js, cfg))
    frozen = replicate(mesh, jax_make_frozen(js, {"params": {}}, lparams))
    spec = image_spec(mesh)
    args = (state, frozen, *shard_batch(mesh, out["real"], out["labels"], out["fake"],
                                        specs=(spec, P("data"), spec)))
    state, metrics = step.lower(args[0], args[1], args[2], args[3], key, args[4]).compile(
        {"xla_backend_optimization_level": 0})(args[0], args[1], args[2], args[3], key, args[4])
    mu = {**_adam_mu(state.opt_state), "mapping": _adam_mu(state.gan_opt_state)}
    out.update(metrics={k: float(v) for k, v in metrics.items()},
               params={g: tree_to_state_dict({"params": _host(t)})
                       for g, t in state.params.items()},
               grads={g: {n: v / 0.1 for n, v in tree_to_state_dict({"params": _host(t)}).items()}
                      for g, t in mu.items()})

    @jax.jit
    def fid_detector(images):  # tests/test_eval.py's tiny stand-in
        m = jnp.mean(images, axis=(1, 2))
        return jnp.concatenate([m, jnp.std(images, axis=(1, 2, 3))[:, None]], axis=1)

    loader = JLoader(JSynthetic(n=N_EVAL, n_classes=NC, image_size=IMG, mode="test"),
                     EVAL_BATCH, shuffle=False, num_threads=0)
    out["eval"] = JE.test_viscoin(jm, LPIPS(), lparams, loader, compute_fid=True,
                                  fid_detector=fid_detector, mesh=make_mesh_2d(2, 2),
                                  verbose=False).__dict__
    return out, workers.join(timeout=240)


@pytest.mark.parametrize("name, mesh", [("rec_2x2", (2, 2)), ("rec_1x4", (1, 4))])
def test_sharded_reconstruction_matches_the_jax_mesh(setup, name, mesh):
    """Each rank's rows of its samples' images equal JAX's (its output
    sharded over (data, model)) within 1e-5 absolute, as
    tests/test_spatial_sharding.py holds JAX's sharded against its own
    unsharded run."""
    jax_ref, ranks = setup
    want = jax_ref["rebuilt"][mesh]
    data, model = mesh
    n = want.shape[0] // data
    for r, out in enumerate(ranks):
        d = r // model
        rows = out[name]["rows"]
        got = out[name]["img"].permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want[d * n: (d + 1) * n, rows], rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name} rank {r}")


def _step_deviation(got: dict, ref: dict) -> tuple[float, float]:
    """(the largest relative deviation of a metric, of a network's
    gradient) of one rank's step from JAX's; inf where a value is not
    finite."""
    metrics = max(abs(got["metrics"][k] - v) / max(abs(v), 1e-6)
                  for k, v in ref["metrics"].items())
    grads = 0.0
    for g in NETWORKS:
        diff = sum(float(np.sum((got["grads"][f"{g}.{n}"].numpy() - v) ** 2))
                   for n, v in ref["grads"][g].items())
        norm = sum(float(np.sum(v ** 2)) for v in ref["grads"][g].values())
        grads = max(grads, (diff / norm) ** 0.5)
    return tuple(v if np.isfinite(v) else np.inf for v in (metrics, grads))


def test_viscoin_step_matches_the_jax_2d_mesh(setup):
    """Four ranks, (2, 2), against JAX's step on its 2-D mesh: total_loss
    and every term within rtol 1e-4; each network's gradient (Psi, Theta,
    the mapping; from the Adams' first moments, taken before the update)
    within 1e-4 of its norm; every rank's parameters after the step
    bit-equal to the others'; and JAX's parameters at the bounds of
    tests/test_spatial_sharding.py (rtol 5e-3, atol 1e-5) where the
    gradient is clear of its tolerance (|g| > 5 % of the leaf's largest):
    Adam's first step moves every element by about lr whatever the size of
    its gradient, so an element whose gradient lies within rounding of 0
    may step the other way (tests/test_torch_dp_train.py's rule); there it
    is held to 2 lr."""
    jax_ref, ranks = setup
    ref = {k: jax_ref[k] for k in ("metrics", "grads")}
    assert all(np.isfinite(v).all() for grp in ref["grads"].values() for v in grp.values())
    for r, out in enumerate(ranks):
        got = out["step"]
        for k, v in jax_ref["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=STEP_RTOL, atol=1e-7,
                                       err_msg=f"rank {r} {k}")
        metrics, grads = _step_deviation(got, ref)
        assert metrics <= STEP_RTOL and grads <= GRAD_TOL, (r, metrics, grads)
        for name, t in got["params"].items():
            assert torch.equal(t, ranks[0]["step"]["params"][name]), (r, name)
    checked = 0
    for g in NETWORKS:
        for n, want in jax_ref["params"][g].items():
            port = ranks[0]["step"]["params"][f"{g}.{n}"].numpy()
            grad = jax_ref["grads"][g][n]
            clear = np.abs(grad) > 0.05 * np.abs(grad).max()
            np.testing.assert_allclose(port[clear], want[clear], rtol=5e-3, atol=1e-5,
                                       err_msg=f"{g}.{n}")
            assert np.abs(port - want).max() <= 2 * LR * (1 + 1e-3), (g, n)
            checked += int(clear.sum())
    assert checked > 1000
    counts = ranks[0]["step"]["counts"]
    assert counts["halo"] > 0 and counts["sum"] > 0 and counts["gather"] > 0, counts


def test_remat_step_equals_the_step(setup):
    """With every remat target (lpips, classifier, gan) the 2-D step
    recomputes those forwards in the backward, halo exchanges included:
    the same metrics and gradients on every rank (rtol 1e-6)."""
    _, ranks = setup
    for r, out in enumerate(ranks):
        got, want = out["step_remat"], out["step"]
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-6, atol=1e-8,
                                       err_msg=f"rank {r} {k}")
        for k, v in want["grads"].items():
            np.testing.assert_allclose(got["grads"][k].numpy(), v.numpy(), rtol=1e-6,
                                       atol=1e-6 * float(v.abs().max()), err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("fault", ["fault_halo", "fault_grads"])
def test_planted_faults_fail_the_step_check(setup, fault):
    """Each planted fault must fail the check above on some rank: the halo
    exchange replaced by zeros (the forward changes), or the gradients
    averaged over the data axis only (each model rank keeps its own
    partial gradient)."""
    jax_ref, ranks = setup
    ref = {k: jax_ref[k] for k in ("metrics", "grads")}
    worst = max(max(a / STEP_RTOL, b / GRAD_TOL)
                for a, b in (_step_deviation(out[fault], ref) for out in ranks))
    assert worst > 10, (fault, worst)


def test_test_viscoin_with_fid_matches_the_jax_2d_eval(setup):
    """``test_viscoin`` over 10 synthetic test images in global batches of
    4 (the last ragged, padded and masked) on a (2, 2) mesh: every metric
    within rtol 1e-4 of JAX's 2-D eval, as tests/test_eval.py holds JAX's
    2-D eval against its one-device run, and the FID within rtol 1e-3, on
    every rank; each image counted once."""
    jax_ref, ranks = setup
    want = jax_ref["eval"]
    for r, out in enumerate(ranks):
        got = out["eval"]["results"]
        assert got.keys() == want.keys()
        for k, v in want.items():
            rtol = 1e-3 if k == "fid_score" else 1e-4
            np.testing.assert_allclose(got[k], v, rtol=rtol, atol=1e-6, err_msg=f"rank {r} {k}")
    assert want["fid_score"] is not None


def test_faithfulness_probe_on_the_2d_mesh(setup):
    """The probe on 4 images over (2, 2), each data shard scoring its 2 on its
    H rows: every rank returns the 4 probabilities of one process (1e-6)."""
    jax_ref, ranks = setup
    want = TE.make_faithfulness_fn(jax_ref["tm"])(torch.from_numpy(images(4, IMG, 9))).numpy()
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["eval"]["probe"].numpy(), want, atol=1e-6,
                                   err_msg=f"rank {r}")
