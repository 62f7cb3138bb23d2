"""The port's data-parallel trainers and evals on the CPU, over two gloo
processes (``tests/torch_dp_worker.py``), at toy widths:

  * the VisCoIN step (64², global batch 2 real + 2 synthetic, one of each
    per rank) against the JAX package's ``make_jitted_train_step(mesh=)``
    over two forced host devices, at the same global batch: the synthetic
    batch given, the noise strengths zero, JAX's dropout mask replayed (each
    rank its rows);
  * the GAN step at steps 0 (R1 and the path length), 1, 3 (an ADA
    adjustment) and 4 (the path length) over two ranks against one process
    at the same global batch of 8 (the mbstd groups of 4 span the ranks; the
    draws are the global batch's, constant synthesis noise), and a planted
    fault (the gradient all-reduce skipped) that must fail that check;
  * two classifier steps (BatchNorm on the global batch's statistics and
    its running statistics) over two ranks against one process;
  * ``test_viscoin`` with FID over a test set whose last batch is ragged
    (each rank's shard padded by ``pad_final``), and the faithfulness probe,
    against one process;
  * ``python -m viscoin_tpu_torch train viscoin`` as two processes of one
    group: rank 0 alone writes, and the run resumes.

Tolerances (fp32) are stated at each check."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_dp_worker import (
    classifier_inputs,
    free_port,
    gan_deviation,
    gan_inputs,
    relative,
    run_classifier_steps,
    run_gan_fid,
    run_gan_steps,
    run_ranks,
    run_test_viscoin,
    run_viscoin_step,
)
from torch_port_helpers import (
    CLASSIFIER,
    GAN,
    NC,
    NK,
    PSI,
    bundle_pair,
    images,
    jax_bundle,
    nchw,
    perturb,
    run_once,
    torch_bundle,
)
from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from viscoin_tpu.models.lpips import LPIPS
from viscoin_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from viscoin_tpu.train.viscoin import VisCoINTrainingParams as JParams
from viscoin_tpu.train.viscoin import create_train_state as jax_create_train_state
from viscoin_tpu.train.viscoin import make_frozen as jax_make_frozen
from viscoin_tpu.train.viscoin import make_jitted_train_step
from viscoin_tpu_torch.models.bundle import init_models
from viscoin_tpu_torch.models.lpips import LPIPS as TLPIPS
from viscoin_tpu_torch.utils.weights import load_jax_tree, tree_to_state_dict

WORLD = 2
IMG, B = 64, 2  # the VisCoIN step of tests/test_torch_train.py, over two ranks
LR = 1e-4  # VisCoINTrainingParams' learning rate


def _zero_noise_strength(tree):
    return jax.tree_util.tree_map_with_path(
        lambda p, x: np.zeros_like(x) if getattr(p[-1], "key", None) == "noise_strength" else x,
        tree)


def _adam_mu(opt_state) -> dict:
    """The first moments of optax.adam's state (inside ``optax.chain``)."""
    return next(s.mu for s in opt_state if hasattr(s, "mu"))


@pytest.fixture(scope="module")
def viscoin_ref():
    """The JAX side, once: the 64² bundle (zero noise strengths), LPIPS,
    inputs, one step of the mesh-jitted train step over two host devices,
    and the dropout mask it drew."""
    jm = jax_bundle(img=IMG)
    jm.gan_vars = _zero_noise_strength(jm.gan_vars)
    x = jnp.zeros((1, 16, 16, 3))
    lparams = perturb(run_once(LPIPS().init, jax.random.PRNGKey(7), x, x)["params"], 8)
    rng = np.random.default_rng(13)
    real = rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32)
    fake = rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32)
    labels = rng.integers(0, NC, B).astype(np.int32)
    cfg = JParams(batch_size=B, cd_fid_iteration=-1)
    key = jax.random.PRNGKey(5)
    mesh = make_mesh(WORLD)
    step = make_jitted_train_step(jm, None, LPIPS(), cfg, mesh=mesh, preprocess=False,
                                  external_fakes=True)
    before = jax.tree_util.tree_map(np.asarray, {
        "concept_extractor": jm.concept_params, "explainer": jm.explainer_params,
        "mapping": jm.gan_vars["params"]["mapping"]})
    state = replicate(mesh, jax_create_train_state(jm, cfg))
    frozen = replicate(mesh, jax_make_frozen(jm, {"params": {}}, lparams))
    r, lb, f = shard_batch(mesh, real, labels, fake)
    state, metrics = step(state, frozen, r, lb, key, f)
    _, _, _, k_drop = jax.random.split(key, 4)
    _, inter = jm.explainer.apply({"params": jm.explainer_params}, jnp.ones((2 * B, 3, 3, NK)),
                                  train=True, rngs={"dropout": k_drop}, capture_intermediates=True)
    mask = np.asarray(jax.tree_util.tree_leaves(inter["intermediates"]["Dropout_0"])[0]) > 0
    mu = {**_adam_mu(state.opt_state), "mapping": _adam_mu(state.gan_opt_state)}
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(jm=jm, lparams=lparams, real=real, fake=fake, labels=labels, mask=mask,
                metrics={k: float(v) for k, v in metrics.items()},
                before={g: tree_to_state_dict({"params": t}) for g, t in before.items()},
                params={g: tree_to_state_dict({"params": host(t)})
                        for g, t in state.params.items()},
                mu={g: tree_to_state_dict({"params": host(t)}) for g, t in mu.items()})


def _eval_inputs():
    _, tm = bundle_pair(seed=6)
    proj = torch.from_numpy(np.random.default_rng(0).standard_normal((3 * 32 * 32, 6))
                            .astype(np.float32))
    return dict(models=tm, lpips=init_models(TLPIPS(device="cpu"), 2), proj=proj, n=7,
                n_classes=NC, size=32, batch=4, probe_images=torch.from_numpy(images(4, 32, 9)))


def _fid_inputs():
    proj = np.random.default_rng(1).standard_normal((3 * 32 * 32, 4)).astype(np.float32)
    return dict(g=gan_inputs()["g"], proj=torch.from_numpy(proj), n=20, batch=8, samples=12)


@pytest.fixture(scope="module")
def ranks(viscoin_ref, tmp_path_factory):
    """One run of two worker processes over every scenario, and the inputs
    (the one-process references are computed from these, in this process)."""
    work = tmp_path_factory.mktemp("dp_train")
    tm = torch_bundle(viscoin_ref["jm"], img=IMG)
    lp = load_jax_tree(TLPIPS(device="cpu"), {"params": viscoin_ref["lparams"]})
    gan = gan_inputs()
    inputs = {
        "viscoin_step": dict(models=tm, lpips=lp, cfg=dict(batch_size=B, cd_fid_iteration=-1),
                             real=nchw(viscoin_ref["real"]), fake=nchw(viscoin_ref["fake"]),
                             labels=torch.from_numpy(viscoin_ref["labels"]).long(),
                             mask=nchw(viscoin_ref["mask"])),
        "gan_steps": gan,
        "gan_fault": dict(gan, fn="gan_steps", kw=dict(skip_grad_reduce=True)),
        "classifier_steps": classifier_inputs(),
        "test_viscoin": _eval_inputs(),
        "gan_fid": _fid_inputs(),
    }
    inputs["viscoin_accum"] = dict(inputs["viscoin_step"], fn="viscoin_step", micro=2,
                                   cfg=dict(batch_size=B, cd_fid_iteration=-1,
                                            gradient_accumulation=2))
    command = dict(dir=str(work / "command"), classifier=CLASSIFIER, psi=PSI, gan=GAN,
                   ports=[free_port(), free_port()])
    outs = run_ranks(work, inputs, WORLD, timeout=240)
    cmd = run_ranks(work, {"command": command}, WORLD, timeout=240)
    return inputs, outs, [c["command"] for c in cmd], command["dir"]


def test_viscoin_step_matches_the_jax_mesh_step(viscoin_ref, ranks):
    """Two ranks against JAX's step over a two-device mesh at the same
    global batch: every metric (the global means; rtol 1e-4, as the
    one-process step against JAX), the Adams' first moments, which hold
    the gradients averaged over the ranks (1e-4 of each leaf's scale; 4e-6
    seen), and the updated parameters:
    the same on both ranks (bit-equal), and where the gradient is clear of
    its tolerance, the update -lr * sign(g) that Adam's first step takes
    (within 1e-3 of lr)."""
    _, outs, _, _ = ranks
    got = [o["viscoin_step"] for o in outs]
    for k, v in viscoin_ref["metrics"].items():
        for r in range(WORLD):
            np.testing.assert_allclose(got[r]["metrics"][k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=f"rank {r} {k}")
    for name, t in got[0]["params"].items():
        assert torch.equal(t, got[1]["params"][name]), name
    checked = 0
    for g, grp in viscoin_ref["mu"].items():
        for n, mu in grp.items():
            port_mu = got[0]["exp_avg"][f"{g}.{n}"].numpy()
            assert relative(port_mu, mu) < 1e-4, (g, n, relative(port_mu, mu))
            clear = np.abs(mu) > 0.05 * np.abs(mu).max()
            step = (got[0]["params"][f"{g}.{n}"].numpy() - viscoin_ref["before"][g][n]) / LR
            want = (viscoin_ref["params"][g][n] - viscoin_ref["before"][g][n]) / LR
            np.testing.assert_allclose(step[clear], want[clear], atol=1e-3, err_msg=f"{g}.{n}")
            checked += int(clear.sum())
    assert checked > 1000


def test_gan_steps_over_two_ranks_match_one_process(ranks):
    """R1 and the path length (with its non-detached global mean), plain, an
    ADA adjustment and the path length again, over two ranks against one
    process at the global batch of 8: every step's metrics (g_loss, d_loss,
    r1, pl_lengths, pl_mean, ada_p, r_t), then G, D, the EMA, w_avg,
    pl_mean and the ADA state, within 1e-5 of each tensor's scale (fp32,
    only the order of the sums differs; 5e-7 seen).
    The planted fault, each rank updating with its own gradients, must
    fail the same check on the parameters."""
    inputs, outs, _, _ = ranks
    ref = run_gan_steps(gan_inputs(), None)
    dev = gan_deviation(outs, ref, "gan_steps")
    worst = max(dev, key=dev.get)
    assert dev[worst] < 1e-5, (worst, dev[worst])
    assert all(m["r1"] > 0 for m in (ref["metrics"][0],))
    assert ref["metrics"][0]["pl_lengths"] > 0 and ref["metrics"][3]["pl_lengths"] > 0
    assert ref["ada_p"] != 0.2  # the adjustment at step 3 moved p
    fault = gan_deviation(outs, ref, "gan_fault")
    params = {k: v for k, v in fault.items() if k.startswith(("g.", "d."))}
    assert max(params.values()) > 100 * max(dev[k] for k in params), max(params.values())


def test_classifier_steps_over_two_ranks_match_one_process(ranks):
    """Two steps at the global batch of 8 (4 per rank): the global loss and
    count of correct predictions (1e-5), every parameter and the BatchNorm
    running statistics, the same on both ranks, within 1e-4 of each tensor's
    scale of one process's (fp32: the running statistics move by the global
    batch's, not a rank's)."""
    _, outs, _, _ = ranks
    ref = run_classifier_steps(classifier_inputs(), None)
    for r in range(WORLD):
        got = outs[r]["classifier_steps"]
        np.testing.assert_allclose(np.asarray(got["losses"]), np.asarray(ref["losses"]),
                                   rtol=1e-5)
        for n, t in ref["state"].items():
            if t.is_floating_point():
                assert relative(got["state"][n], t) < 1e-4, (r, n, relative(got["state"][n], t))
    for n, t in outs[0]["classifier_steps"]["state"].items():
        assert torch.equal(t, outs[1]["classifier_steps"]["state"][n]), n
    assert any("running_mean" in n for n in ref["state"])


def test_sharded_test_viscoin_matches_one_process(ranks):
    """7 test images, global batch 4: the second global batch has 3, so one
    rank's shard holds a padding row (label -1, masked). Every metric and
    the FID (the features of each global batch gathered, padding dropped)
    on both ranks equal one process over the unsharded loader (1e-5
    relative); the faithfulness probe, each rank scoring half of the 4
    images, equals one process's (1e-6)."""
    _, outs, _, _ = ranks
    ref = run_test_viscoin(_eval_inputs(), None)
    for r in range(WORLD):
        got = outs[r]["test_viscoin"]
        for k, v in ref["results"].items():
            np.testing.assert_allclose(got["results"][k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {r} {k}")
        np.testing.assert_allclose(got["probe"].numpy(), ref["probe"].numpy(), atol=1e-6)
    assert ref["results"]["fid_score"] is not None


def test_train_viscoin_command_over_two_processes(ranks):
    """`train viscoin` (main) in two processes of one gloo group, at toy
    widths, each in its own working directory: 3 iterations (eval every 1,
    checkpoints and the probe every 2), then a resume to 4 from rank 0's
    training state. Rank 0 writes the jsonl, the bundles and the state;
    rank 1 writes nothing; the records are finite."""
    import json

    _, _, cmd, work = ranks
    assert all(c["rcs"] == [0, 0] for c in cmd)
    assert cmd[1]["first"] == [] and cmd[1]["files"] == []
    assert {"viscoin_3.jsonl", "viscoin_4.jsonl", "viscoin0-1", "viscoin1-1",
            "train_state"} <= set(cmd[0]["files"])
    with open(os.path.join(work, "rank0", "viscoin_3.jsonl")) as f:
        first = [json.loads(line) for line in f]
    with open(os.path.join(work, "rank0", "viscoin_4.jsonl")) as f:
        resumed = [json.loads(line) for line in f]
    assert len(first) == 3 and len(resumed) == 1
    for rec in first + resumed:
        assert all(np.isfinite(v) for k, v in rec.items() if k != "test_fid_score"), rec
    state = torch.load(os.path.join(work, "rank0", "train_state", "train_state.pt"),
                       weights_only=True)
    assert state["step"] == 3


def test_viscoin_gradient_accumulation_over_two_ranks(ranks):
    """gradient_accumulation = 2 over two ranks: two micro-steps (the second
    on the batch reversed), one update on the mean of their gradients,
    averaged over the ranks after the last; against one process: the last
    micro-step's metrics (1e-5 relative) and the Adams' first moments
    (1e-4 of each leaf's scale, as against JAX above)."""
    inputs, outs, _, _ = ranks
    ref = run_viscoin_step(inputs["viscoin_accum"], None)
    for out in outs:
        got = out["viscoin_accum"]
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)
        for k, mu in ref["exp_avg"].items():
            assert relative(got["exp_avg"][k], mu) < 1e-4, k


def test_gan_fid_sampling_over_two_ranks(ranks):
    """`train gan`'s FID statistics with the sampling sharded: each rank
    its shard of the real batches and its rows of every fake batch (the
    features gathered, the estimate's last batch cut at 12 samples); both
    sides' means and covariances (1e-5 of their scale), counts and the FID
    (1e-5 relative) equal one process's on every rank."""
    _, outs, _, _ = ranks
    ref = run_gan_fid(_fid_inputs(), None)
    for out in outs:
        got = out["gan_fid"]
        for side in ("real", "fake"):
            for a, b in zip(got[side][:2], ref[side][:2]):
                assert relative(a, b) < 1e-5, side
            assert got[side][2] == ref[side][2] == 12
        np.testing.assert_allclose(got["fid"], ref["fid"], rtol=1e-5)
