"""The port's training loop on the CPU, at toy widths: gradient accumulation
against ``optax.MultiSteps`` (the JAX package's optimizers), and
``train_viscoin``: the jsonl keys the JAX loop writes, a resume that is
bit-equal to an unbroken run (with and without accumulation), prefetch
0 and 1 alike, cadences set to 0 disabled, the resume meta check, timings,
stop_after and the profiler trace."""

import functools
import json
import os
import re
from dataclasses import fields

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from viscoin_tpu.train.viscoin import VisCoINTrainingParams as JParams
from viscoin_tpu.train.viscoin import make_optimizers as jax_make_optimizers
from viscoin_tpu.utils.types import TestingResults as JTestingResults
from viscoin_tpu.utils.types import TrainingResults as JTrainingResults
from viscoin_tpu_torch.data.datasets import SyntheticDataset
from viscoin_tpu_torch.data.loader import DataLoader
from viscoin_tpu_torch.models import bundle as tb
from viscoin_tpu_torch.models.concept_extractor import ConceptExtractor
from viscoin_tpu_torch.models.explainer import Explainer
from viscoin_tpu_torch.models.lpips import LPIPS
from viscoin_tpu_torch.models.resnet import Classifier
from viscoin_tpu_torch.models.stylegan import Generator, GeneratorAdapted
from viscoin_tpu_torch.parallel.mesh import Mesh
from viscoin_tpu_torch.train import viscoin as T
from viscoin_tpu_torch.utils.logging import configure_score_logging

IMG, NC, NK, B = 32, 4, 8, 2


def tiny():
    """A toy bundle, original generator and LPIPS from fixed seeds."""
    m = tb.VisCoINModels(
        classifier=Classifier(output_classes=NC, embedding_size=8, hidden_sizes=(8, 16, 32, 64),
                              depths=(1, 1, 1, 1), device="cpu"),
        concept_extractor=ConceptExtractor(n_concepts=NK, latent_channels=8, input_channels1=16,
                                           input_channels2=32, input_channels3=64, device="cpu"),
        explainer=Explainer(n_concepts=NK, n_classes=NC, device="cpu"),
        gan=GeneratorAdapted(z_dim=NK, w_dim=32, img_resolution=IMG, channel_base=256,
                             channel_max=16, device="cpu"))
    tb.init_models(m, 0)
    gen = tb.init_models(Generator(z_dim=16, w_dim=32, img_resolution=IMG, channel_base=256,
                                   channel_max=16, mapping_layers=2, device="cpu"), 1)
    return m, gen, frozen_lpips()


@functools.cache
def frozen_lpips():
    """LPIPS-VGG from seed 2, built once: the loop never changes it."""
    return tb.init_models(LPIPS(device="cpu"), 2)


def loaders(n_train=5, n_test=3, threads=0):
    """5 training images in batches of 2: every epoch ends on a ragged batch
    the loop skips (3 batches, 2 steps per epoch). ``threads`` 0: built in
    the consuming thread."""
    return (DataLoader(SyntheticDataset(n=n_train, n_classes=NC, image_size=IMG), B, seed=7,
                       num_threads=threads),
            DataLoader(SyntheticDataset(n=n_test, n_classes=NC, image_size=IMG, mode="test"), B,
                       shuffle=False, num_threads=0))


def run(tmp, iterations, k=1, resume_from=None, stop_after=None, log="log.jsonl",
        threads=0, **kw):
    os.makedirs(tmp, exist_ok=True)
    configure_score_logging(os.path.join(tmp, log))
    m, gen, lpips = tiny()
    tl, el = loaders(threads=threads)
    cfg = T.VisCoINTrainingParams(iterations=iterations, batch_size=B, cd_fid_iteration=-1,
                                  gradient_accumulation=k)
    opts = dict(eval_every=100, checkpoint_every=100, faithfulness_every=0)
    opts.update(kw)
    T.train_viscoin(m, gen, lpips, tl, el, cfg, checkpoint_dir=tmp, resume_from=resume_from,
                    stop_after=stop_after, device="cpu", **opts)
    return m


def trained(m):
    return {n: p.detach().clone() for n, p in T.trainable_modules(m)["concept_extractor"]
            .named_parameters()} | {
        f"mapping.{n}": p.detach().clone() for n, p in m.gan.mapping.named_parameters()} | {
        f"explainer.{n}": p.detach().clone() for n, p in m.explainer.named_parameters()}


def records(tmp, log="log.jsonl"):
    with open(os.path.join(tmp, log)) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------- gradient accumulation -------------------------- #


def _toy_state(cfg):
    rng = np.random.default_rng(0)
    params = {g: {n: torch.nn.Parameter(torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))) for n, shape in leaves.items()}
        for g, leaves in {"concept_extractor": {"w": (3, 4)}, "explainer": {"b": (5,)},
                          "mapping": {"m": (2, 3), "s": ()}}.items()}
    opt, gan_opt = T.make_optimizers(cfg, params)
    acc = {g: {n: torch.zeros_like(p) for n, p in grp.items()} for g, grp in params.items()} \
        if cfg.gradient_accumulation > 1 else None
    return T.TrainState(step=0, params=params, opt=opt, gan_opt=gan_opt, acc=acc)


@pytest.mark.parametrize("schedule_kind", ["fast", "viscoin"])
def test_accumulation_matches_optax_multisteps(schedule_kind):
    """k = 3, 6 micro-steps on one fixed gradient sequence: the parameters
    within 1e-6 relative of optax.MultiSteps(adam(schedule), 3) after every
    micro-step; unchanged (and the Adam moments unmoved) between updates.
    "fast" halves the rate every 2 counts, which shows the count * k rescale."""
    k = 3
    cfg = T.VisCoINTrainingParams(iterations=10, learning_rate=1e-2, gradient_accumulation=k)
    if schedule_kind == "fast":
        def sched(step):
            return 1e-2 * 0.5 ** (step // 2)

        tx = optax.MultiSteps(optax.adam(lambda c: 1e-2 * 0.5 ** ((c * k) // 2)), k)
        gan_tx = optax.MultiSteps(optax.adam(lambda c: 1e-2 * 0.5 ** ((c * k) // 2)), k)
    else:
        sched = T.make_lr_schedule(cfg.learning_rate, cfg.iterations)
        tx, gan_tx = jax_make_optimizers(JParams(iterations=10, learning_rate=1e-2,
                                                 gradient_accumulation=k))
    state = _toy_state(cfg)
    jp = {g: {n: jnp.asarray(p.detach().numpy()) for n, p in grp.items()}
          for g, grp in state.params.items()}
    psi_theta = {g: jp[g] for g in ("concept_extractor", "explainer")}
    opt_s, gan_s = tx.init(psi_theta), gan_tx.init(jp["mapping"])
    update, gan_update = jax.jit(tx.update), jax.jit(gan_tx.update)  # one compile each
    rng = np.random.default_rng(1)
    for micro in range(6):
        grads = {g: {n: rng.standard_normal(p.shape).astype(np.float32)
                     for n, p in grp.items()} for g, grp in state.params.items()}
        before = {g: {n: p.detach().clone() for n, p in grp.items()}
                  for g, grp in state.params.items()}
        moments = [t.clone() for t in state.opt.state_dict()["state"].get(0, {}).values()]
        for g, grp in state.params.items():
            for n, p in grp.items():
                p.grad = torch.from_numpy(grads[g][n])
        updated = T.optimizer_update(state, cfg, sched)
        assert updated == (micro % k == k - 1)
        assert state.step == micro + 1
        u, opt_s = update({g: {n: jnp.asarray(v) for n, v in grads[g].items()}
                              for g in psi_theta}, opt_s, psi_theta)
        psi_theta = optax.apply_updates(psi_theta, u)
        u, gan_s = gan_update({n: jnp.asarray(v) for n, v in grads["mapping"].items()},
                                 gan_s, jp["mapping"])
        jp["mapping"] = optax.apply_updates(jp["mapping"], u)
        want = {**psi_theta, "mapping": jp["mapping"]}
        for g, grp in state.params.items():
            for n, p in grp.items():
                w = np.asarray(want[g][n])
                np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-6,
                                           atol=1e-6 * max(1.0, float(np.abs(w).max())))
                if not updated:
                    assert torch.equal(p.detach(), before[g][n])
                    assert p.grad is None
        if not updated:
            after = [t for t in state.opt.state_dict()["state"].get(0, {}).values()]
            assert all(torch.equal(a, b) for a, b in zip(moments, after))


def test_accumulation_in_the_step_equals_the_mean_gradient():
    """Two micro-steps of the real step on one batch each, k = 2, leave the
    parameters where one Adam step on the mean of the two gradients does."""
    m, gen, lpips = tiny()
    cfg = T.VisCoINTrainingParams(batch_size=B, cd_fid_iteration=-1, gradient_accumulation=2)
    ref = T.VisCoINTrainingParams(batch_size=B, cd_fid_iteration=-1)
    u8 = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, B, IMG, IMG, 3),
                                                            dtype=np.uint8))
    labels = torch.tensor([[0, 1], [2, 3]])
    fakes = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, B, 3, IMG, IMG)).astype(np.float32))
    mask = torch.ones(2, B * 2, NK, 3, 3, dtype=torch.bool)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("noise_strength"):
                p.zero_()
    m_ref = tiny()[0]
    m_ref.load_state_dict(m.state_dict())
    frozen = T.make_frozen(m, gen, lpips)
    state = T.create_train_state(m, cfg)
    step = T.make_train_step(m, gen, lpips, cfg, external_fakes=True)
    for j in range(2):
        step(state, frozen, u8[j], labels[j], T.step_generator(0, j, "cpu"), fakes[j],
             dropout_mask=mask[j])
    # The reference: the mean gradient of the same two losses, one Adam step.
    frozen_r = T.make_frozen(m_ref, gen, lpips)
    state_r = T.create_train_state(m_ref, ref)
    loss_fn = T.make_loss_fn(m_ref, gen, lpips, ref)
    leaves = [p for grp in state_r.params.values() for p in grp.values()]
    mean = [torch.zeros_like(p) for p in leaves]
    for j in range(2):
        flips = torch.rand(B, generator=T.step_generator(0, j, "cpu")) < 0.5
        rng = T.step_generator(0, j, "cpu")
        torch.rand(B, generator=rng)  # the step draws its flips first
        from viscoin_tpu_torch.data.transforms import device_preprocess

        total, _ = loss_fn(state_r.params, frozen_r, device_preprocess(u8[j], flips), labels[j],
                           j, rng, fakes[j], mask[j])
        for acc, g in zip(mean, torch.autograd.grad(total, leaves)):
            acc.add_((g - acc) / (j + 1))
    for p, g in zip(leaves, mean):
        p.grad = g
    T.optimizer_update(state_r, ref, T.make_lr_schedule(ref.learning_rate, ref.iterations))
    assert state.step == 2 and state_r.step == 1
    for (n, a), (_, b) in zip(m.named_parameters(), m_ref.named_parameters()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=n)


# ------------------------------- train_viscoin ------------------------------- #


def test_loop_writes_the_jax_keys_checkpoints_and_probe(tmp_path, capfd):
    """4 iterations, eval, checkpoints and probe every 2: two jsonl records
    with exactly the JAX loop's keys (finite), bundles viscoin0-2 and
    viscoin1-2, the training state at step 3, one probe line, timings."""
    timings = {}
    run(str(tmp_path), 4, eval_every=2, checkpoint_every=2, faithfulness_every=2,
        timings=timings, prefetch=1, threads=2)
    recs = records(str(tmp_path))
    want = {f"train_{f.name}" for f in fields(JTrainingResults)} | {
        f"test_{f.name}" for f in fields(JTestingResults)}
    assert len(recs) == 2
    for rec in recs:
        assert set(rec) == want
        assert all(np.isfinite(v) for k, v in rec.items() if k != "test_fid_score")
        assert rec["test_fid_score"] is None
    assert {"viscoin0-2", "viscoin1-2", "train_state"} <= set(os.listdir(tmp_path))
    saved = torch.load(tmp_path / "train_state" / "train_state.pt", weights_only=True)
    assert saved["step"] == 3
    with open(tmp_path / "train_state" / "train_state_meta.json") as f:
        assert json.load(f) == {"fake_presample_steps": 2, "batch_size": B, "seed": 0,
                                "compute_dtype": "float32"}
    out = capfd.readouterr().out
    assert len(re.findall(r"Faithfullness stats .* mean = [0-9.e-]+ --- std", out)) == 1
    for phase, n in (("steps", 4), ("eval", 2), ("checkpoint", 2), ("probe", 1)):
        assert timings[f"n_{phase}"] == n and len(timings["seconds"][phase]) == n
        assert timings[phase] >= timings[f"max_{phase}"] > 0


@pytest.mark.parametrize("k", [1, 2])
def test_resume_is_bit_equal_to_an_unbroken_run(tmp_path, k):
    """8 unbroken steps against 4 (the state saved after the step at i = 3,
    step 4) + a resume to 8, on a loader whose epochs end ragged: identical
    parameters, Adam states and accumulation buffers, bit for bit."""
    unbroken = run(str(tmp_path / "a"), 8, k=k)
    state_a = torch.load(tmp_path / "a" / "train_state" / "train_state.pt", weights_only=True)
    run(str(tmp_path / "b"), 8, k=k, stop_after=4, checkpoint_every=3)
    saved = torch.load(tmp_path / "b" / "train_state" / "train_state.pt", weights_only=True)
    assert saved["step"] == 4
    resumed = run(str(tmp_path / "b"), 8, k=k, resume_from=str(tmp_path / "b" / "train_state"),
                  log="resumed.jsonl", checkpoint_every=7)
    for (n, a), (_, b) in zip(trained(unbroken).items(), trained(resumed).items()):
        assert torch.equal(a, b), n
    state_b = torch.load(tmp_path / "b" / "train_state" / "train_state.pt", weights_only=True)
    assert state_b["step"] == 8 and state_a["step"] == 1
    assert records(str(tmp_path / "b"), "resumed.jsonl") == []  # no eval at i = 4..7


def test_prefetch_0_and_1_train_identically(tmp_path):
    a = run(str(tmp_path / "a"), 3, prefetch=0)
    b = run(str(tmp_path / "b"), 3, prefetch=1, threads=2)  # the loader's producer thread
    for (n, x), (_, y) in zip(trained(a).items(), trained(b).items()):
        assert torch.equal(x, y), n


def test_cadences_set_to_0_are_disabled(tmp_path, capfd):
    timings = {}
    run(str(tmp_path), 3, eval_every=0, checkpoint_every=0, faithfulness_every=0,
        timings=timings)
    assert records(str(tmp_path)) == []
    assert sorted(os.listdir(tmp_path)) == ["log.jsonl"]
    assert "Faithfullness" not in capfd.readouterr().out
    assert set(timings) == {"steps", "n_steps", "max_steps", "seconds"}


def test_resume_meta_mismatch_raises(tmp_path):
    run(str(tmp_path), 2, checkpoint_every=1)
    path = str(tmp_path / "train_state")
    with pytest.raises(ValueError, match="resume mismatch.*batch_size"):
        m, gen, lpips = tiny()
        tl, el = loaders()
        tl.batch_size = 1
        T.train_viscoin(m, gen, lpips, tl, el,
                        T.VisCoINTrainingParams(iterations=4, batch_size=1), resume_from=path,
                        device="cpu", checkpoint_dir=str(tmp_path))
    with open(os.path.join(path, "train_state_meta.json")) as f:
        meta = json.load(f)
    del meta["compute_dtype"]  # a key the checkpoint never recorded is a mismatch too
    with open(os.path.join(path, "train_state_meta.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="compute_dtype: <absent from checkpoint>"):
        run(str(tmp_path), 4, resume_from=path)


def test_stop_after_profile_and_refusals(tmp_path):
    """stop_after keeps the schedule of cfg.iterations; profile_dir writes a
    chrome trace; a mesh over unsharded loaders, a sharded loader without a
    mesh, a batch-size mismatch and a too-small dataset raise."""
    timings = {}
    run(str(tmp_path), 100, stop_after=3, eval_every=0, checkpoint_every=0, timings=timings,
        profile_dir=str(tmp_path / "prof"))
    assert timings["n_steps"] == 3
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    m, gen, lpips = tiny()
    cfg = T.VisCoINTrainingParams(iterations=2, batch_size=B)
    tl, el = loaders()
    # A mesh needs the loaders sharded over it (one shard per rank).
    with pytest.raises(ValueError, match="shard"):
        T.train_viscoin(m, gen, lpips, tl, el, cfg, mesh=Mesh(0, 2, torch.device("cpu")),
                        device="cpu")
    sharded = DataLoader(SyntheticDataset(n=8, image_size=IMG), B, shard=(0, 2))
    with pytest.raises(ValueError, match="sharded"):
        T.train_viscoin(m, gen, lpips, sharded, el, cfg, device="cpu")
    with pytest.raises(ValueError, match="batch_size"):
        T.train_viscoin(m, gen, lpips, tl, el, T.VisCoINTrainingParams(batch_size=4),
                        device="cpu")
    small = DataLoader(SyntheticDataset(n=1, image_size=IMG), B)
    with pytest.raises(ValueError, match="no full batch"):
        T.train_viscoin(m, gen, lpips, small, el, cfg, device="cpu")
