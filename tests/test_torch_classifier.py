"""The classifier stage of the PyTorch port (``viscoin_tpu_torch/train/classifiers.py``,
``eval/classifiers.py``, the train-mode BatchNorm of ``models/resnet.py``,
``train classifier`` and ``test classifier``), the FID options of the two
other trainers, and the concept extractor's deterministic pooling, against
the JAX package at toy widths:

  * one train step (Adam and SGD with momentum) at 64² with JAX's flips
    replayed: the loss within 1e-5, every gradient within 1e-4 of its leaf's
    scale, the updated parameters within 1e-6, the BatchNorm running
    statistics within 2e-5 of their leaf's scale (the worst, a running mean
    of scale 0.14, reads 1.2e-5: 0.1 of the batch mean, whose 1.6e-5 gap is
    the two frameworks' fp32 convolutions, unchanged by a float64 mean); the
    rate at the schedule's boundaries equal to optax's;
  * ``test_classifier`` with a ragged last batch: the same accuracy, the
    loss within 1e-5;
  * in-process commands (builders patched to toy widths): ``train
    classifier``, then ``test classifier`` on its output (the best epoch's
    accuracy) and ``train viscoin`` reading it with ``--fid-detector``
    (a TorchScript file; the eval's fid_score finite); ``train gan
    --fid-every`` (the logged FID equals a recomputation from the export
    with the same draws);
  * the pooling 7 -> 3, 8 -> 3 and 5 -> 3 against JAX's adaptive_avg_pool.
"""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

from test_torch_cli import toy_modules
from test_torch_gan_cli import toy_gan_modules
from torch_port_helpers import CLASSIFIER, perturb, run_once
from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from viscoin_tpu.data.datasets import SyntheticDataset as JSyntheticDataset
from viscoin_tpu.data.loader import DataLoader as JDataLoader
from viscoin_tpu.eval.classifiers import test_classifier as jax_test_classifier
from viscoin_tpu.models.concept_extractor import adaptive_avg_pool as jax_pool
from viscoin_tpu.models.resnet import Classifier as JClassifier
from viscoin_tpu.train import classifiers as jtc
from viscoin_tpu_torch.__main__ import main
from viscoin_tpu_torch.cli import train as cli_train
from viscoin_tpu_torch.data.datasets import SyntheticDataset
from viscoin_tpu_torch.data.loader import DataLoader
from viscoin_tpu_torch.data.utils import get_datasets
from viscoin_tpu_torch.eval import classifiers as tec
from viscoin_tpu_torch.eval.fid import fid_from_stats
from viscoin_tpu_torch.models.concept_extractor import adaptive_avg_pool
from viscoin_tpu_torch.models.inception import make_torchscript_fid_detector
from viscoin_tpu_torch.models.resnet import Classifier
from viscoin_tpu_torch.train import classifiers as tc
from viscoin_tpu_torch.train import gan as tgan
from viscoin_tpu_torch.train.viscoin import fold_seed
from viscoin_tpu_torch.utils import checkpoints as ckpt
from viscoin_tpu_torch.utils.weights import load_jax_tree, module_to_jax_tree, tree_to_state_dict

B, IMG, NC = 4, 64, CLASSIFIER["output_classes"]


@pytest.fixture(scope="module")
def jax_classifier():
    model = JClassifier(**CLASSIFIER)
    v = run_once(lambda k: model.init(k, jnp.zeros((1, IMG, IMG, 3)), train=False),
                 jax.random.PRNGKey(0))
    return model, jax.tree_util.tree_map(np.asarray, perturb(v, 1))


def _port(v) -> Classifier:
    return load_jax_tree(Classifier(**CLASSIFIER, device="cpu"), v)


def _batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8),
            rng.integers(0, NC, (B,)).astype(np.int32))


def _leaf_close(got: dict, want_tree: dict, tol: float, label: str):
    want = tree_to_state_dict(want_tree)
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[name].detach().numpy(), w, rtol=0,
                                   atol=tol * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"{label}: {name}")


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_train_step_matches_jax(jax_classifier, optimizer):
    model, v = jax_classifier
    images, labels = _batch()
    rng = jax.random.PRNGKey(3)
    flips = np.asarray(jax.random.bernoulli(rng, 0.5, (B,)))
    lr = 1e-3 if optimizer == "adam" else 0.1
    schedule = optax.piecewise_constant_schedule(lr, {30: 0.1, 60: 0.1})
    tx = optax.adam(schedule) if optimizer == "adam" else optax.sgd(schedule, momentum=0.9)

    # JAX: the gradients of the step's own loss, then the step.
    def loss_fn(params):
        x = jtc.device_preprocess(jnp.asarray(images), jnp.asarray(flips))
        (logits, _), _ = model.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                                     train=True, mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], axis=-1))

    want_grads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_fn))(v["params"]))
    state = jtc.ClassifierState(params=v["params"], batch_stats=v["batch_stats"],
                                opt_state=tx.init(v["params"]), step=jnp.zeros((), jnp.int32))
    new, want_loss, want_correct = jtc.make_classifier_train_step(model, tx)(
        state, jnp.asarray(images), jnp.asarray(labels), rng)

    port = _port(v)
    params = dict(port.named_parameters())
    loss, _ = tc.classifier_loss(port, torch.from_numpy(images), torch.from_numpy(labels).long(),
                                 torch.from_numpy(flips.copy()))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    _leaf_close(grads, {"params": want_grads}, 1e-4, "gradient")

    port = _port(v)  # fresh running statistics for the whole step
    st = tc.create_classifier_state(port, tc.ClassifierTrainingParams(
        learning_rate=lr, optimizer=optimizer), steps_per_epoch=1)
    loss, correct = tc.make_classifier_train_step()(
        st, torch.from_numpy(images), torch.from_numpy(labels).long(),
        torch.from_numpy(flips.copy()))
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert int(correct) == int(want_correct) and st.step == 1
    _leaf_close(dict(port.named_buffers()), {"batch_stats": jax.tree_util.tree_map(
        np.asarray, new.batch_stats)}, 2e-5, "running statistics")
    # The update itself, from JAX's gradients (Adam's first step divides a
    # gradient by its own size: near-zero entries would compare the
    # gradients' last bits instead).
    port = _port(v)
    st = tc.create_classifier_state(port, tc.ClassifierTrainingParams(
        learning_rate=lr, optimizer=optimizer), steps_per_epoch=1)
    jax_grads = tree_to_state_dict({"params": want_grads})
    tc.apply_gradients(st, [torch.from_numpy(jax_grads[n]) for n, _ in port.named_parameters()])
    got = tree_to_state_dict({"params": module_to_jax_tree(port)["params"]})
    for name, w in tree_to_state_dict({"params": jax.tree_util.tree_map(
            np.asarray, new.params)}).items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-6, err_msg=name)


def test_schedule_matches_optax_at_its_boundaries():
    """Boundaries at 30 E and 60 E steps, E = 7 (a ragged epoch would move
    an epoch-based StepLR elsewhere)."""
    E = 7
    ours = tc.make_lr_schedule(1e-3, E)
    want = optax.piecewise_constant_schedule(1e-3, {30 * E: 0.1, 60 * E: 0.1})
    for count in (0, 30 * E - 1, 30 * E, 30 * E + 1, 60 * E - 1, 60 * E, 90 * E):
        assert ours(count) == float(want(count)), count
    assert ours(30 * E - 1) == float(np.float32(1e-3)) and ours(60 * E) < ours(30 * E)


def test_test_classifier_with_a_ragged_batch_matches_jax(jax_classifier):
    """10 test images at batch 4: the last batch has 2, padded and masked."""
    model, v = jax_classifier
    kw = dict(n=10, n_classes=NC, image_size=IMG, mode="test")
    want_acc, want_loss = jax_test_classifier(
        model, v, JDataLoader(JSyntheticDataset(**kw), 4, shuffle=False), verbose=False)
    acc, loss = tec.test_classifier(_port(v).eval(), DataLoader(SyntheticDataset(**kw), 4,
                                                            shuffle=False))
    assert acc == want_acc
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)


@pytest.mark.parametrize("sizes", [(7, 7), (8, 8), (5, 5)])
def test_concept_pooling_matches_jax(sizes):
    x = np.random.default_rng(sum(sizes)).standard_normal((2, *sizes, 6)).astype(np.float32)
    want = np.asarray(jax_pool(jnp.asarray(x), 3))
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = adaptive_avg_pool(t, 3)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), F.adaptive_avg_pool2d(t, 3).numpy(), rtol=0,
                               atol=1e-6)


# ------------------------------- the commands -------------------------------- #


def toy_classifier(n_classes: int, device="cuda"):
    from viscoin_tpu_torch.models.bundle import init_models

    return init_models(Classifier(**dict(CLASSIFIER, output_classes=n_classes), device=device),
                       0)


class TinyDetector(torch.nn.Module):
    """A FID detector small enough for the CPU: 2x2 average pools, 12 features."""

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, 2).flatten(1)


@pytest.fixture
def toy_cli(tmp_path, monkeypatch):
    monkeypatch.setattr(cli_train, "build_classifier", toy_classifier)
    monkeypatch.setattr(cli_train, "build_viscoin_modules", toy_modules)
    monkeypatch.setattr(cli_train, "build_gan_modules", toy_gan_modules)
    monkeypatch.setenv("VISCOIN_SYNTH_N", "8")
    monkeypatch.setenv("VISCOIN_SYNTH_SIZE", "32")
    monkeypatch.chdir(tmp_path)
    torch.jit.trace(TinyDetector(), torch.zeros(1, 3, 8, 8)).save("tiny.pt")
    return tmp_path


def _records(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_then_test_classifier_then_train_viscoin(toy_cli, capsys):
    """`train classifier` (2 epochs) writes the best epoch's variables;
    `test classifier --checkpoints` reports that epoch's accuracy; `train
    viscoin` reads them from the default path (no RANDOM-classifier
    warning) and its eval carries a finite fid_score from --fid-detector."""
    out = "checkpoints/synthetic/classifier-synthetic"
    assert main(["train", "classifier", "--device", "cpu", "--dataset", "synthetic", "--epochs",
                 "2", "--batch-size", "4", "--compute-dtype", "float32", "--output-weights",
                 out]) == 0
    recs = _records("classifier_2.jsonl")
    assert len(recs) == 2 and set(recs[0]) == {"train_loss", "train_accuracy", "test_loss",
                                               "test_accuracy"}
    assert all(np.isfinite(v) for r in recs for v in r.values())
    best = max(r["test_accuracy"] for r in recs)
    capsys.readouterr()
    assert main(["test", "classifier", "--device", "cpu", "--dataset", "synthetic",
                 "--batch-size", "4", "--checkpoints", out]) == 0
    assert f"Accuracy: {100 * best:.2f}%" in capsys.readouterr().out
    assert main(["train", "viscoin", "--device", "cpu", "--dataset", "synthetic", "--epochs",
                 "1", "--batch-size", "2", "--eval-every", "1", "--checkpoint-every", "0",
                 "--faithfulness-every", "0", "--fid-detector", "tiny.pt"]) == 0
    log = capsys.readouterr().out
    assert "RANDOM classifier" not in log and "NVlabs TorchScript detector" in log
    rec = [r for r in _records("viscoin_1.jsonl") if "test_fid_score" in r]
    assert rec and np.isfinite(rec[0]["test_fid_score"])


def test_train_gan_fid_every(toy_cli, monkeypatch, capsys):
    """`train gan --fid-every 1 --fid-samples 8`, 2 iterations at 16²: one
    FID record (i = 1), finite, equal to a recomputation from the exported
    EMA generator with the same draws (batch j of iteration 1 seeded
    fold_seed(fold_seed(0, FID_TAG, 1), j)) against the same 8 reals."""
    monkeypatch.setenv("VISCOIN_SYNTH_SIZE", "16")
    assert main(["train", "gan", "--device", "cpu", "--dataset", "synthetic", "--batch-size", "4",
                 "--compute-dtype", "float32", "--epochs", "2", "--fid-every", "1",
                 "--fid-samples", "8", "--fid-detector", "tiny.pt", "--output-weights",
                 "gan"]) == 0
    assert "FID every 1 it: 8 real samples" in capsys.readouterr().out
    fids = [r for r in _records("gan_2.jsonl") if "fid" in r]
    assert [r["iteration"] for r in fids] == [1] and np.isfinite(fids[0]["fid"])

    g, _ = toy_gan_modules(16, 16384, 512, 4, device="cpu")
    load_jax_tree(g, {k: v for k, v in ckpt.restore_pytree("gan").items()})
    detect = make_torchscript_fid_detector("tiny.pt", device="cpu")
    fake_fn, real_fn = tgan.make_gan_fid_fns(4)
    train_ds, _ = get_datasets("synthetic", "gan", train_only=True)
    real = tgan.accumulate_real_fid_stats(detect, real_fn, train_ds, 4, 8, device="cpu")
    fake = tgan.accumulate_fake_fid_stats(detect, fake_fn, g.eval(),
                                          fold_seed(0, cli_train._FID_TAG, 1), 8)
    assert abs(fid_from_stats(real, fake) - fids[0]["fid"]) <= 1e-6 * abs(fids[0]["fid"])


def test_new_commands_raise_without_a_card(monkeypatch):
    """`train classifier` and `test classifier` run on the card unless given
    --device cpu, and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["train", "classifier", "--dataset", "synthetic"],
                 ["test", "classifier", "--dataset", "synthetic"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)


def test_concept_pooling_made_in_inference_mode_enters_autograd():
    """The cached pooling matrices are made outside inference mode: serving
    (inference_mode) first, then a training step's backward through them."""
    from viscoin_tpu_torch.models import concept_extractor as ce

    ce._POOL_MATRICES.clear()
    x = torch.randn(1, 2, 6, 6)
    with torch.inference_mode():
        adaptive_avg_pool(x, 3)
    w = torch.ones(2, requires_grad=True)
    adaptive_avg_pool(x * w[:, None, None], 3).sum().backward()
    assert w.grad is not None and torch.isfinite(w.grad).all()
