"""The port's analysis modules against the JAX package's, on the CPU:
``eval/concepts.py::test_concepts``, ``eval/spaces.py`` (Phi and W+ over a
dataset, and their caches), the ``FunnyBirds`` dataset, the ``logs``
command's reader, ``utils/maths.py``, ``utils/images.py`` and the result
records of ``utils/types.py``. The toy bundle of
``tests/test_cli_analytics.py`` (32², 10 classes, 8 concepts) with perturbed
variables, the same in both packages."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from torch_port_helpers import NK, bundle_pair, images
from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from viscoin_tpu.cli import logs as JL
from viscoin_tpu.data import datasets as JD
from viscoin_tpu.data.loader import DataLoader as JLoader
from viscoin_tpu.eval import concepts as JC
from viscoin_tpu.eval import spaces as JS
from viscoin_tpu.utils import images as JI
from viscoin_tpu.utils import maths as JM
from viscoin_tpu.utils import types as JT
from viscoin_tpu_torch.cli import logs as TL
from viscoin_tpu_torch.data import datasets as TD
from viscoin_tpu_torch.data import utils as TU
from viscoin_tpu_torch.data.loader import DataLoader
from viscoin_tpu_torch.eval import concepts as TC
from viscoin_tpu_torch.eval import spaces as TS
from viscoin_tpu_torch.utils import images as TI
from viscoin_tpu_torch.utils import maths as TM
from viscoin_tpu_torch.utils import types as TT

IMG, NC = 32, 10


@pytest.fixture(scope="module")
def pair():
    return bundle_pair(seed=5, img=IMG, n_classes=NC)


def _close_to_scale(got, want, rel: float, err_msg: str = ""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-30), err_msg=err_msg)


def test_test_concepts_matches_jax(pair):
    """7 test images in batches of 4 (the last padded and masked): every
    field within 1e-5 relative, the accuracies equal."""
    jm, tm = pair
    jl = JLoader(JD.SyntheticDataset(n=7, n_classes=NC, image_size=IMG, mode="test"), 4,
                 shuffle=False, num_threads=0)
    tl = DataLoader(TD.SyntheticDataset(n=7, n_classes=NC, image_size=IMG, mode="test"), 4,
                    shuffle=False, num_threads=0)
    want = JC.test_concepts(jm, jl, NC)
    got = TC.test_concepts(tm, tl, NC)
    fields = [f.name for f in dataclasses.fields(JC.ConceptTestResults)]
    assert [f.name for f in dataclasses.fields(TC.ConceptTestResults)] == fields
    assert got.classifier_accuracy == want.classifier_accuracy
    assert got.explainer_accuracy == want.explainer_accuracy
    for name in fields[2:]:
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape, name
        _close_to_scale(g, w, 1e-5, name)
    assert got.class_counts.sum() == 7 and got.concept_correlations.shape == (NK, NK)
    assert got.class_concept_correlations.shape == (NC, NK)


def test_spaces_match_jax_and_share_the_caches(pair, tmp_path, monkeypatch):
    """Phi (NHWC) and W+ over 5 train and 3 test images in batches of 4,
    within 1e-5 of their scale; the caches have JAX's names and keys and
    each package reads the other's; the W+ pass never runs the synthesis."""
    jm, tm = pair
    kw = dict(n_classes=NC, image_size=IMG, transform="test")
    jtrain, jtest = (JD.SyntheticDataset(n=n, mode=m, **kw) for n, m in ((5, "train"), (3, "test")))
    ttrain, ttest = (TD.SyntheticDataset(n=n, mode=m, **kw) for n, m in ((5, "train"), (3, "test")))

    def no_synthesis(*args, **kw):
        raise AssertionError("the W+ pass ran the synthesis")

    monkeypatch.setattr(tm.gan.synthesis, "forward", no_synthesis)
    for fn, sub, shape in (("compute_concept_space", "concepts", (3, 3, NK)),
                           ("compute_w_space", "gan-w", (tm.gan.num_ws, 32))):
        jdir, tdir = str(tmp_path / "jax" / sub), str(tmp_path / "port" / sub)
        want = getattr(JS, fn)(jm, "synthetic", jtrain, jtest, batch_size=4, cache_dir=jdir)
        got = getattr(TS, fn)(tm, "synthetic", ttrain, ttest, batch_size=4, cache_dir=tdir)
        for g, w, n in zip(got, want, (5, 3)):
            assert g.shape == w.shape == (n, *shape) and g.dtype == np.float32, fn
            _close_to_scale(g, w, 1e-5, fn)
        name = f"synthetic_{IMG}.npz"
        assert os.listdir(jdir) == os.listdir(tdir) == [name]
        with np.load(os.path.join(tdir, name)) as data:
            assert sorted(data.files) == ["test", "train"]
        for a, b in zip(getattr(TS, fn)(tm, "synthetic", ttrain, ttest, cache_dir=jdir), want):
            np.testing.assert_array_equal(a, b)  # the port reads JAX's cache
        for a, b in zip(getattr(JS, fn)(jm, "synthetic", jtrain, jtest, cache_dir=tdir), got):
            np.testing.assert_array_equal(a, b)  # and JAX the port's


def _fabricate_funnybirds(root) -> None:
    from PIL import Image

    rng = np.random.default_rng(0)
    for mode, classes in (("train", ("0", "3", "12")), ("test", ("0", "12"))):
        for cls in classes:
            os.makedirs(root / "FunnyBirds" / mode / cls)
            for j in range(2):
                size = (40 + 3 * j, 36 + int(cls))
                Image.fromarray(rng.integers(0, 256, (*size, 3), dtype=np.uint8)).save(
                    root / "FunnyBirds" / mode / cls / f"img{j}.png")


def test_funnybirds_matches_jax(tmp_path, monkeypatch):
    """A fabricated FunnyBirds folder: the same images (after each split's
    transform) and labels as JAX's class; `funnybirds` loads through the
    registry."""
    _fabricate_funnybirds(tmp_path)
    root = str(tmp_path / "FunnyBirds")
    for mode in ("train", "test"):
        want = JD.FunnyBirds(mode, root=root)
        got = TD.FunnyBirds(mode, root=root)
        assert len(got) == len(want) == (6 if mode == "train" else 4)
        assert got.labels == want.labels and got.N_CLASSES == want.N_CLASSES == 50
        for i in range(len(want)):
            g, w = got[i], want[i]
            assert g[1] == w[1]
            np.testing.assert_array_equal(g[0], w[0])
            assert g[0].shape == (256, 256, 3)
    monkeypatch.setenv("VISCOIN_DATA_DIR", str(tmp_path))
    train, test = TU.get_datasets("funnybirds")
    assert isinstance(train, TD.FunnyBirds) and (len(train), len(test)) == (6, 4)


def test_logs_reader_matches_jax(tmp_path):
    """Blank lines skipped, a truncated last line dropped, a bad line
    elsewhere raises with its number; the records equal JAX's reader's."""
    recs = [{"train_acc_loss": 1.0, "test_acc_loss": 2.0}, {"g_loss": 0.5, "iteration": 100}]
    path = tmp_path / "run.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\n\n" + '{"g_loss": 0.')
    assert TL.read_records(str(path)) == JL._read_records(str(path)) == recs
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps(recs[0]) + "\n{oops\n" + json.dumps(recs[1]) + "\n")
    for read in (TL.read_records, JL._read_records):
        with pytest.raises(ValueError, match="bad.jsonl:2"):
            read(str(bad))


def test_result_records_match_jax():
    """The jsonl schema: TrainingResults' and TestingResults' fields."""
    for t, j in ((TT.TrainingResults, JT.TrainingResults), (TT.TestingResults, JT.TestingResults)):
        assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]


def test_maths_and_images_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 5)).astype(np.float32)
    x[2] = 1.5  # a constant row goes to 0
    for axis in (None, 0, 1):
        np.testing.assert_array_equal(TM.normalize(x, axis), JM.normalize(x, axis))
    u8 = images(2, size=8, seed=4)
    f = rng.uniform(-0.5, 2.0, (2, 8, 8, 3)).astype(np.float32)
    for a in (u8, f):
        np.testing.assert_array_equal(TI.normalize_image(a), JI.normalize_image(a))
        np.testing.assert_array_equal(TI.clip_image(a), JI.clip_image(a))
    # from_torch takes NCHW (tensor or array) and NHWC; a batch of one drops its dim.
    nchw = torch.from_numpy(np.ascontiguousarray(f.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(TI.from_torch(nchw), JI.from_jax(f), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(TI.from_torch(f), JI.from_jax(f))
    np.testing.assert_allclose(TI.from_torch(nchw[1]), JI.from_jax(f[1]), rtol=0, atol=1e-7)
    assert TI.from_torch(nchw[:1]).shape == (8, 8, 3)
    heat = rng.uniform(0, 1, (4, 4)).astype(np.float32)
    np.testing.assert_array_equal(TI.heatmap_to_img(heat, size=16), JI.heatmap_to_img(heat, 16))
    over = TI.heatmap_to_img(heat, size=8)
    np.testing.assert_array_equal(TI.overlay(u8[0], over), JI.overlay(u8[0], over))
    with pytest.raises(ValueError, match="same dtype"):
        TI.overlay(u8[0], over.astype(np.float32))
