"""Concept2CLIP in the PyTorch port against the JAX package on the CPU:

  * both adapters at their real widths (2304 -> 1408 -> 1408 -> 512 and
    7168 -> 3840 -> 3840 -> 512) within 1e-5 of the output's scale;
  * ``cosine_matching`` by value (ties count), ``TensorLoader``'s batches,
    and two epochs of ``train_concept2clip`` with a ragged test tail: the
    logged losses, the matching accuracy and the best parameters within
    1e-5;
  * ``LabeledCUB``'s captions and items on a CUB layout written here, and
    the caption list;
  * the four converters (OpenAI and HF CLIP at toy widths and depths, the
    Concept2CLIP converter and exporter) bit-equal to JAX's, and the
    commands ``port-weights clip`` and ``export-concept2clip``;
  * ``train concept2clip --device cpu`` on a bundle the JAX package wrote,
    for both latent types (the CLIP caches written beforehand under the
    JAX package's names, so the full-width tower does not run here), then
    ``logs`` on its jsonl, and the refusal of a group of several processes.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_data import _cub_layout
from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from torch_port_helpers import bundle_pair, perturb, save_jax_bundle
from viscoin_tpu.captions import cub as jcub
from viscoin_tpu.data import datasets as JD
from viscoin_tpu.eval import concept2clip as JE
from viscoin_tpu.models import clip as JC
from viscoin_tpu.models import concept2clip as JM
from viscoin_tpu.train import concept2clip as JT
from viscoin_tpu.utils import exporting as jexp
from viscoin_tpu.utils import logging as jlog
from viscoin_tpu.utils import metrics as jmetrics
from viscoin_tpu.utils import porting as jport
from viscoin_tpu_torch.__main__ import main
from viscoin_tpu_torch.captions import cub as tcub
from viscoin_tpu_torch.cli import port_weights as pw
from viscoin_tpu_torch.data import datasets as TD
from viscoin_tpu_torch.eval import concept2clip as TE
from viscoin_tpu_torch.models.bundle import init_models
from viscoin_tpu_torch.models import concept2clip as TM
from viscoin_tpu_torch.train import concept2clip as TT
from viscoin_tpu_torch.utils import checkpoints as ckpt
from viscoin_tpu_torch.utils import exporting, porting
from viscoin_tpu_torch.utils import logging as tlog
from viscoin_tpu_torch.utils.metrics import cosine_matching
from viscoin_tpu_torch.utils.weights import load_jax_tree, module_to_jax_tree

TOL = 1e-5
# CLIP's ViT-B/32 dims -> toy dims (image width 128, text width and
# embedding 64, vocabulary 560, context 16, patch 8 on a 4 x 4 grid).
TOY_DIMS = {768: 128, 3072: 512, 2304: 384, 512: 64, 2048: 256, 1536: 192, 49408: 560,
            77: 16, 50: 17, 32: 8}
TOY_DEPTH = 2


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def assert_trees_equal(a, b):
    a, b = leaves(a), leaves(b)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# --------------------------------- the adapters ----------------------------- #


@pytest.mark.parametrize("variant", ["concepts", "w+"])
def test_adapters_match_jax_at_full_width(variant):
    rng = np.random.default_rng(0)
    if variant == "concepts":
        jm, tm = JM.Concept2CLIP(), TM.Concept2CLIP(device="cpu")
        x = rng.standard_normal((4, 3, 3, 256)).astype(np.float32)  # NHWC, as JAX's
        widths = (2304, 1408, 512)
    else:
        jm, tm = JM.Concept2CLIPStyleGAN(), TM.Concept2CLIPStyleGAN(device="cpu")
        x = rng.standard_normal((4, 14, 512)).astype(np.float32)
        widths = (7168, 3840, 512)
    # The port's seeded init, perturbed (JAX's initialiser is not compiled).
    params = perturb(module_to_jax_tree(init_models(tm, 0))["params"], 1)
    assert params["fc0"]["kernel"].shape == widths[:2]
    assert params["fc2"]["kernel"].shape == widths[1:]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    load_jax_tree(tm, {"params": params})
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        if variant == "concepts":  # (B, 9K) in the reference's concept-major order
            flat = torch.from_numpy(x).permute(0, 3, 1, 2).reshape(4, -1)
            np.testing.assert_array_equal(tm(flat), got)
    assert got.shape == (4, 512) and rel(got, want) <= TOL


# ------------------------- metric, loader, trainer ------------------------- #


@pytest.mark.parametrize("case", ["random", "ties", "duplicate rows", "zero rows"])
def test_cosine_matching_matches_jax(case):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((12, 16)).astype(np.float32)
    b = a + 0.8 * rng.standard_normal(a.shape).astype(np.float32)
    if case == "ties":  # rows 0-3 of b alike: each of their sims ties with the others'
        b[:4] = b[0]
        a[:4] = b[0]
    elif case == "duplicate rows":
        b[5] = b[6]
    elif case == "zero rows":
        a[2] = 0.0
        b[3] = 0.0
    want = jmetrics.cosine_matching(jnp.asarray(a), jnp.asarray(b))
    got = cosine_matching(torch.from_numpy(a), torch.from_numpy(b))
    assert isinstance(got, float) and got == want
    if case == "ties":  # by value: a first-index argmax would miss rows 1-3
        sims = a / np.linalg.norm(a, axis=1, keepdims=True) @ (
            b / np.linalg.norm(b, axis=1, keepdims=True)).T
        assert (np.argmax(sims[:4], axis=1) != np.arange(4)).any()
        assert got >= 4 / 12


def test_tensor_loader_matches_jax():
    x = np.arange(23 * 2, dtype=np.float32).reshape(23, 2)
    y = -x
    for shuffle in (True, False):
        t = TE.TensorLoader(x, y, 8, shuffle=shuffle, seed=5)
        j = JE.TensorLoader(x, y, 8, shuffle=shuffle, seed=5)
        assert len(t) == len(j) == 3
        for _ in range(3):  # one stream over the iterations
            tb, jb = list(t), list(j)
            assert [len(b[0]) for b in tb] == [8, 8, 7]
            for (tx, ty), (jx, jy) in zip(tb, jb, strict=True):
                np.testing.assert_array_equal(tx, jx)
                np.testing.assert_array_equal(ty, jy)


def _records(path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_concept2clip_matches_jax(tmp_path, capsys):
    """Two epochs from the same initial weights: 40 training rows at batch 8,
    13 test rows (a ragged last batch), the per-epoch records, the best
    test loss and its parameters."""
    rng = np.random.default_rng(2)
    tr_s, te_s = (rng.standard_normal((n, 3, 3, 8)).astype(np.float32) for n in (40, 13))
    tr_e, te_e = (rng.standard_normal((n, 512)).astype(np.float32) for n in (40, 13))
    jm = JM.Concept2CLIP(n_concepts=8)
    init = perturb(module_to_jax_tree(init_models(TM.Concept2CLIP(n_concepts=8, device="cpu"),
                                                  0))["params"], 3)
    cfg = dict(epochs=2, learning_rate=1e-4, batch_size=8)
    jlog.configure_score_logging(str(tmp_path / "jax.jsonl"))
    want, want_loss = JT.train_concept2clip(jm, init, tr_s, tr_e, te_s, te_e,
                                            JT.Concept2ClipTrainingParams(**cfg), seed=4)
    assert "Best test loss" in capsys.readouterr().out
    tlog.configure_score_logging(str(tmp_path / "port.jsonl"))
    tm = load_jax_tree(TM.Concept2CLIP(n_concepts=8, device="cpu"), {"params": init})
    got, got_loss = TT.train_concept2clip(tm, tr_s, tr_e, te_s, te_e,
                                          TT.Concept2ClipTrainingParams(**cfg), seed=4)
    assert "Best test loss" in capsys.readouterr().out
    assert got_loss == pytest.approx(want_loss, rel=TOL)
    recs, jrecs = _records(tmp_path / "port.jsonl"), _records(tmp_path / "jax.jsonl")
    assert len(recs) == len(jrecs) == 2
    for r, j in zip(recs, jrecs):
        assert set(r) == set(j) == {"train_loss", "test_loss", "matching_accuracy"}
        for k in r:
            assert r[k] == pytest.approx(j[k], rel=TOL, abs=TOL), k
    assert recs[0]["train_loss"] != recs[1]["train_loss"]
    got, want = leaves(got), leaves(want)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == np.float32
        assert rel(got[k], want[k]) <= TOL, k
    moved = max(rel(got[k], leaves(init)[k]) for k in got)
    assert moved > 100 * TOL, moved  # the comparison sees the training


# ------------------------------- data, captions ----------------------------- #


def _labeled_layout(root, n=6):
    _cub_layout(root, n)
    os.makedirs(os.path.join(root, "attributes"))
    with open(os.path.join(root, "classes.txt"), "w") as f:
        f.write("1 001.Black_footed_Albatross\n2 002.Laysan_Albatross\n3 003.Sooty_Albatross\n")
    names = ["has_bill_shape::curved_(up_or_down)", "has_wing_color::blue",
             "has_upperparts_color::brown", "has_tail_shape::notched_tail",
             "has_size::small_(5_-_9_in)"]
    with open(os.path.join(root, "attributes", "attributes.txt"), "w") as f:
        f.write("".join(f"{i} {a}\n" for i, a in enumerate(names, start=1)))
    rows = []
    for img in range(1, n + 1):  # image 1 has none present, image 2 one, ...
        for attr in range(1, len(names) + 1):
            rows.append(f"{img} {attr} {int(attr < img)} 3 {1.5 * attr:.1f}")
    with open(os.path.join(root, "attributes", "image_attribute_labels_clean.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")


def test_labeled_cub_captions_match_jax(tmp_path):
    root = str(tmp_path / "cub")
    _labeled_layout(root)
    for mode in ("train", "test"):
        for per_label in (3, 1):
            t = TD.LabeledCUB(attributes_per_label=per_label, mode=mode, root=root, seed=7)
            j = JD.LabeledCUB(attributes_per_label=per_label, mode=mode, root=root, seed=7)
            assert [a.tolist() for a in t.attributes] == [a.tolist() for a in j.attributes]
            for epoch in (0, 1, 2):
                t.set_epoch(epoch)
                j.set_epoch(epoch)
                for i in range(len(t)):
                    assert t.get_caption(i) == j.get_caption(i)
            ti, tl, tc = t[1]
            ji, jl, jc = j[1]
            np.testing.assert_array_equal(ti, ji)
            assert (tl, tc) == (jl, jc)
    caption = TD.LabeledCUB(mode="train", root=root).get_caption(2)
    assert caption.startswith("A picture of a ") and "with " in caption


def test_captions_match_jax():
    assert tcub.generate() == jcub.generate()
    assert tcub.load() == jcub.load() == tcub.generate()
    assert len(tcub.load()) == 944


# ------------------------------ the converters ------------------------------ #


def toy_clip_sd(kind: str, seed: int = 0) -> dict[str, np.ndarray]:
    """A random CLIP state_dict with the manifest's keys (blocks below
    TOY_DEPTH) at toy widths."""
    rng = np.random.default_rng(seed)
    man = porting.load_manifest(kind)
    out = {}
    for part in ("required", "optional"):
        for k, shape in man[part].items():
            m = re.search(r"\.(?:resblocks|layers)\.(\d+)\.", k)
            if (m and int(m.group(1)) >= TOY_DEPTH) or not shape:
                continue
            out[k] = rng.standard_normal([TOY_DIMS.get(d, d) for d in shape],
                                         dtype=np.float32)
    return out


@pytest.mark.parametrize("kind", ["clip_openai", "clip_hf"])
def test_clip_converters_match_jax(kind):
    sd = toy_clip_sd(kind)
    convert, jconvert = {"clip_openai": (porting.convert_torch_clip, jport.convert_torch_clip),
                         "clip_hf": (porting.convert_hf_clip, jport.convert_hf_clip)}[kind]
    got = convert(sd, TOY_DEPTH, TOY_DEPTH)
    assert_trees_equal(got, jconvert(sd, TOY_DEPTH, TOY_DEPTH))
    assert porting.clip_manifest_kind(sd) == kind
    assert pw.clip_depths(sd) == (TOY_DEPTH, TOY_DEPTH)
    clip = pw.clip_from_params(got, device="cpu")
    assert (clip.visual.layers, clip.text.layers, clip.image_size) == (2, 2, 32)
    # The manifest's full shapes (zero-stride arrays: nothing allocated) are clean.
    man = porting.load_manifest(kind)
    full = {k: np.broadcast_to(np.float32(0), s) for k, s in man["required"].items()}
    assert porting.validate_state_dict(full, kind) == []
    assert pw.check_source("clip", full, strict=True) == []
    assert porting.validate_state_dict(sd, kind, strict=False)  # the toy is not


def test_concept2clip_converter_and_exporter_match_jax():
    rng = np.random.default_rng(3)
    sd = {f"model.{i}.{n}": rng.standard_normal(s, dtype=np.float32)
          for i, (o, k) in zip((0, 2, 4), ((40, 72), (40, 40), (16, 40)))
          for n, s in (("weight", (o, k)), ("bias", (o,)))}
    params = porting.convert_torch_concept2clip(sd)
    assert_trees_equal(params, jport.convert_torch_concept2clip(sd))
    back = exporting.export_concept2clip_torch(params)
    assert_trees_equal(back, jexp.export_concept2clip_torch(params))
    assert_trees_equal(back, sd)


@pytest.mark.parametrize("kind", ["clip_openai", "clip_hf"])
def test_port_weights_clip(kind, tmp_path, monkeypatch, capsys):
    """The command picks the layout, checks it against its manifest, loads
    it into a CLIP on the CPU and writes the conversion; ``--check`` exits 1
    on the toy source (not the manifest's shapes) and ``--strict`` stops
    before writing."""
    monkeypatch.chdir(tmp_path)
    sd = toy_clip_sd(kind, seed=1)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, "src.pt")
    assert main(["port-weights", "clip", "src.pt", "out", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"manifest check [{kind}]: missing required key" in out and "ported clip" in out
    jconvert = jport.convert_hf_clip if kind == "clip_hf" else jport.convert_torch_clip
    assert_trees_equal(ckpt.restore_pytree("out"), jconvert(sd, TOY_DEPTH, TOY_DEPTH))
    with pytest.raises(SystemExit) as done:
        main(["port-weights", "clip", "src.pt", "--check", "--device", "cpu"])
    assert done.value.code == 1
    with pytest.raises(SystemExit):
        main(["port-weights", "clip", "src.pt", "strict", "--strict", "--device", "cpu"])
    assert not os.path.exists("strict")


def test_export_concept2clip_command(tmp_path, monkeypatch):
    """A checkpoint of ``train concept2clip`` out to the reference naming
    (``torch.save``), and converted back bit-equal."""
    monkeypatch.chdir(tmp_path)
    tm = init_models(TM.Concept2CLIPStyleGAN(n_style_layers=2, layer_dim=16, clip_dim=8,
                                             device="cpu"), 1)
    params = module_to_jax_tree(tm)["params"]
    ckpt.save_pytree(params, "c2c")
    assert main(["port-weights", "export-concept2clip", "c2c", "c2c.pth", "--device",
                 "cpu"]) == 0
    sd = {k: v.numpy() for k, v in torch.load("c2c.pth", weights_only=True).items()}
    assert_trees_equal(sd, jexp.export_concept2clip_torch(params))
    assert_trees_equal(jport.convert_torch_concept2clip(sd), params)


# ------------------------------- the command -------------------------------- #


@pytest.fixture(scope="module")
def jax_bundle_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("c2c")
    save_jax_bundle(bundle_pair(seed=9, img=32, n_classes=10)[0],
                    str(root / "checkpoints" / "synthetic" / "viscoin-synthetic"))
    return root


def test_train_concept2clip_command(jax_bundle_dir, monkeypatch, capsys):
    """Both latent types on the JAX-written bundle (8 + 8 images at 32²):
    the jsonl's keys and finite values, the checkpoint's MLP widths, the
    best parameters reloading into the adapter; then ``logs`` draws the
    jsonl."""
    monkeypatch.chdir(jax_bundle_dir)
    monkeypatch.setenv("VISCOIN_SYNTH_N", "8")
    monkeypatch.setenv("VISCOIN_SYNTH_SIZE", "32")
    rng = np.random.default_rng(6)
    os.makedirs("checkpoints/clip")
    for split in ("train", "test"):  # the CLIP pass's cache, under JAX's name
        np.savez(JC._img_cache(split, "synthetic", "ViT-B/32"),
                 emb=rng.standard_normal((8, 512)).astype(np.float32))
    widths = {"viscoin": 9 * 8, "gan": 8 * 32}  # 9K concepts; num_ws x w_dim at 32²
    for latent in ("viscoin", "gan"):
        assert main(["train", "concept2clip", "--device", "cpu", "--dataset", "synthetic",
                     "--epochs", "2", "--batch-size", "4", "--latent-type", latent,
                     "--output-weights", f"c2c-{latent}"]) == 0
        assert "Best test loss" in capsys.readouterr().out
        recs = _records("concept2clip_2.jsonl")
        assert len(recs) == 2
        for r in recs:
            assert set(r) == {"train_loss", "test_loss", "matching_accuracy"}
            assert all(np.isfinite(v) for v in r.values())
        params = ckpt.restore_pytree(f"c2c-{latent}")
        assert params["fc0"]["kernel"].shape == (widths[latent], (widths[latent] + 512) // 2)
        pw.concept2clip_from_params(params, device="cpu")
    assert os.path.exists("checkpoints/concepts/synthetic_32.npz")
    assert os.path.exists("checkpoints/gan-w/synthetic_32.npz")
    assert main(["logs", "--logs-path", "concept2clip_2.jsonl", "--outdir", "figs"]) == 0
    assert os.listdir("figs") == ["training_curves.png"]


def test_train_concept2clip_refuses_several_processes(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="single-process.*group of 2 processes"):
        main(["train", "concept2clip", "--device", "cpu", "--dataset", "synthetic"])
    with pytest.raises(ValueError, match="group of 2 processes"):
        TT.train_concept2clip(None, None, None, None, None, TT.Concept2ClipTrainingParams(),
                              mesh=type("Mesh", (), {"world": 2})())


def test_entry_points_default_to_cuda(monkeypatch):
    """The new modules and the command's function are built on the card
    unless told otherwise, and the command raises without a card before
    reading anything."""
    import inspect

    from viscoin_tpu_torch.cli.train import _train_concept2clip
    from viscoin_tpu_torch.models.clip import CLIP

    for fn in (CLIP, TM.Concept2CLIP, TM.Concept2CLIPStyleGAN, _train_concept2clip,
               pw.clip_from_params, pw.concept2clip_from_params):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _train_concept2clip("viscoin", "synthetic", 1, None, None, "out")
