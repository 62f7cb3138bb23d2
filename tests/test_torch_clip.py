"""CLIP in the PyTorch port (``viscoin_tpu_torch/models/clip.py``) against
the JAX package's (``viscoin_tpu/models/clip.py``) on the CPU, at toy widths
(towers of width 64, 2 layers, 4 heads; patch 8 on 32² inputs; a vocabulary
of 560 and a context of 16), with the same perturbed variables:

  * each tower and ``CLIP`` within 1e-5 of the output's scale; the port's
    ViT-B/32 parameter tree against ``jax.eval_shape`` of JAX's
    ``CLIP().init`` (names and shapes, nothing compiled);
  * ``clip_preprocess_u8`` 256² -> 224² within 1e-5, ``clip_preprocess_pil``
    bit-equal;
  * the tokenizer token for token on all 944 captions, with a merges file
    written here (the real vocabulary is not in the repository);
  * the image and text embedding passes (both preprocessings, the padded
    last batch) within 1e-5, each package reading the other's caches.
"""

import gzip

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from torch_port_helpers import perturb, run_once
from viscoin_tpu.captions import cub as jcub
from viscoin_tpu.models import clip as J
from viscoin_tpu_torch.data.datasets import SyntheticDataset
from viscoin_tpu_torch.models import clip as T
from viscoin_tpu_torch.models.bundle import init_models
from viscoin_tpu_torch.utils import checkpoints as ckpt
from viscoin_tpu_torch.utils import weights
from viscoin_tpu_torch.utils.weights import load_jax_tree

VISION = dict(width=64, layers=2, heads=4, patch_size=8)
# 560 ids hold the tokenizer's 512 byte tokens, the merges below and the two markers.
TEXT = dict(vocab_size=560, context_length=16, width=64, layers=2, heads=4)
IMG = 32
TOL = 1e-5  # of the output's scale
# A merges file of CLIP's format: a header line, then one merge per line.
MERGES = ["#version: 0.2", "o r", "a n", "i n", "e r", "r e", "b l", "bl a", "bla c",
          "blac k</w>", "w h", "wh i", "whi t", "whit e</w>", "g r", "e y</w>", "gr ey</w>",
          "t a", "ta i", "tai l</w>", "w in", "win g", "wing s</w>", "c o", "co l",
          "col or", "o r</w>", "e d</w>", "s h", "sh a", "p e", "pe d</w>"]


def toy_vision(**kw) -> T.CLIPVisionTransformer:
    return T.CLIPVisionTransformer(**{**VISION, "image_size": IMG, **kw}, device="cpu")


def toy_text() -> T.CLIPTextTransformer:
    return T.CLIPTextTransformer(**TEXT, device="cpu")


class JaxToyCLIP(J.CLIP):
    """The JAX package's CLIP wrapper around toy towers."""

    def setup(self):
        self.visual = J.CLIPVisionTransformer(**VISION)
        self.text = J.CLIPTextTransformer(**TEXT)


class JaxToyCLIP_224(J.CLIP):
    """Toy towers at 224² with patch 32 (the embedding passes' geometry)."""

    def setup(self):
        self.visual = J.CLIPVisionTransformer(**{**VISION, "patch_size": 32})
        self.text = J.CLIPTextTransformer(**TEXT)


def toy_clip(image_size: int = IMG) -> T.CLIP:
    return T.CLIP(image_width=64, image_layers=2, image_heads=4, patch_size=8,
                  image_size=image_size, vocab_size=560, context_length=16, text_width=64,
                  text_layers=2, text_heads=4, device="cpu")


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, IMG, IMG, 3)).astype(np.float32)
    tokens = rng.integers(1, 550, (3, 16)).astype(np.int32)
    tokens[:, 9:] = 0
    tokens[:, 8] = 559  # the end-of-text token: the largest id
    return x, tokens


@pytest.fixture(scope="module")
def jax_clip(inputs):
    """(perturbed toy params, JAX's image and text embeddings of the inputs);
    the port's seeded init, perturbed (JAX's initialiser is not compiled)."""
    x, tokens = jnp.asarray(inputs[0]), jnp.asarray(inputs[1])
    clip = JaxToyCLIP()
    params = jax.tree_util.tree_map(np.asarray, perturb(
        weights.module_to_jax_tree(init_models(toy_clip(), 0))["params"], 1))
    return params, [np.asarray(e) for e in run_once(lambda p: clip.apply({"params": p}, x,
                                                                         tokens), params)]


@pytest.mark.parametrize("part", ["visual", "text", "clip"])
def test_towers_and_clip_match_jax(part, inputs, jax_clip):
    """Each tower alone and CLIP's encoders against JAX's CLIP (whose
    encoders are its towers)."""
    x, tokens = inputs
    params, want = jax_clip
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    ids = torch.from_numpy(tokens).long()
    with torch.no_grad():
        if part == "visual":
            got = [load_jax_tree(toy_vision(), {"params": params["visual"]})(nchw)]
            want = want[:1]
        elif part == "text":
            got = [load_jax_tree(toy_text(), {"params": params["text"]})(ids)]
            want = want[1:]
        else:
            clip = load_jax_tree(toy_clip(), {"params": params})
            got = clip(nchw, ids)
            np.testing.assert_array_equal(clip.encode_image(nchw), got[0])
            np.testing.assert_array_equal(clip.encode_text(ids), got[1])
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        assert rel(g, w) <= TOL


def test_module_tree_round_trips(jax_clip):
    """module_to_jax_tree gives back the JAX tree the CLIP was loaded from
    (LayerNorm weights as ``scale``)."""
    params = jax_clip[0]
    back = weights.module_to_jax_tree(load_jax_tree(toy_clip(), {"params": params}))
    assert set(back) == {"params"}
    flat = jax.tree_util.tree_leaves_with_path(params)
    back_flat = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert len(flat) == len(back_flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(back_flat[path], leaf)


def test_vit_b32_tree_matches_jax_eval_shape():
    """The port's default CLIP() has the JAX CLIP's parameter names and
    shapes at ViT-B/32 (on the meta device, against jax.eval_shape: nothing
    is allocated or compiled)."""
    want = jax.eval_shape(lambda k: J.CLIP().init(k, jnp.zeros((1, 224, 224, 3)),
                                                  jnp.zeros((1, 77), jnp.int32)),
                          jax.random.PRNGKey(0))["params"]
    want = {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_leaves_with_path(want)}
    clip = T.CLIP(device="meta")
    owners = dict(clip.named_modules())
    got = {}
    for path, t in clip.named_parameters():
        parent, _, name = path.rpartition(".")
        collection, jname, view = weights._jax_leaf(owners[parent], name, t)
        assert collection == "params"
        key = "".join(f"['{p}']" for p in [*parent.split("."), jname] if p)
        got[key] = tuple(view.shape)
    assert got == want
    assert sum(t.numel() for t in clip.parameters()) == sum(np.prod(s) for s in want.values())


def test_clip_preprocess_u8_matches_jax():
    u8 = np.random.default_rng(1).integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    want = np.asarray(J.clip_preprocess_u8(jnp.asarray(u8)))
    got = T.clip_preprocess_u8(torch.from_numpy(u8))
    assert got.shape == (2, 3, 224, 224)
    assert rel(got.permute(0, 2, 3, 1), want) <= TOL


@pytest.mark.parametrize("size", [(300, 467), (471, 300), (224, 224), (40, 52)])
def test_clip_preprocess_pil_is_bit_equal(size):
    raw = np.random.default_rng(size[0]).integers(0, 256, (*size, 3), dtype=np.uint8)
    got = T.clip_preprocess_pil(raw)
    assert got.shape == (224, 224, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, J.clip_preprocess_pil(raw))


@pytest.fixture(scope="module")
def merges_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("bpe") / "merges.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(MERGES))
    return str(path)


@pytest.mark.parametrize("context", [77, 8])
def test_tokenizer_matches_jax_on_every_caption(merges_file, context):
    """Token for token on the 944 captions (and a few other strings), at
    CLIP's context and at one that cuts them."""
    texts = jcub.load() + ["A picture of a Black Tern, with grey wings.", "it's 2 colors!"]
    tok = T.SimpleTokenizer(merges_file, context_length=context)
    want = J.SimpleTokenizer(merges_file, context_length=context).tokenize(texts)
    got = tok.tokenize(texts)
    assert got.dtype == want.dtype and got.shape == (len(texts), context)
    np.testing.assert_array_equal(got, want)
    assert len(tok.encoder) == 512 + len(MERGES) - 1 + 2
    merged = {tok.encoder[m.replace(" ", "")] for m in MERGES[1:]}
    assert merged & set(got.ravel().tolist()), "no merge was applied"


@pytest.fixture(scope="module")
def params_224():
    clip = T.CLIP(image_width=64, image_layers=2, image_heads=4, patch_size=32,
                  vocab_size=560, context_length=16, text_width=64, text_layers=2,
                  text_heads=4, device="cpu")
    return jax.tree_util.tree_map(np.asarray, perturb(
        weights.module_to_jax_tree(init_models(clip, 2))["params"], 3))


class NoRawImages:
    """A dataset without ``raw_image``: the passes take the device path."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i]


@pytest.mark.parametrize("exact", [True, False], ids=["pil", "device"])
def test_embedding_passes_match_jax_and_share_caches(exact, params_224, merges_file, tmp_path,
                                                     monkeypatch):
    """Both packages' passes over the same 5 + 3 images (batch 4: the last
    batch padded) at 224², from the same toy weights (patch 32), within 1e-5;
    the caches one writes the other reads, under the same file names. Then
    the text pass over captions alike."""
    params = params_224
    kw = dict(n_classes=3, image_size=40, transform="test")
    train, test = SyntheticDataset(n=5, **kw), SyntheticDataset(n=3, mode="test", **kw)
    if not exact:
        train, test = NoRawImages(train), NoRawImages(test)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    clip = T.CLIP(image_width=64, image_layers=2, image_heads=4, patch_size=32,
                  vocab_size=560, context_length=16, text_width=64, text_layers=2,
                  text_heads=4, device="cpu")
    got = T.compute_image_embeddings(clip, "synthetic", train, test, params=params,
                                     batch_size=4)
    monkeypatch.chdir(tmp_path / "jax")
    jclip = JaxToyCLIP_224()
    want = J.compute_image_embeddings(jclip, "synthetic", train, test, params=params,
                                      batch_size=4)
    for g, w, n in zip(got, want, (5, 3)):
        assert g.shape == w.shape == (n, 512)
        assert rel(g, w) <= TOL
    # Each reads the other's cache (a different CLIP would give other numbers).
    other = init_models(T.CLIP(image_width=64, image_layers=1, image_heads=4, patch_size=32,
                               vocab_size=560, context_length=16, text_width=64,
                               text_layers=1, text_heads=4, device="cpu"), 5)
    for g, w in zip(T.compute_image_embeddings(other, "synthetic", train, test), want):
        np.testing.assert_array_equal(g, w)
    monkeypatch.chdir(tmp_path / "port")
    for g, w in zip(J.compute_image_embeddings(J.CLIP(), "synthetic", train, test), got):
        np.testing.assert_array_equal(g, w)
    if not exact:
        return
    captions = jcub.load()[:6]
    tok = T.SimpleTokenizer(merges_file, context_length=16)
    got = T.compute_text_embeddings(clip, captions, "synthetic", "cub", tok, params=params,
                                    batch_size=4)
    monkeypatch.chdir(tmp_path / "jax")
    want = J.compute_text_embeddings(jclip, captions, "synthetic", "cub",
                                     J.SimpleTokenizer(merges_file, context_length=16),
                                     params=params, batch_size=4)
    assert got.shape == want.shape == (6, 512) and rel(got, want) <= TOL
    np.testing.assert_array_equal(
        T.compute_text_embeddings(other, captions, "synthetic", "cub", tok), want)


def test_init_or_warn_reads_the_ported_checkpoint(jax_clip, tmp_path, monkeypatch, capsys):
    """No checkpoints/clip/vit-b-32: seeded from 0 with the warning; with
    one (port-weights' npz): its weights."""
    monkeypatch.chdir(tmp_path)
    seeded = T._init_or_warn(toy_clip())
    assert "WARNING: no CLIP weights at checkpoints/clip/vit-b-32" in capsys.readouterr().out
    again = init_models(toy_clip(), 0)
    for a, b in zip(seeded.state_dict().values(), again.state_dict().values()):
        np.testing.assert_array_equal(a, b)
    ckpt.save_pytree(jax_clip[0], T.CLIP_CHECKPOINT)
    loaded = T._init_or_warn(toy_clip())
    assert capsys.readouterr().out == ""
    np.testing.assert_array_equal(loaded.text.token_embedding.detach(),
                                  jax_clip[0]["text"]["token_embedding"])
