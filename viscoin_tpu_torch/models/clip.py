"""CLIP ViT-B/32 (image and text towers), its preprocessing, the embedding
passes with their disk caches, and the BPE tokenizer.

Counterpart of ``viscoin_tpu/models/clip.py``, with the same parameter tree
(``visual``: ``patch_embed``, ``class_embedding``, ``positional_embedding``,
``ln_pre``, ``block{i}``, ``ln_post``, ``proj``; ``text``:
``token_embedding``, ``positional_embedding``, ``block{i}``, ``ln_final``,
``text_projection``), so ``utils/weights.py::load_jax_tree`` carries the
JAX package's variables in and ``module_to_jax_tree`` takes them out.
Widths, depths, heads, patch, image size, vocabulary and context are
constructor arguments with the ViT-B/32 defaults: image tower width 768, 12
layers x 12 heads, patch 32 at 224²; text tower width 512, 12 layers x 8
heads, context 77, vocabulary 49408; 512-d embeddings.

The image tower takes NCHW; the attention is two matmuls and a softmax in
fp32, as the JAX code computes it. Pretrained OpenAI weights come in through
``python -m viscoin_tpu_torch port-weights clip`` (npz at
``checkpoints/clip/vit-b-32``); without them :func:`compute_image_embeddings`
uses seeded weights, with a warning, as the JAX package does. Text encoding needs the
BPE merges file ``bpe_simple_vocab_16e6.txt.gz`` (:class:`SimpleTokenizer`);
nothing is downloaded.

The embedding caches keep the JAX package's file names and npz keys
(``checkpoints/clip/ViT-B-32_{dataset}_img_{split}.npz``, ``..._txt_{key}.npz``,
array ``emb``), so either package reads what the other wrote.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from torch import nn

from viscoin_tpu_torch.models.inception import resize_bilinear
from viscoin_tpu_torch.models.resnet import lecun_normal_

CLIP_IMAGE_SIZE = 224
CLIP_EMBED_DIM = 512
# CLIP's image preprocessing constants (clip.load transform).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
CLIP_CHECKPOINT = "checkpoints/clip/vit-b-32"


def _dense(in_features: int, out_features: int, device) -> nn.Linear:
    return nn.Linear(in_features, out_features, device=device)


class MultiHeadAttention(nn.Module):
    def __init__(self, width: int, heads: int, device="cuda"):
        super().__init__()
        self.heads = heads
        self.in_proj = _dense(width, 3 * width, device)
        self.out_proj = _dense(width, width, device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        B, T, C = x.shape
        q, k, v = self.in_proj(x).float().chunk(3, dim=-1)

        def heads(t):
            return t.reshape(B, T, self.heads, C // self.heads).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        attn = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(C // self.heads))
        if mask is not None:
            attn = attn + mask
        out = torch.softmax(attn, dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(B, T, C).to(x.dtype))


class ResidualBlock(nn.Module):
    """Pre-LN transformer block (LayerNorm eps 1e-5, QuickGELU MLP)."""

    def __init__(self, width: int, heads: int, device="cuda"):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5, device=device)
        self.attn = MultiHeadAttention(width, heads, device)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5, device=device)
        self.mlp_fc = _dense(width, 4 * width, device)
        self.mlp_proj = _dense(4 * width, width, device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask)
        h = self.mlp_fc(self.ln_2(x))
        h = h * torch.sigmoid(1.702 * h)  # QuickGELU
        return x + self.mlp_proj(h)


def _init_transformer(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's initialisers: LeCun-normal Dense and conv kernels, zero
    biases, unit LayerNorm scales."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


class CLIPVisionTransformer(nn.Module):
    def __init__(self, width: int = 768, layers: int = 12, heads: int = 12,
                 patch_size: int = 32, image_size: int = CLIP_IMAGE_SIZE,
                 output_dim: int = CLIP_EMBED_DIM, device="cuda"):
        super().__init__()
        tokens = (image_size // patch_size) ** 2 + 1
        self.patch_embed = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False,
                                     device=device)
        self.class_embedding = nn.Parameter(torch.empty(width, device=device))
        self.positional_embedding = nn.Parameter(torch.empty(tokens, width, device=device))
        self.ln_pre = nn.LayerNorm(width, eps=1e-5, device=device)
        for i in range(layers):
            self.add_module(f"block{i}", ResidualBlock(width, heads, device))
        self.layers = layers
        self.ln_post = nn.LayerNorm(width, eps=1e-5, device=device)
        self.proj = nn.Parameter(torch.empty(width, output_dim, device=device))

    def init_weights(self, generator: torch.Generator):
        _init_transformer(self, generator)
        for p in (self.class_embedding, self.positional_embedding, self.proj):
            p.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 3, H, W) CLIP-normalised -> (B, output_dim)."""
        x = self.patch_embed(x).flatten(2).transpose(1, 2)  # (B, tokens - 1, W)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.ln_pre(x)
        for i in range(self.layers):
            x = getattr(self, f"block{i}")(x)
        return self.ln_post(x[:, 0]) @ self.proj


class CLIPTextTransformer(nn.Module):
    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 512,
                 layers: int = 12, heads: int = 8, output_dim: int = CLIP_EMBED_DIM,
                 device="cuda"):
        super().__init__()
        self.token_embedding = nn.Parameter(torch.empty(vocab_size, width, device=device))
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width,
                                                             device=device))
        for i in range(layers):
            self.add_module(f"block{i}", ResidualBlock(width, heads, device))
        self.layers = layers
        self.ln_final = nn.LayerNorm(width, eps=1e-5, device=device)
        self.text_projection = nn.Parameter(torch.empty(width, output_dim, device=device))

    def init_weights(self, generator: torch.Generator):
        _init_transformer(self, generator)
        self.token_embedding.normal_(0.0, 0.02, generator=generator)
        self.positional_embedding.normal_(0.0, 0.01, generator=generator)
        self.text_projection.normal_(0.0, 0.02, generator=generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, context) integers -> (B, output_dim); the embedding is
        the row of the end-of-text token, the largest id."""
        x = self.token_embedding[tokens] + self.positional_embedding
        T = tokens.shape[1]
        mask = torch.full((T, T), float("-inf"), device=x.device).triu(1)  # causal
        for i in range(self.layers):
            x = getattr(self, f"block{i}")(x, mask)
        x = self.ln_final(x)
        x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return x @ self.text_projection


class CLIP(nn.Module):
    """ViT-B/32 CLIP: ``encode_image`` (NCHW, CLIP-normalised) and
    ``encode_text`` (token ids)."""

    def __init__(self, kind: str = "ViT-B/32", embedding_size: int = CLIP_EMBED_DIM, *,
                 image_width: int = 768, image_layers: int = 12, image_heads: int = 12,
                 patch_size: int = 32, image_size: int = CLIP_IMAGE_SIZE,
                 vocab_size: int = 49408, context_length: int = 77, text_width: int = 512,
                 text_layers: int = 12, text_heads: int = 8, device="cuda"):
        super().__init__()
        self.kind = kind
        self.embedding_size = embedding_size
        self.image_size = image_size
        self.visual = CLIPVisionTransformer(image_width, image_layers, image_heads, patch_size,
                                            image_size, embedding_size, device)
        self.text = CLIPTextTransformer(vocab_size, context_length, text_width, text_layers,
                                        text_heads, embedding_size, device)

    def encode_image(self, x: torch.Tensor) -> torch.Tensor:
        return self.visual(x)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.text(tokens)

    def forward(self, images: torch.Tensor, tokens: torch.Tensor):
        return self.encode_image(images), self.encode_text(tokens)


# ------------------------------ preprocessing ------------------------------- #


def clip_preprocess_u8(images_u8: torch.Tensor, size: int = CLIP_IMAGE_SIZE) -> torch.Tensor:
    """uint8 NHWC batch on its device -> CLIP-normalised NCHW floats at
    ``size``²: ``jax.image.resize``'s bilinear (antialiased when shrinking),
    scaled to [0, 1]. The path for datasets without the original images;
    :func:`clip_preprocess_pil` is the exact one."""
    x = images_u8.permute(0, 3, 1, 2).float() / 255.0
    if x.shape[2:] != (size, size):
        x = resize_bilinear(x, size)
    mean = torch.tensor(CLIP_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(CLIP_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def clip_preprocess_pil(raw_u8: np.ndarray) -> np.ndarray:
    """``clip.load``'s preprocessing of one original image (H, W, 3) uint8:
    PIL bicubic short-side resize to 224 (the long side truncated, as
    torchvision's ``Resize``), centre crop 224 (origin ``int(round((n -
    224) / 2))``), [0, 1], CLIP-normalised. Returns (224, 224, 3) float32."""
    from PIL import Image

    img = Image.fromarray(raw_u8).convert("RGB")
    w, h = img.size
    short, long = min(w, h), max(w, h)
    new_long = int(CLIP_IMAGE_SIZE * long / short)
    nw, nh = (CLIP_IMAGE_SIZE, new_long) if w <= h else (new_long, CLIP_IMAGE_SIZE)
    img = img.resize((nw, nh), Image.BICUBIC)
    left = int(round((nw - CLIP_IMAGE_SIZE) / 2.0))
    top = int(round((nh - CLIP_IMAGE_SIZE) / 2.0))
    img = img.crop((left, top, left + CLIP_IMAGE_SIZE, top + CLIP_IMAGE_SIZE))
    x = np.asarray(img, np.float32) / 255.0
    return (x - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(CLIP_STD, np.float32)


# ------------------------- embedding passes, cached ------------------------- #


def _img_cache(mode: str, dataset: str, kind: str) -> str:
    from viscoin_tpu_torch.data.utils import dataset_key

    kind = kind.replace("/", "-")
    return f"checkpoints/clip/{kind}_{dataset_key(dataset)}_img_{mode}.npz"


def _txt_cache(key: str, dataset: str, kind: str) -> str:
    from viscoin_tpu_torch.data.utils import dataset_key

    kind = kind.replace("/", "-")
    return f"checkpoints/clip/{kind}_{dataset_key(dataset)}_txt_{key}.npz"


def _device(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def _padded(batch: np.ndarray, batch_size: int) -> np.ndarray:
    """A short last batch padded with copies of its first row, as the JAX
    package pads it (the padded rows are dropped after)."""
    if batch.shape[0] < batch_size:
        pad = batch_size - batch.shape[0]
        batch = np.concatenate([batch, np.repeat(batch[:1], pad, axis=0)])
    return batch


def compute_image_embeddings(clip: CLIP, dataset_name: str, train_ds, test_ds,
                             params: dict | None = None, batch_size: int = 32):
    """CLIP image embeddings of both splits, (train, test) float32 arrays
    (N, embedding_size), disk-cached. Without a cache, ``params`` (the JAX
    package's tree) or :func:`_init_or_warn` fill ``clip`` first. A dataset
    with the original images (``raw_image``) is preprocessed on the host by
    :func:`clip_preprocess_pil`; another on the device by
    :func:`clip_preprocess_u8`."""
    tr_cache = _img_cache("train", dataset_name, clip.kind)
    te_cache = _img_cache("test", dataset_name, clip.kind)
    if os.path.exists(tr_cache) and os.path.exists(te_cache):
        return np.load(tr_cache)["emb"], np.load(te_cache)["emb"]
    _fill(clip, params)
    device = _device(clip)

    @torch.no_grad()
    def run(ds) -> np.ndarray:
        out = []
        n = len(ds)
        exact = hasattr(ds, "raw_image")
        for s in range(0, n, batch_size):
            idx = range(s, min(s + batch_size, n))
            if exact:
                batch = np.stack([clip_preprocess_pil(ds.raw_image(i)) for i in idx])
                x = torch.from_numpy(_padded(batch, batch_size)).to(device).permute(0, 3, 1, 2)
            else:
                batch = np.stack([ds[i][0] for i in idx])
                x = clip_preprocess_u8(torch.from_numpy(_padded(batch, batch_size)).to(device))
            out.append(clip.encode_image(x).float().cpu().numpy()[: len(idx)])
        return np.concatenate(out)

    train_emb, test_emb = run(train_ds), run(test_ds)
    os.makedirs(os.path.dirname(tr_cache), exist_ok=True)
    np.savez(tr_cache, emb=train_emb)
    np.savez(te_cache, emb=test_emb)
    return train_emb, test_emb


def compute_text_embeddings(clip: CLIP, captions: list[str], dataset_name: str,
                            cache_key: str, tokenizer, params: dict | None = None,
                            batch_size: int = 32) -> np.ndarray:
    """CLIP text embeddings (N, embedding_size) of a caption list,
    disk-cached. ``tokenizer.tokenize(list[str])`` gives (N, context)
    integer ids (:class:`SimpleTokenizer`)."""
    cache = _txt_cache(cache_key, dataset_name, clip.kind)
    if os.path.exists(cache):
        return np.load(cache)["emb"]
    _fill(clip, params)
    device = _device(clip)
    tokens = np.asarray(tokenizer.tokenize(captions))
    out = []
    with torch.no_grad():
        for s in range(0, len(tokens), batch_size):
            chunk = tokens[s: s + batch_size]
            ids = torch.from_numpy(_padded(chunk, batch_size).astype(np.int64)).to(device)
            out.append(clip.encode_text(ids).float().cpu().numpy()[: len(chunk)])
    emb = np.concatenate(out)
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    np.savez(cache, emb=emb)
    return emb


def _fill(clip: CLIP, params: dict | None) -> None:
    from viscoin_tpu_torch.utils.weights import load_jax_tree

    if params is None:
        _init_or_warn(clip)
    else:
        load_jax_tree(clip, {"params": params})


def _init_or_warn(clip: CLIP) -> CLIP:
    """``clip`` filled from the npz at ``checkpoints/clip/vit-b-32`` (what
    ``port-weights clip`` writes), else seeded from 0, with a warning."""
    from viscoin_tpu_torch.models.bundle import init_models
    from viscoin_tpu_torch.utils.checkpoints import restore_pytree
    from viscoin_tpu_torch.utils.weights import load_jax_tree

    if os.path.exists(CLIP_CHECKPOINT):
        return load_jax_tree(clip, {"params": restore_pytree(CLIP_CHECKPOINT)})
    print("WARNING: no CLIP weights at checkpoints/clip/vit-b-32 — using random "
          "init (port OpenAI weights with `python -m viscoin_tpu_torch port-weights clip`).")
    return init_models(clip, 0)


# -------------------------------- tokenizer --------------------------------- #


class SimpleTokenizer:
    """CLIP's byte-level BPE tokenizer. Reads the merges file
    ``bpe_simple_vocab_16e6.txt.gz`` (the one the pip package bundles; any
    gzip merges file of that format), given by its path."""

    def __init__(self, bpe_path: str, context_length: int = 77):
        import gzip

        self.context_length = context_length
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1: 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        import re

        # ASCII approximation of CLIP's \p{L}/\p{N} pattern (the standard
        # library's `re` has no unicode property classes; CUB captions are ASCII).
        pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
            re.IGNORECASE,
        )
        text = " ".join(text.lower().strip().split())
        bpe_tokens: list[int] = []
        for token in re.findall(pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def tokenize(self, texts: list[str]) -> np.ndarray:
        """(len(texts), context_length) int32 ids: start, the text's tokens,
        end (kept last when the text is cut), zeros after."""
        sot = self.encoder["<|startoftext|>"]
        eot = self.encoder["<|endoftext|>"]
        result = np.zeros((len(texts), self.context_length), np.int32)
        for i, text in enumerate(texts):
            tokens = [sot] + self.encode(text) + [eot]
            tokens = tokens[: self.context_length]
            if len(tokens) == self.context_length:
                tokens[-1] = eot
            result[i, : len(tokens)] = tokens
        return result


def _bytes_to_unicode() -> dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word) -> set:
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs
