"""Torch checkpoints of the reference ecosystem -> the JAX package's layout.

Counterpart of ``viscoin_tpu/utils/porting.py``: each converter maps a torch
``state_dict`` (numpy values) of one of the networks the reference ships or
loads (HF ResNet-50 classifier, the NVlabs StyleGAN2 generator and
discriminator, LPIPS-VGG, the FID Inception, CLIP ViT-B/32 in the OpenAI and
the HF layouts, VisCoIN's own modules and Concept2CLIP) onto
the variables tree the JAX package holds ({collection: nested dict}, flax
layouts). ``utils/weights.py::load_jax_tree`` carries such a tree into the
port's modules; each ``load_torch_*`` below does both steps.

Conventions (the JAX package's):
  * torch conv weights (Co, Ci, kh, kw) -> HWIO ``transpose(2, 3, 1, 0)``;
  * torch linear weights (out, in) stay (out, in) for StyleGAN's
    equalized-LR layers and transpose to (in, out) for flax ``Dense``;
  * BatchNorm: weight -> scale, bias -> bias, running_mean/var ->
    batch_stats mean/var.

The manifests (``viscoin_tpu_torch/manifests/*.json``, copies of the JAX
package's) list the exact keys and shapes of each reference network;
:func:`validate_state_dict` reports what a checkpoint lacks, adds or
mis-shapes.
"""

from __future__ import annotations

import json
import math
import os
import re

import numpy as np

_MANIFEST_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "manifests")

MANIFEST_KINDS = ("classifier", "lpips", "inception", "stylegan_generator", "clip_openai",
                  "clip_hf")


def load_manifest(kind: str) -> dict:
    """A manifest: {"required": {key: shape}, "optional": {key: shape},
    "optional_prefixes": [...], "one_of": [[key, ...], ...]}; a dim of -1
    matches any size (the class count of the head)."""
    if kind not in MANIFEST_KINDS:
        raise ValueError(f"no manifest for kind {kind!r}; have {MANIFEST_KINDS}")
    with open(os.path.join(_MANIFEST_DIR, f"{kind}.json")) as f:
        return json.load(f)


def _shape_ok(got: tuple, want: list) -> bool:
    return len(got) == len(want) and all(w == -1 or g == w for g, w in zip(got, want))


def _manifest_shape(key: str, man: dict):
    """The shape the manifest gives ``key``: its own entry, else (a one_of
    member without one) that of the first member of its group that has one.
    ``[]`` (a scalar) is a shape; None means the manifest gives none."""
    required, optional = man.get("required", {}), man.get("optional", {})
    for table in (required, optional):
        if key in table:
            return table[key]
    for group in man.get("one_of", []):
        if key in group:
            for member in group:
                for table in (required, optional):
                    if member in table:
                        return table[member]
    return None


def validate_state_dict(sd: dict, kind: str, strict: bool = True) -> list[str]:
    """Problems of a state_dict (tensor- or numpy-valued) against the
    ``kind`` manifest: missing required keys, unsatisfied one_of groups,
    unexpected keys, shape mismatches. Empty when clean; with ``strict`` a
    non-empty list raises ``ValueError``."""
    man = load_manifest(kind)
    required, optional = man.get("required", {}), man.get("optional", {})
    prefixes = tuple(man.get("optional_prefixes", []))
    one_of = man.get("one_of", [])
    shapes = {k: tuple(v.shape) if hasattr(v, "shape") else np.asarray(v).shape
              for k, v in sd.items()}

    problems = []
    for k, want in required.items():
        if k not in shapes:
            problems.append(f"missing required key: {k} (shape {want})")
    for group in one_of:
        if not any(k in shapes for k in group):
            problems.append(f"missing key: one of {group} is required")
    known = set(required) | set(optional) | {k for g in one_of for k in g}
    for k in shapes:
        if k not in known and not k.startswith(prefixes) and not k.endswith(
                "num_batches_tracked"):
            problems.append(f"unexpected key: {k} (shape {list(shapes[k])})")
    for k, got in shapes.items():
        want = _manifest_shape(k, man)
        if want is not None and not _shape_ok(got, want):
            problems.append(f"shape mismatch: {k} has {list(got)}, manifest expects {want}")
    if problems and strict:
        shown = "\n  ".join(problems[:40])
        more = f"\n  ... and {len(problems) - 40} more" if len(problems) > 40 else ""
        raise ValueError(
            f"state_dict does not match the {kind!r} manifest ({len(problems)} problems):\n  "
            f"{shown}{more}\n(manifest: {os.path.join(_MANIFEST_DIR, kind + '.json')}; pass "
            "strict=False / drop --strict to port anyway)")
    return problems


def state_dict_to_numpy(state_dict) -> dict[str, np.ndarray]:
    """A torch state_dict as numpy arrays (copied to the host)."""
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in state_dict.items()}


def _conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))  # OIHW -> HWIO


def _bn(sd: dict, prefix: str) -> tuple[dict, dict]:
    return ({"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]},
            {"mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]})


def _convbn(sd: dict, conv_key: str, bn_key: str) -> tuple[dict, dict]:
    bn_p, bn_s = _bn(sd, bn_key)
    return {"conv": {"kernel": _conv(sd[f"{conv_key}.weight"])}, "bn": bn_p}, {"bn": bn_s}


def _dense(sd: dict, prefix: str) -> dict:
    out = {"kernel": np.transpose(sd[f"{prefix}.weight"], (1, 0))}
    if f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def _conv_with_bias(sd: dict, prefix: str) -> dict:
    return {"kernel": _conv(sd[f"{prefix}.weight"]), "bias": sd[f"{prefix}.bias"]}


# ------------------------------ the classifier ------------------------------ #


def convert_torch_classifier(sd: dict[str, np.ndarray], depths=None,
                             strict: bool = False) -> dict:
    """The reference Classifier (HF ResNetModel under ``resnet.``, the head
    under ``linear.``) -> {params, batch_stats} of ``Classifier``. ``depths``
    is read from the keys when not given; ``strict`` validates first."""
    if strict:
        validate_state_dict(sd, "classifier")
    if depths is None:
        counts: dict[int, int] = {}
        for k in sd:
            m = re.match(r"resnet\.encoder\.stages\.(\d+)\.layers\.(\d+)\.", k)
            if m:
                s, j = int(m.group(1)), int(m.group(2))
                counts[s] = max(counts.get(s, 0), j + 1)
        depths = tuple(counts[i] for i in sorted(counts))
    params: dict = {"resnet": {}, "linear": {}}
    stats: dict = {"resnet": {}}
    p, s = _convbn(sd, "resnet.embedder.embedder.convolution",
                   "resnet.embedder.embedder.normalization")
    params["resnet"]["embedder"], stats["resnet"]["embedder"] = p, s
    for i, depth in enumerate(depths):
        for j in range(depth):
            base = f"resnet.encoder.stages.{i}.layers.{j}"
            blk_p, blk_s = {}, {}
            for idx, name in enumerate(("conv1", "conv2", "conv3")):
                blk_p[name], blk_s[name] = _convbn(sd, f"{base}.layer.{idx}.convolution",
                                                   f"{base}.layer.{idx}.normalization")
            if f"{base}.shortcut.convolution.weight" in sd:
                blk_p["shortcut"], blk_s["shortcut"] = _convbn(
                    sd, f"{base}.shortcut.convolution", f"{base}.shortcut.normalization")
            params["resnet"][f"stage{i}_block{j}"] = blk_p
            stats["resnet"][f"stage{i}_block{j}"] = blk_s
    params["linear"] = {"kernel": np.transpose(sd["linear.weight"], (1, 0)),
                        "bias": sd["linear.bias"]}
    return {"params": params, "batch_stats": stats}


# ------------------------------- Psi and Theta ------------------------------ #


def convert_torch_concept_extractor(sd: dict[str, np.ndarray]) -> dict:
    """The reference ConceptExtractor -> params of ``ConceptExtractor``."""
    out = {f"conv{i}": _conv_with_bias(sd, f"conv{i}") for i in range(1, 6)}
    out["linear1"], out["linear2"] = _dense(sd, "linear1"), _dense(sd, "linear2")
    return out


def convert_torch_explainer(sd: dict[str, np.ndarray]) -> dict:
    """The reference Explainer -> params of ``Explainer`` (either weight_norm
    parametrization gives ``weight_g``/``weight_v``)."""
    for g, v in (("linear.parametrizations.weight.original0",
                  "linear.parametrizations.weight.original1"),
                 ("linear.weight_g", "linear.weight_v")):
        if g in sd:
            return {"weight_g": sd[g].reshape(-1, 1), "weight_v": sd[v], "bias": sd["linear.bias"]}
    return {"linear": _dense(sd, "linear")}


def convert_torch_concept2clip(sd: dict[str, np.ndarray]) -> dict:
    """The reference Concept2CLIP / Concept2CLIPStyleGAN (three Linear layers
    of an nn.Sequential, at indices 0, 2, 4) -> params."""
    return {"fc0": _dense(sd, "model.0"), "fc1": _dense(sd, "model.2"),
            "fc2": _dense(sd, "model.4")}


# ----------------------------------- LPIPS ---------------------------------- #

# torchvision vgg16.features conv indices, by LPIPS slice.
_LPIPS_SLICES = {1: (0, 2), 2: (5, 7), 3: (10, 12, 14), 4: (17, 19, 21), 5: (24, 26, 28)}


def convert_torch_lpips(sd: dict[str, np.ndarray], strict: bool = False) -> dict:
    """A pip-``lpips`` LPIPS(net='vgg') state_dict -> params of ``LPIPS``:
    ``net.slice{s}.{i}`` VGG convs and the 1x1 heads ``lin{i}.model.1``
    (or ``lins.{i}.model.1``)."""
    if strict:
        validate_state_dict(sd, "lpips")
    vgg: dict = {}
    for s, layers in _LPIPS_SLICES.items():
        for li in layers:
            vgg[f"conv{len(vgg)}"] = {"kernel": _conv(sd[f"net.slice{s}.{li}.weight"]),
                                      "bias": sd[f"net.slice{s}.{li}.bias"]}
    params: dict = {"vgg": vgg}
    for i in range(5):
        w = sd.get(f"lin{i}.model.1.weight")
        if w is None:
            w = sd[f"lins.{i}.model.1.weight"]
        params[f"lin{i}"] = np.asarray(w).reshape(-1)
    return params


# --------------------------------- Inception -------------------------------- #


def _set_unit(params: dict, stats: dict, path, unit_p: dict, unit_s: dict) -> None:
    for part in path[:-1]:
        params, stats = params.setdefault(part, {}), stats.setdefault(part, {})
    params[path[-1]], stats[path[-1]] = unit_p, unit_s


def convert_torch_inception(sd: dict[str, np.ndarray], strict: bool = False) -> dict:
    """A torchvision ``inception_v3`` (or pytorch-fid FIDInceptionV3)
    state_dict -> {params, batch_stats} of ``InceptionV3Features``: each
    ``<path>.conv.weight`` + ``<path>.bn`` unit maps by its path; the fc and
    AuxLogits heads are dropped."""
    if strict:
        validate_state_dict(sd, "inception")
    params: dict = {}
    stats: dict = {}
    prefixes = sorted({k.rsplit(".conv.weight", 1)[0] for k in sd if k.endswith(".conv.weight")})
    for prefix in prefixes:
        parts = prefix.split(".")
        if parts[0] == "fc" or "AuxLogits" in parts:
            continue
        bn_p, bn_s = _bn(sd, f"{prefix}.bn")
        _set_unit(params, stats, parts, {"conv": {"kernel": _conv(sd[f"{prefix}.conv.weight"])},
                                         "bn": bn_p}, {"bn": bn_s})
    return {"params": params, "batch_stats": stats}


def inception_unit_order() -> list[tuple[str, ...]]:
    """The 94 conv + BN units of ``InceptionV3Features`` in execution order,
    the order in which the TF-slim graph (and so the NVlabs TorchScript
    trace) holds them."""
    order: list[tuple[str, ...]] = [("Conv2d_1a_3x3",), ("Conv2d_2a_3x3",), ("Conv2d_2b_3x3",),
                                    ("Conv2d_3b_1x1",), ("Conv2d_4a_3x3",)]
    a = ["branch1x1", "branch5x5_1", "branch5x5_2", "branch3x3dbl_1", "branch3x3dbl_2",
         "branch3x3dbl_3", "branch_pool"]
    b = ["branch3x3", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"]
    c = ["branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3", "branch7x7dbl_1",
         "branch7x7dbl_2", "branch7x7dbl_3", "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool"]
    d = ["branch3x3_1", "branch3x3_2", "branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3",
         "branch7x7x3_4"]
    e = ["branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b", "branch3x3dbl_1",
         "branch3x3dbl_2", "branch3x3dbl_3a", "branch3x3dbl_3b", "branch_pool"]
    for name, branches in (("Mixed_5b", a), ("Mixed_5c", a), ("Mixed_5d", a), ("Mixed_6a", b),
                           ("Mixed_6b", c), ("Mixed_6c", c), ("Mixed_6d", c), ("Mixed_6e", c),
                           ("Mixed_7a", d), ("Mixed_7b", e), ("Mixed_7c", e)):
        order.extend((name, br) for br in branches)
    return order


def convert_torchscript_inception(ts_module) -> dict:
    """The NVlabs TorchScript FID detector (``inception-2015-12-05.pt``) ->
    {params, batch_stats} of ``InceptionV3Features``. The trace holds its
    parameters and buffers in the TF graph's order, which is the execution
    order of the units (:func:`inception_unit_order`): the i-th 4-d kernel
    and the i-th BN statistics pair belong to the i-th unit. Every kernel's
    shape is checked against the architecture; TF-slim BN has no scale, so a
    missing gamma becomes ones (a missing beta zeros)."""
    from viscoin_tpu_torch.models.inception import InceptionV3Features

    convs: list[np.ndarray] = []
    bn_units: dict[str, dict[str, np.ndarray]] = {}
    bn_order: list[str] = []
    for name, p in ts_module.named_parameters():
        arr = p.detach().cpu().numpy()
        if arr.ndim == 4:
            convs.append(arr)
        elif arr.ndim == 1:
            prefix, leaf = name.rsplit(".", 1)
            bn_units.setdefault(prefix, {})[leaf] = arr
    for name, b in ts_module.named_buffers():
        prefix, leaf = name.rsplit(".", 1)
        if leaf in ("running_mean", "running_var"):
            if leaf == "running_mean":
                bn_order.append(prefix)
            bn_units.setdefault(prefix, {})[leaf] = b.detach().cpu().numpy()
    units = inception_unit_order()
    if len(convs) != len(units) or len(bn_order) != len(units):
        raise ValueError(f"expected {len(units)} conv+bn units, found {len(convs)} convs and "
                         f"{len(bn_order)} batch-norms: not an InceptionV3 FID detector export")
    # The architecture's kernel shapes, from the module on the meta device.
    owners = dict(InceptionV3Features(device="meta").named_modules())
    params: dict = {}
    stats: dict = {}
    for i, path in enumerate(units):
        want = tuple(owners[".".join(path)].conv.weight.shape)
        if convs[i].shape != want:
            raise ValueError(f"unit {'/'.join(path)}: kernel shape {convs[i].shape} != expected "
                             f"{want}: the export's parameter order does not match the TF graph")
        bn = bn_units[bn_order[i]]
        n = convs[i].shape[0]
        _set_unit(params, stats, path,
                  {"conv": {"kernel": _conv(convs[i])},
                   "bn": {"scale": bn.get("weight", np.ones(n, np.float32)),
                          "bias": bn.get("bias", np.zeros(n, np.float32))}},
                  {"bn": {"mean": bn["running_mean"], "var": bn["running_var"]}})
    return {"params": params, "batch_stats": stats}


# ----------------------------------- CLIP ----------------------------------- #


def _clip_block_openai(sd: dict, p: str) -> dict:
    return {
        "ln_1": {"scale": sd[f"{p}.ln_1.weight"], "bias": sd[f"{p}.ln_1.bias"]},
        "ln_2": {"scale": sd[f"{p}.ln_2.weight"], "bias": sd[f"{p}.ln_2.bias"]},
        "attn": {
            "in_proj": {"kernel": np.transpose(sd[f"{p}.attn.in_proj_weight"]),
                        "bias": sd[f"{p}.attn.in_proj_bias"]},
            "out_proj": _dense(sd, f"{p}.attn.out_proj"),
        },
        "mlp_fc": _dense(sd, f"{p}.mlp.c_fc"),
        "mlp_proj": _dense(sd, f"{p}.mlp.c_proj"),
    }


def convert_torch_clip(sd: dict[str, np.ndarray], vision_layers: int = 12,
                       text_layers: int = 12, strict: bool = False) -> dict:
    """An OpenAI pip-``clip`` ViT-B/32 state_dict -> params of ``CLIP``."""
    if strict:
        validate_state_dict(sd, "clip_openai")
    visual: dict = {
        "patch_embed": {"kernel": _conv(sd["visual.conv1.weight"])},
        "class_embedding": sd["visual.class_embedding"],
        "positional_embedding": sd["visual.positional_embedding"],
        "ln_pre": {"scale": sd["visual.ln_pre.weight"], "bias": sd["visual.ln_pre.bias"]},
        "ln_post": {"scale": sd["visual.ln_post.weight"], "bias": sd["visual.ln_post.bias"]},
        "proj": sd["visual.proj"],
    }
    for i in range(vision_layers):
        visual[f"block{i}"] = _clip_block_openai(sd, f"visual.transformer.resblocks.{i}")
    text: dict = {
        "token_embedding": sd["token_embedding.weight"],
        "positional_embedding": sd["positional_embedding"],
        "ln_final": {"scale": sd["ln_final.weight"], "bias": sd["ln_final.bias"]},
        "text_projection": sd["text_projection"],
    }
    for i in range(text_layers):
        text[f"block{i}"] = _clip_block_openai(sd, f"transformer.resblocks.{i}")
    return {"visual": visual, "text": text}


def convert_hf_clip(sd: dict[str, np.ndarray], vision_layers: int = 12,
                    text_layers: int = 12, strict: bool = False) -> dict:
    """A HuggingFace ``transformers.CLIPModel`` state_dict (ViT-B/32
    config) -> params of ``CLIP``: the split q/k/v projections concatenated
    into the fused ``in_proj``; the projections' (out, in) Linear weights
    transposed to (in, out) matrices."""
    if strict:
        validate_state_dict(sd, "clip_hf")

    def block(p: str) -> dict:
        qkv = [f"{p}.self_attn.{n}_proj" for n in "qkv"]
        return {
            "ln_1": {"scale": sd[f"{p}.layer_norm1.weight"],
                     "bias": sd[f"{p}.layer_norm1.bias"]},
            "ln_2": {"scale": sd[f"{p}.layer_norm2.weight"],
                     "bias": sd[f"{p}.layer_norm2.bias"]},
            "attn": {
                "in_proj": {
                    "kernel": np.transpose(np.concatenate([sd[f"{q}.weight"] for q in qkv], 0)),
                    "bias": np.concatenate([sd[f"{q}.bias"] for q in qkv])},
                "out_proj": _dense(sd, f"{p}.self_attn.out_proj"),
            },
            "mlp_fc": _dense(sd, f"{p}.mlp.fc1"),
            "mlp_proj": _dense(sd, f"{p}.mlp.fc2"),
        }

    v = "vision_model"
    visual: dict = {
        "patch_embed": {"kernel": _conv(sd[f"{v}.embeddings.patch_embedding.weight"])},
        "class_embedding": sd[f"{v}.embeddings.class_embedding"],
        "positional_embedding": sd[f"{v}.embeddings.position_embedding.weight"],
        "ln_pre": {"scale": sd[f"{v}.pre_layrnorm.weight"],
                   "bias": sd[f"{v}.pre_layrnorm.bias"]},
        "ln_post": {"scale": sd[f"{v}.post_layernorm.weight"],
                    "bias": sd[f"{v}.post_layernorm.bias"]},
        "proj": np.transpose(sd["visual_projection.weight"]),
    }
    for i in range(vision_layers):
        visual[f"block{i}"] = block(f"{v}.encoder.layers.{i}")
    t = "text_model"
    text: dict = {
        "token_embedding": sd[f"{t}.embeddings.token_embedding.weight"],
        "positional_embedding": sd[f"{t}.embeddings.position_embedding.weight"],
        "ln_final": {"scale": sd[f"{t}.final_layer_norm.weight"],
                     "bias": sd[f"{t}.final_layer_norm.bias"]},
        "text_projection": np.transpose(sd["text_projection.weight"]),
    }
    for i in range(text_layers):
        text[f"block{i}"] = block(f"{t}.encoder.layers.{i}")
    return {"visual": visual, "text": text}


def clip_manifest_kind(sd: dict) -> str:
    """The manifest of a CLIP state_dict: the HF layout has ``vision_model``
    keys, the OpenAI one has none."""
    return "clip_hf" if any(k.startswith("vision_model") for k in sd) else "clip_openai"


# --------------------------------- StyleGAN2 -------------------------------- #


def _fc(sd: dict, prefix: str) -> dict:
    out = {"weight": sd[f"{prefix}.weight"]}
    if f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def _infer_resolution(sd: dict, prefix: str) -> int:
    """The image resolution from the ``{prefix}b{res}.`` keys."""
    pat = re.compile(rf"^{re.escape(prefix)}b(\d+)\.")
    res = {int(m.group(1)) for k in sd if (m := pat.match(k))}
    if not res:
        raise ValueError(f"no '{prefix}b<res>.' keys found: cannot infer the resolution (not a "
                         "StyleGAN2 synthesis/discriminator state_dict?)")
    return max(res)


def _synthesis_layer(sd: dict, prefix: str) -> tuple[dict, dict]:
    params = {"affine": _fc(sd, f"{prefix}.affine"), "weight": _conv(sd[f"{prefix}.weight"]),
              "bias": sd[f"{prefix}.bias"]}
    noise = {}
    if f"{prefix}.noise_strength" in sd:
        params["noise_strength"] = np.asarray(sd[f"{prefix}.noise_strength"])
        if f"{prefix}.noise_const" in sd:
            noise["noise_const"] = sd[f"{prefix}.noise_const"]
    return params, noise


def convert_torch_synthesis(sd: dict[str, np.ndarray], prefix: str = "synthesis",
                            img_resolution: int | None = None) -> dict:
    """A SynthesisNetwork subtree -> {params, noise} of ``SynthesisNetwork``
    (the resolution from the ``b{res}`` keys when not given)."""
    if img_resolution is None:
        img_resolution = _infer_resolution(sd, f"{prefix}." if prefix else "")
    params: dict = {}
    noise: dict = {}
    for res in (2**i for i in range(2, int(math.log2(img_resolution)) + 1)):
        bp: dict = {}
        bn: dict = {}
        base = f"{prefix}.b{res}"
        if res == 4:
            bp["const"] = np.transpose(sd[f"{base}.const"], (1, 2, 0))  # CHW -> HWC
        else:
            bp["conv0"], n = _synthesis_layer(sd, f"{base}.conv0")
            if n:
                bn["conv0"] = n
        bp["conv1"], n = _synthesis_layer(sd, f"{base}.conv1")
        if n:
            bn["conv1"] = n
        if f"{base}.torgb.weight" in sd:
            bp["torgb"] = {"affine": _fc(sd, f"{base}.torgb.affine"),
                           "weight": _conv(sd[f"{base}.torgb.weight"]),
                           "bias": sd[f"{base}.torgb.bias"]}
        params[f"b{res}"] = bp
        if bn:
            noise[f"b{res}"] = bn
    return {"params": params, "noise": noise}


def convert_torch_generator(sd: dict[str, np.ndarray], img_resolution: int | None = None,
                            mapping_layers: int | None = None, strict: bool = False) -> dict:
    """A torch StyleGAN2 Generator -> {params, noise, moving_stats} of
    ``Generator``; the resolution and the mapping depth from the keys when
    not given; w_avg zeros when the state has none. ``strict`` validates
    against the reference's 256² generator manifest."""
    if strict:
        validate_state_dict(sd, "stylegan_generator")
    if mapping_layers is None:
        mapping_layers = sum(1 for k in sd if k.startswith("mapping.fc")
                             and k.endswith(".weight"))
        if not mapping_layers:
            raise ValueError("no mapping.fc{i} keys: not a Generator state_dict?")
    syn = convert_torch_synthesis(sd, "synthesis", img_resolution)
    mapping = {f"fc{i}": _fc(sd, f"mapping.fc{i}") for i in range(mapping_layers)}
    w_dim = sd[f"mapping.fc{mapping_layers - 1}.weight"].shape[0]
    w_avg = sd.get("mapping.w_avg", np.zeros((w_dim,), np.float32))
    return {"params": {"synthesis": syn["params"], "mapping": mapping},
            "noise": {"synthesis": syn["noise"]},
            "moving_stats": {"mapping": {"w_avg": w_avg}}}


def convert_torch_adapted_mapping(sd: dict[str, np.ndarray], prefix: str = "mapping",
                                  num_ws: int = 14, num_layers: int = 1, coarse_layer: int = 2,
                                  mid_layer: int = 10) -> dict:
    """The reference MappingNetworkAdapted's per-index MLPs (``s0`` ..) ->
    the stacked two-group params of ``MappingNetworkAdapted``."""
    g1 = [i for i in range(num_ws) if coarse_layer <= i <= mid_layer]
    g2 = [i for i in range(num_ws) if i < coarse_layer or i > mid_layer]
    p = f"{prefix}." if prefix else ""
    params: dict = {}
    for name, idxs in (("g1", g1), ("g2", g2)):
        for layer in range(num_layers):
            params[f"{name}_w{layer}"] = np.stack([sd[f"{p}s{i}.{layer}.weight"] for i in idxs])
            params[f"{name}_b{layer}"] = np.stack([sd[f"{p}s{i}.{layer}.bias"] for i in idxs])
    params["fixed_w_avg"] = sd[f"{p}fixed_w_avg"]
    return params


def convert_torch_discriminator(sd: dict[str, np.ndarray], img_resolution: int | None = None,
                                prefix: str = "") -> dict:
    """A torch StyleGAN2 Discriminator (NVlabs naming) -> params of
    ``Discriminator``. The epilogue FC reads a flattened 4x4 map: torch
    flattens (c, h, w), the JAX layout (h, w, c), so its columns permute."""
    p = f"{prefix}." if prefix else ""
    if img_resolution is None:
        img_resolution = _infer_resolution(sd, p)
    params: dict = {}
    for res in (2**i for i in range(int(math.log2(img_resolution)), 2, -1)):
        base = f"{p}b{res}"
        bp: dict = {}
        if f"{base}.fromrgb.weight" in sd:
            bp["fromrgb"] = {"weight": _conv(sd[f"{base}.fromrgb.weight"]),
                             "bias": sd[f"{base}.fromrgb.bias"]}
        for name in ("conv0", "conv1"):
            bp[name] = {"weight": _conv(sd[f"{base}.{name}.weight"]),
                        "bias": sd[f"{base}.{name}.bias"]}
        bp["skip"] = {"weight": _conv(sd[f"{base}.skip.weight"])}
        params[f"b{res}"] = bp
    params["conv"] = {"weight": _conv(sd[f"{p}b4.conv.weight"]), "bias": sd[f"{p}b4.conv.bias"]}
    w = sd[f"{p}b4.fc.weight"]
    c4 = w.shape[1] // 16
    w = w.reshape(-1, c4, 4, 4).transpose(0, 2, 3, 1).reshape(-1, 16 * c4)
    params["fc"] = {"weight": w, "bias": sd[f"{p}b4.fc.bias"]}
    params["out"] = {"weight": sd[f"{p}b4.out.weight"], "bias": sd[f"{p}b4.out.bias"]}
    return params


def convert_torch_generator_adapted(sd: dict[str, np.ndarray], img_resolution: int | None = None,
                                    num_layers: int = 1, coarse_layer: int = 2,
                                    mid_layer: int = 10) -> dict:
    """The reference GeneratorAdapted -> {params, noise} of
    ``GeneratorAdapted``."""
    if img_resolution is None:
        img_resolution = _infer_resolution(sd, "synthesis.")
    syn = convert_torch_synthesis(sd, "synthesis", img_resolution)
    mapping = convert_torch_adapted_mapping(
        sd, "mapping", num_ws=2 * int(math.log2(img_resolution)) - 2, num_layers=num_layers,
        coarse_layer=coarse_layer, mid_layer=mid_layer)
    return {"params": {"synthesis": syn["params"], "mapping": mapping},
            "noise": {"synthesis": syn["noise"]}}


# ------------------------- into the port's modules -------------------------- #


def _load(module, variables: dict):
    from viscoin_tpu_torch.utils.weights import load_jax_tree

    return load_jax_tree(module, variables)


def load_torch_classifier(module, sd: dict, strict: bool = False):
    """Fill a ``Classifier`` in place from a reference Classifier state_dict."""
    return _load(module, convert_torch_classifier(state_dict_to_numpy(sd), strict=strict))


def load_torch_concept_extractor(module, sd: dict):
    return _load(module, {"params": convert_torch_concept_extractor(state_dict_to_numpy(sd))})


def load_torch_explainer(module, sd: dict):
    return _load(module, {"params": convert_torch_explainer(state_dict_to_numpy(sd))})


def load_torch_lpips(module, sd: dict, strict: bool = False):
    return _load(module, {"params": convert_torch_lpips(state_dict_to_numpy(sd), strict=strict)})


def load_torch_inception(module, sd: dict, strict: bool = False):
    return _load(module, convert_torch_inception(state_dict_to_numpy(sd), strict=strict))


def load_torchscript_inception(module, ts_module):
    return _load(module, convert_torchscript_inception(ts_module))


def load_torch_generator(module, sd: dict, strict: bool = False):
    return _load(module, convert_torch_generator(state_dict_to_numpy(sd), strict=strict))


def load_torch_discriminator(module, sd: dict):
    return _load(module, {"params": convert_torch_discriminator(state_dict_to_numpy(sd))})


def load_torch_generator_adapted(module, sd: dict):
    cfg = module.config
    return _load(module, convert_torch_generator_adapted(
        state_dict_to_numpy(sd), num_layers=cfg["mapping_num_layers"],
        coarse_layer=cfg["coarse_layer"], mid_layer=cfg["mid_layer"]))
