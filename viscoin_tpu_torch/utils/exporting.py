"""The JAX package's layout -> torch state_dicts of the reference ecosystem.

Counterpart of ``viscoin_tpu/utils/exporting.py`` and the inverse of
``utils/porting.py``: a model trained here exports to the exact
``state_dict`` layouts the reference loads (``load_viscoin``'s joint dict,
the HF-ResNet classifier, NVlabs generator and discriminator naming). Each
exporter takes a variables tree in the JAX package's layout, which
``utils/weights.py::module_to_jax_tree`` (or ``bundle_to_jax_tree``) makes
of the port's modules, and gives numpy arrays:

  * HWIO conv kernels -> torch OIHW ``transpose(3, 2, 0, 1)``;
  * flax ``Dense`` (in, out) -> torch (out, in); StyleGAN's equalized-LR
    weights are stored torch-style already and pass;
  * BatchNorm: scale -> weight, batch_stats -> running_mean/var, plus the
    ``num_batches_tracked`` buffer torch registers (0);
  * NVlabs' constant ``resample_filter`` buffers (``setup_filter([1, 3, 3,
    1])``) are rebuilt, so a strict ``load_state_dict`` finds every key.
"""

from __future__ import annotations

import numpy as np

_FIR = np.array([1.0, 3.0, 3.0, 1.0], np.float32)
RESAMPLE_FILTER = np.outer(_FIR, _FIR) / _FIR.sum() ** 2


def _conv_back(k) -> np.ndarray:
    return np.transpose(np.asarray(k), (3, 2, 0, 1))  # HWIO -> OIHW


def _dense_back(sd: dict, prefix: str, params: dict) -> None:
    sd[f"{prefix}.weight"] = np.transpose(np.asarray(params["kernel"]), (1, 0))
    if "bias" in params:
        sd[f"{prefix}.bias"] = np.asarray(params["bias"])


def _bn_back(sd: dict, prefix: str, params: dict, stats: dict) -> None:
    sd[f"{prefix}.weight"] = np.asarray(params["scale"])
    sd[f"{prefix}.bias"] = np.asarray(params["bias"])
    sd[f"{prefix}.running_mean"] = np.asarray(stats["mean"])
    sd[f"{prefix}.running_var"] = np.asarray(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


def _convbn_back(sd: dict, conv_key: str, bn_key: str, params: dict, stats: dict) -> None:
    sd[f"{conv_key}.weight"] = _conv_back(params["conv"]["kernel"])
    _bn_back(sd, bn_key, params["bn"], stats["bn"])


def export_classifier_torch(variables: dict) -> dict[str, np.ndarray]:
    """Classifier {params, batch_stats} -> the reference Classifier's
    state_dict (HF ResNetModel under ``resnet.``, the head under
    ``linear.``)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict[str, np.ndarray] = {}
    _convbn_back(sd, "resnet.embedder.embedder.convolution",
                 "resnet.embedder.embedder.normalization", params["resnet"]["embedder"],
                 stats["resnet"]["embedder"])
    for name in params["resnet"]:
        if not name.startswith("stage"):
            continue
        s, j = name.replace("stage", "").split("_block")
        base = f"resnet.encoder.stages.{s}.layers.{j}"
        blk_p, blk_s = params["resnet"][name], stats["resnet"][name]
        for idx, cname in enumerate(("conv1", "conv2", "conv3")):
            _convbn_back(sd, f"{base}.layer.{idx}.convolution", f"{base}.layer.{idx}.normalization",
                         blk_p[cname], blk_s[cname])
        if "shortcut" in blk_p:
            _convbn_back(sd, f"{base}.shortcut.convolution", f"{base}.shortcut.normalization",
                         blk_p["shortcut"], blk_s["shortcut"])
    _dense_back(sd, "linear", params["linear"])
    return sd


def export_concept_extractor_torch(params: dict) -> dict[str, np.ndarray]:
    """Psi params -> the reference ConceptExtractor's state_dict."""
    sd: dict[str, np.ndarray] = {}
    for i in range(1, 6):
        sd[f"conv{i}.weight"] = _conv_back(params[f"conv{i}"]["kernel"])
        sd[f"conv{i}.bias"] = np.asarray(params[f"conv{i}"]["bias"])
    _dense_back(sd, "linear1", params["linear1"])
    _dense_back(sd, "linear2", params["linear2"])
    return sd


def export_explainer_torch(params: dict) -> dict[str, np.ndarray]:
    """Theta params -> the reference Explainer's state_dict; the weight-norm
    variant with the ``linear.parametrizations.weight.original0/1`` keys."""
    if "weight_g" in params:
        return {"linear.parametrizations.weight.original0":
                np.asarray(params["weight_g"]).reshape(-1, 1),
                "linear.parametrizations.weight.original1": np.asarray(params["weight_v"]),
                "linear.bias": np.asarray(params["bias"])}
    sd: dict[str, np.ndarray] = {}
    _dense_back(sd, "linear", params["linear"])
    return sd


def export_concept2clip_torch(params: dict) -> dict[str, np.ndarray]:
    """Concept2CLIP(StyleGAN) params -> the reference's nn.Sequential
    state_dict (Linear layers at model.0, model.2, model.4)."""
    sd: dict[str, np.ndarray] = {}
    for i, key in enumerate(["fc0", "fc1", "fc2"]):
        _dense_back(sd, f"model.{2 * i}", params[key])
    return sd


# --------------------------------- StyleGAN2 -------------------------------- #


def _fc_back(sd: dict, prefix: str, params: dict) -> None:
    sd[f"{prefix}.weight"] = np.asarray(params["weight"])
    if "bias" in params:
        sd[f"{prefix}.bias"] = np.asarray(params["bias"])


def _synthesis_layer_back(sd: dict, prefix: str, params: dict, noise: dict | None,
                          include_buffers: bool) -> None:
    _fc_back(sd, f"{prefix}.affine", params["affine"])
    sd[f"{prefix}.weight"] = _conv_back(params["weight"])
    sd[f"{prefix}.bias"] = np.asarray(params["bias"])
    if "noise_strength" in params:
        sd[f"{prefix}.noise_strength"] = np.asarray(params["noise_strength"])
        if noise and "noise_const" in noise:
            sd[f"{prefix}.noise_const"] = np.asarray(noise["noise_const"])
    if include_buffers:
        sd[f"{prefix}.resample_filter"] = RESAMPLE_FILTER.copy()


def export_synthesis_torch(params: dict, noise: dict | None = None, prefix: str = "synthesis",
                           include_buffers: bool = True) -> dict[str, np.ndarray]:
    """SynthesisNetwork params (and noise) -> the NVlabs state_dict subtree;
    ``include_buffers`` rebuilds the ``resample_filter`` buffers."""
    noise = noise or {}
    sd: dict[str, np.ndarray] = {}
    p = f"{prefix}." if prefix else ""
    for bname in sorted(params, key=lambda s: int(s[1:])):
        bp, bn, base = params[bname], noise.get(bname, {}), f"{p}{bname}"
        if "const" in bp:
            sd[f"{base}.const"] = np.transpose(np.asarray(bp["const"]), (2, 0, 1))  # HWC -> CHW
        if "conv0" in bp:
            _synthesis_layer_back(sd, f"{base}.conv0", bp["conv0"], bn.get("conv0"),
                                  include_buffers)
        _synthesis_layer_back(sd, f"{base}.conv1", bp["conv1"], bn.get("conv1"), include_buffers)
        if "torgb" in bp:
            _fc_back(sd, f"{base}.torgb.affine", bp["torgb"]["affine"])
            sd[f"{base}.torgb.weight"] = _conv_back(bp["torgb"]["weight"])
            sd[f"{base}.torgb.bias"] = np.asarray(bp["torgb"]["bias"])
        if include_buffers:
            sd[f"{base}.resample_filter"] = RESAMPLE_FILTER.copy()
    return sd


def export_generator_torch(variables: dict, include_buffers: bool = True) -> dict[str, np.ndarray]:
    """Generator {params, noise, moving_stats} -> the NVlabs Generator's
    state_dict, with the ``mapping.w_avg`` buffer (zeros when absent)."""
    params = variables["params"]
    noise = variables.get("noise", {}).get("synthesis", {})
    sd = export_synthesis_torch(params["synthesis"], noise, "synthesis", include_buffers)
    for name in sorted(params["mapping"]):
        _fc_back(sd, f"mapping.{name}", params["mapping"][name])
    w_avg = variables.get("moving_stats", {}).get("mapping", {}).get("w_avg")
    if w_avg is None:
        last = params["mapping"][sorted(params["mapping"])[-1]]
        w_avg = np.zeros((np.asarray(last["weight"]).shape[0],), np.float32)
    sd["mapping.w_avg"] = np.asarray(w_avg)
    return sd


def export_adapted_mapping_torch(params: dict, num_ws: int, num_layers: int = 1,
                                 coarse_layer: int = 2, mid_layer: int = 10,
                                 prefix: str = "mapping") -> dict[str, np.ndarray]:
    """The stacked two-group MappingNetworkAdapted params -> the reference's
    per-index MLPs (``s{i}.{layer}``) and ``fixed_w_avg``."""
    g1 = [i for i in range(num_ws) if coarse_layer <= i <= mid_layer]
    g2 = [i for i in range(num_ws) if i < coarse_layer or i > mid_layer]
    p = f"{prefix}." if prefix else ""
    sd: dict[str, np.ndarray] = {}
    for name, idxs in (("g1", g1), ("g2", g2)):
        for layer in range(num_layers):
            w = np.asarray(params[f"{name}_w{layer}"])
            b = np.asarray(params[f"{name}_b{layer}"])
            for row, i in enumerate(idxs):
                sd[f"{p}s{i}.{layer}.weight"] = w[row]
                sd[f"{p}s{i}.{layer}.bias"] = b[row]
    sd[f"{p}fixed_w_avg"] = np.asarray(params["fixed_w_avg"])
    return sd


def export_generator_adapted_torch(gan_vars: dict, num_ws: int, num_layers: int = 1,
                                   coarse_layer: int = 2, mid_layer: int = 10,
                                   include_buffers: bool = True) -> dict[str, np.ndarray]:
    """GeneratorAdapted {params, noise} -> the reference GeneratorAdapted's
    state_dict."""
    params = gan_vars["params"]
    noise = gan_vars.get("noise", {}).get("synthesis", {})
    sd = export_synthesis_torch(params["synthesis"], noise, "synthesis", include_buffers)
    sd.update(export_adapted_mapping_torch(params["mapping"], num_ws=num_ws,
                                           num_layers=num_layers, coarse_layer=coarse_layer,
                                           mid_layer=mid_layer))
    return sd


def export_discriminator_torch(params: dict, include_buffers: bool = True) -> dict[str, np.ndarray]:
    """Discriminator params -> the NVlabs Discriminator's state_dict; the
    epilogue FC's columns go back from (h, w, c) to torch's (c, h, w)."""
    sd: dict[str, np.ndarray] = {}

    def conv2d_layer(prefix: str, p: dict) -> None:
        sd[f"{prefix}.weight"] = _conv_back(p["weight"])
        if "bias" in p:
            sd[f"{prefix}.bias"] = np.asarray(p["bias"])
        if include_buffers:
            sd[f"{prefix}.resample_filter"] = RESAMPLE_FILTER.copy()

    for bname in sorted((n for n in params if n.startswith("b")), key=lambda s: -int(s[1:])):
        bp = params[bname]
        if "fromrgb" in bp:
            conv2d_layer(f"{bname}.fromrgb", bp["fromrgb"])
        for name in ("conv0", "conv1", "skip"):
            conv2d_layer(f"{bname}.{name}", bp[name])
        if include_buffers:
            sd[f"{bname}.resample_filter"] = RESAMPLE_FILTER.copy()
    conv2d_layer("b4.conv", params["conv"])
    w = np.asarray(params["fc"]["weight"])
    c4 = w.shape[1] // 16
    sd["b4.fc.weight"] = w.reshape(-1, 4, 4, c4).transpose(0, 3, 1, 2).reshape(-1, 16 * c4)
    sd["b4.fc.bias"] = np.asarray(params["fc"]["bias"])
    _fc_back(sd, "b4.out", params["out"])
    return sd


def export_viscoin_torch(models) -> dict[str, dict[str, np.ndarray]]:
    """The port's ``VisCoINModels`` -> the reference ``save_viscoin`` joint
    dict ({classifier, concept_extractor, explainer, gan} state_dicts), which
    the reference's ``load_viscoin`` reads once ``torch.save``d."""
    from viscoin_tpu_torch.utils.weights import bundle_to_jax_tree

    tree = bundle_to_jax_tree(models)
    cfg = models.gan.config
    return {
        "classifier": export_classifier_torch(tree["classifier"]),
        "concept_extractor": export_concept_extractor_torch(tree["concept_extractor"]),
        "explainer": export_explainer_torch(tree["explainer"]),
        "gan": export_generator_adapted_torch(
            tree["gan"], num_ws=models.gan.num_ws, num_layers=cfg["mapping_num_layers"],
            coarse_layer=cfg["coarse_layer"], mid_layer=cfg["mid_layer"]),
    }
