"""The ``port-weights`` command: torch checkpoints of the reference ecosystem
into the port, and the port's checkpoints back out.

Counterpart of ``scripts/port_weights.py``; it writes the npz layout
(``utils/checkpoints.py::save_pytree``) at the paths ``train viscoin`` and
``train gan`` read, where the JAX script writes orbax::

    python -m viscoin_tpu_torch port-weights classifier model.pt checkpoints/cub/classifier-cub
    python -m viscoin_tpu_torch port-weights viscoin viscoin.pth checkpoints/cub/viscoin-cub
    python -m viscoin_tpu_torch port-weights stylegan network.pkl checkpoints/cub/gan-cub
    python -m viscoin_tpu_torch port-weights lpips lpips_vgg.pth checkpoints/lpips-vgg
    python -m viscoin_tpu_torch port-weights inception pt_inception.pth checkpoints/inception
    python -m viscoin_tpu_torch port-weights inception-nvlabs inception-2015-12-05.pt \\
        checkpoints/inception
    python -m viscoin_tpu_torch port-weights clip ViT-B-32.pt checkpoints/clip/vit-b-32
    python -m viscoin_tpu_torch port-weights classifier model.pt --check   # validate only

Each source is held against its manifest (``viscoin_tpu_torch/manifests``):
missing, unexpected and mis-shaped keys are printed; ``--strict`` stops on
any, ``--check`` writes nothing and exits 1 if there is one. The converted
variables are then loaded into the port's module on ``--device`` (the card
by default), so a tree that does not fit the module stops the command before
anything is written. ``clip`` takes the OpenAI pip-``clip`` state_dict or
a HuggingFace ``CLIPModel``'s (told apart by its ``vision_model`` keys,
each held against its own manifest) and writes where ``train concept2clip``
reads CLIP's weights, ``checkpoints/clip/vit-b-32``. ``stylegan`` reads an
NVlabs network pickle without the NVlabs code (a shimmed
``torch_utils.persistence``) or a plain state_dict, and writes the
discriminator, when the pickle has one, to ``<dst>.discriminator``.
``inception-nvlabs`` converts the NVlabs TorchScript detector, checks the
ported detector's features against the TorchScript module's on the device,
and marks the output with ``fid_convention.json``.

The reverse direction, from the port's checkpoints to the reference's
state_dicts (``torch.save``; ``utils/exporting.py``)::

    python -m viscoin_tpu_torch port-weights export-viscoin checkpoints/cub/viscoin-cub viscoin.pth
    python -m viscoin_tpu_torch port-weights export-stylegan checkpoints/cub/gan-cub gan.pth
    python -m viscoin_tpu_torch port-weights export-classifier classifier-cub classifier.pth
    python -m viscoin_tpu_torch port-weights export-concept2clip concept2clip c2c.pth
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re

import numpy as np
import torch

from viscoin_tpu_torch.utils import exporting, porting
from viscoin_tpu_torch.utils import checkpoints as ckpt
from viscoin_tpu_torch.utils.weights import load_jax_tree, module_to_jax_tree

PORT_KINDS = ("classifier", "viscoin", "stylegan", "lpips", "inception", "inception-nvlabs",
              "clip")
EXPORT_KINDS = ("export-viscoin", "export-stylegan", "export-classifier", "export-concept2clip")
MANIFEST_OF = {"classifier": "classifier", "viscoin": "classifier", "lpips": "lpips",
               "inception": "inception", "stylegan": "stylegan_generator"}
NVLABS_TOL = 1e-2  # the ported detector against the TorchScript one, relative to the features' max
FID_CONVENTION = "fid_convention.json"


def add_parser(subparsers) -> argparse.ArgumentParser:
    p = subparsers.add_parser("port-weights", help="Port torch checkpoints into the npz layout, "
                                                   "or export the port's checkpoints to torch.")
    p.add_argument("kind", choices=PORT_KINDS + EXPORT_KINDS)
    p.add_argument("src")
    p.add_argument("dst", nargs="?", default=None)
    p.add_argument("--check", action="store_true",
                   help="Validate the source against its manifest and write nothing (exit 1 on "
                        "any problem)")
    p.add_argument("--strict", action="store_true", help="Stop on any manifest problem")
    p.add_argument("--device", default="cuda",
                   help="Where the converted weights are loaded and checked: cuda (default) or "
                        "cpu")
    p.set_defaults(func=port_weights, parser=p)
    return p


# ------------------------------ the sources -------------------------------- #


def load_nvlabs_pickle(path: str) -> dict[str, dict]:
    """{"G_ema": state_dict, "D": ...} of an NVlabs stylegan2-ada network
    pickle, without the NVlabs code: ``torch_utils.persistence`` is shimmed
    for the duration of the load, so each persistent object unpickles to its
    meta dict, whose ``state`` nests tensors under ``_parameters`` /
    ``_buffers`` and children under ``_modules``; the tensors come out with
    torch's state_dict naming ("synthesis.b4.conv1.weight")."""
    import pickle
    import sys
    import types

    captured = []

    class _Stub:
        """Stands in for any class the pickle names but this process lacks."""

        def __init__(self, *args, **kwargs):
            self.args, self.kwargs = args, kwargs

        def __setstate__(self, state):
            self.__dict__.update(state if isinstance(state, dict) else {"state": state})
            captured.append(self.__dict__)

    def _reconstruct(meta):
        captured.append(meta)
        return meta

    persistence = types.ModuleType("torch_utils.persistence")
    persistence._reconstruct_persistent_obj = _reconstruct
    saved = {n: sys.modules.get(n) for n in ("torch_utils", "torch_utils.persistence")}
    saved_attr = getattr(saved["torch_utils"], "persistence", None) if saved["torch_utils"] \
        else None
    shim_root = saved["torch_utils"] or types.ModuleType("torch_utils")
    sys.modules["torch_utils"] = shim_root
    sys.modules["torch_utils.persistence"] = persistence
    shim_root.persistence = persistence

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                return _Stub

    try:
        try:
            obj = torch.load(path, map_location="cpu", weights_only=False, pickle_module=pickle)
        except Exception:
            with open(path, "rb") as f:
                obj = _Unpickler(f).load()
    finally:
        for n, mod in saved.items():
            if mod is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = mod
        if saved["torch_utils"] is not None:
            if saved_attr is None:
                if getattr(saved["torch_utils"], "persistence", None) is persistence:
                    del saved["torch_utils"].persistence
            else:
                saved["torch_utils"].persistence = saved_attr

    meta_keys = {"type", "version", "module_src", "class_name", "state"}

    def is_meta(d) -> bool:
        return isinstance(d, dict) and "state" in d and len(meta_keys & set(d)) >= 2

    def tensors_from(o, prefix=""):
        out = {}
        if isinstance(o, _Stub):
            o = o.__dict__
        if hasattr(o, "state_dict") and not isinstance(o, dict):
            try:
                return {f"{prefix}{k}": v for k, v in o.state_dict().items()}
            except Exception:
                pass
        if is_meta(o):
            return tensors_from(o["state"], prefix)
        if not isinstance(o, dict):
            o = getattr(o, "__dict__", None)
            if o is None:
                return out
        for k, v in o.items():
            if k in ("_modules", "_parameters", "_buffers"):
                out.update(tensors_from(v, prefix))  # containers add no path segment
            elif hasattr(v, "numpy") and hasattr(v, "shape"):
                out[f"{prefix}{k}"] = v
            elif isinstance(v, (dict, _Stub)) or is_meta(v):
                out.update(tensors_from(v, f"{prefix}{k}."))
            elif hasattr(v, "__dict__") and not isinstance(v, (str, bytes)):
                out.update(tensors_from(v.__dict__, f"{prefix}{k}."))
        return out

    result = {}
    if isinstance(obj, dict):
        for key in ("G_ema", "G", "generator", "gan", "D", "discriminator"):
            if key in obj:
                result[key] = tensors_from(obj[key] if isinstance(obj[key], dict)
                                           else getattr(obj[key], "__dict__", {}))
        if not result:
            result["G_ema"] = tensors_from(obj)
    for meta in captured:
        state = meta.get("state", meta)
        if isinstance(state, dict):
            t = tensors_from(state)
            if t and "G_ema" not in result:
                result["G_ema"] = t
    return result


def nvlabs_generator(nets: dict) -> dict:
    return nets.get("G_ema") or nets.get("G") or nets.get("generator") or nets.get("gan") or {}


def nvlabs_discriminator(nets: dict) -> dict:
    return nets.get("D") or nets.get("discriminator") or {}


def check_source(kind: str, sd: dict, strict: bool) -> list[str]:
    """Print the manifest report of a source; returns the problems. With
    ``strict`` any problem stops the command."""
    manifest = porting.clip_manifest_kind(sd) if kind == "clip" else MANIFEST_OF.get(kind)
    if manifest is None:
        print(f"# no manifest for kind {kind!r}: not validated")
        return []
    problems = porting.validate_state_dict(sd, manifest, strict=False)
    if not problems:
        print(f"manifest check [{manifest}]: OK ({len(sd)} keys, all accounted for)")
    for p in problems[:40]:
        print(f"manifest check [{manifest}]: {p}")
    if len(problems) > 40:
        print(f"manifest check [{manifest}]: ... and {len(problems) - 40} more")
    if problems and strict:
        raise SystemExit(f"{len(problems)} manifest problems (--strict): the checkpoint does not "
                         "match the reference architecture; drop --strict to port anyway")
    return problems


# ------------------------ modules from their variables ---------------------- #


def _channels_config(channels: dict[int, int]) -> tuple[int, int]:
    """(channel_base, channel_max) that give ``channels`` ({res: channels})
    by min(channel_base // res, channel_max)."""
    cmax = max(channels.values())
    top = max(channels)
    base = channels[top] * top
    if any(min(base // r, cmax) != c for r, c in channels.items()):
        raise ValueError(f"channel counts {channels} fit no (channel_base, channel_max)")
    return base, cmax


def _res_keys(tree: dict) -> list[int]:
    return sorted(int(k[1:]) for k in tree if re.fullmatch(r"b\d+", k))


def classifier_from_tree(tree: dict, device="cuda"):
    """A ``Classifier`` shaped as the {params, batch_stats} tree says, holding it."""
    from viscoin_tpu_torch.models.resnet import Classifier

    resnet = tree["params"]["resnet"]
    depths: dict[int, int] = {}
    for name in resnet:
        if m := re.fullmatch(r"stage(\d+)_block(\d+)", name):
            depths[int(m.group(1))] = max(depths.get(int(m.group(1)), 0), int(m.group(2)) + 1)
    stages = sorted(depths)
    model = Classifier(
        output_classes=np.asarray(tree["params"]["linear"]["bias"]).shape[0],
        embedding_size=np.asarray(resnet["embedder"]["conv"]["kernel"]).shape[-1],
        hidden_sizes=tuple(np.asarray(resnet[f"stage{i}_block0"]["conv3"]["conv"]["kernel"])
                           .shape[-1] for i in stages),
        depths=tuple(depths[i] for i in stages), device=device)
    return load_jax_tree(model, {"params": tree["params"], "batch_stats": tree["batch_stats"]})


def generator_from_tree(tree: dict, device="cuda"):
    """A ``Generator`` shaped as the {params, noise, moving_stats} tree says,
    holding it, with the float16 blocks and clamp its "config" records."""
    from viscoin_tpu_torch.models.stylegan import Generator, generator_config_from_params

    model = Generator(**generator_config_from_params(tree["params"], tree.get("config")),
                      device=device)
    return load_jax_tree(model, {k: tree[k] for k in ("params", "noise", "moving_stats")})


def discriminator_from_tree(params: dict, device="cuda", mbstd_group_size: int = 4):
    """A ``Discriminator`` shaped as its params say, holding them."""
    from viscoin_tpu_torch.models.stylegan import Discriminator

    res = _res_keys(params)
    channels = {r: np.asarray(params[f"b{r}"]["conv0"]["weight"]).shape[-1] for r in res}
    channels[4] = np.asarray(params["conv"]["weight"]).shape[-1]
    base, cmax = _channels_config(channels)
    model = Discriminator(img_resolution=max(res), channel_base=base, channel_max=cmax,
                          img_channels=np.asarray(params[f"b{max(res)}"]["fromrgb"]["weight"])
                          .shape[2], mbstd_group_size=mbstd_group_size, device=device)
    return load_jax_tree(model, {"params": params})


def viscoin_from_tree(tree: dict, device="cuda"):
    """A ``VisCoINModels`` shaped as the bundle tree ({classifier,
    concept_extractor, explainer, gan}) says, holding it."""
    from viscoin_tpu_torch.models.bundle import VisCoINModels
    from viscoin_tpu_torch.models.concept_extractor import ConceptExtractor
    from viscoin_tpu_torch.models.explainer import Explainer
    from viscoin_tpu_torch.models.stylegan import GeneratorAdapted, synthesis_config_from_params
    from viscoin_tpu_torch.utils.weights import load_jax_variables

    psi, theta, gan = tree["concept_extractor"], tree["explainer"], tree["gan"]
    shape = lambda x: np.asarray(x).shape  # noqa: E731
    n_concepts = shape(psi["conv5"]["kernel"])[-1]
    normalized = "weight_g" in theta
    mapping = gan["params"]["mapping"]
    n_layers = len([k for k in mapping if re.fullmatch(r"g1_w\d+", k)])
    z1, z2 = shape(mapping["g1_w0"])[-1], shape(mapping["g2_w0"])[-1]
    if z1 != 9 * n_concepts or z2 not in (8 * n_concepts, 9 * n_concepts):
        raise ValueError(f"the adapted mapping reads {z1} and {z2} features, not 9 and 8 or 9 "
                         f"times the {n_concepts} concepts")
    models = VisCoINModels(
        classifier=classifier_from_tree(tree["classifier"], device),
        concept_extractor=ConceptExtractor(
            n_concepts=n_concepts, latent_channels=shape(psi["conv1"]["kernel"])[-1],
            input_channels1=shape(psi["conv1"]["kernel"])[2],
            input_channels2=shape(psi["conv2"]["kernel"])[2],
            input_channels3=shape(psi["conv3"]["kernel"])[2], device=device),
        explainer=Explainer(n_concepts=n_concepts,
                            n_classes=shape(theta["bias"] if normalized
                                            else theta["linear"]["bias"])[0],
                            normalized=normalized, device=device),
        gan=GeneratorAdapted(z_dim=n_concepts, w_dim=shape(mapping["g1_w0"])[1],
                             small_adjust=z2 == 8 * n_concepts, mapping_num_layers=n_layers,
                             **synthesis_config_from_params(gan["params"]["synthesis"]),
                             device=device))
    return load_jax_variables(models, {"classifier": tree["classifier"], "psi": psi,
                                       "theta": theta, "gan": gan})


def clip_depths(sd: dict) -> tuple[int, int]:
    """(image tower blocks, text tower blocks) of an OpenAI or HF CLIP
    state_dict."""
    if porting.clip_manifest_kind(sd) == "clip_hf":
        pats = (r"vision_model\.encoder\.layers\.(\d+)\.", r"text_model\.encoder\.layers\.(\d+)\.")
    else:
        pats = (r"visual\.transformer\.resblocks\.(\d+)\.", r"transformer\.resblocks\.(\d+)\.")
    return tuple(1 + max((int(m.group(1)) for k in sd if (m := re.match(p, k))), default=-1)
                 for p in pats)


def clip_from_params(params: dict, device="cuda"):
    """A ``CLIP`` shaped as its params say (CLIP's own rule for the heads:
    width // 64), holding them."""
    from viscoin_tpu_torch.models.clip import CLIP

    shape = lambda x: np.asarray(x).shape  # noqa: E731
    visual, text = params["visual"], params["text"]
    patch = shape(visual["patch_embed"]["kernel"])[0]
    grid = math.isqrt(shape(visual["positional_embedding"])[0] - 1)
    vocab, text_width = shape(text["token_embedding"])
    width = shape(visual["class_embedding"])[0]
    model = CLIP(embedding_size=shape(visual["proj"])[1], image_width=width,
                 image_layers=len(_blocks(visual)), image_heads=max(1, width // 64),
                 patch_size=patch, image_size=grid * patch, vocab_size=vocab,
                 context_length=shape(text["positional_embedding"])[0], text_width=text_width,
                 text_layers=len(_blocks(text)), text_heads=max(1, text_width // 64),
                 device=device)
    return load_jax_tree(model, {"params": params})


def _blocks(tree: dict) -> list[str]:
    return [k for k in tree if re.fullmatch(r"block\d+", k)]


def concept2clip_from_params(params: dict, device="cuda"):
    """The Concept2CLIP MLP its params describe, holding them (both variants
    are the same three layers; this one takes its input flat)."""
    from viscoin_tpu_torch.models.concept2clip import Concept2CLIPStyleGAN

    n_in, hidden = np.asarray(params["fc0"]["kernel"]).shape
    n_out = np.asarray(params["fc2"]["kernel"]).shape[1]
    if hidden != (n_in + n_out) // 2:
        raise ValueError(f"fc0 maps {n_in} to {hidden} features: not the Concept2CLIP hidden "
                         f"size (in + out) // 2 = {(n_in + n_out) // 2}")
    model = Concept2CLIPStyleGAN(n_style_layers=1, layer_dim=n_in, clip_dim=n_out,
                                 device=device)
    return load_jax_tree(model, {"params": params})


# -------------------------------- the command ------------------------------- #


def _to_torch(sd: dict) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}


def _state_dict(obj) -> dict:
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


def port_inception_nvlabs(src: str, dst: str, device="cuda") -> dict:
    """Convert the NVlabs TorchScript detector and check the port's
    detector against it on ``device`` at 299² (where both resizes are the
    identity): the features within NVLABS_TOL of their scale, else stop.
    At 256² a larger deviation (the TF1 resize against the export's own) is
    printed as a warning. Writes the variables and ``fid_convention.json``."""
    from viscoin_tpu_torch.models.inception import make_nvlabs_fid_detector, run_torchscript

    module = torch.jit.load(src, map_location=device).eval()
    tree = porting.convert_torchscript_inception(module)
    detect = make_nvlabs_fid_detector(tree, device)
    rng = np.random.default_rng(0)
    errs = {}
    for size in (299, 256):
        x = torch.from_numpy(rng.uniform(-2.1, 2.6, (2, 3, size, size)).astype(np.float32))
        x = x.to(device)
        with torch.no_grad():
            want = run_torchscript(module, x).float()
        got = detect(x)
        errs[size] = float((got - want).abs().max() / want.abs().max().clamp_min(1e-8))
    if errs[299] > NVLABS_TOL:
        raise SystemExit(f"the ported detector deviates from the TorchScript one at 299² by "
                         f"{errs[299]:.2e} of the features' scale (limit {NVLABS_TOL:g}): the "
                         "export's layout or scaling is not the NVlabs convention; use the "
                         f"TorchScript file itself (train --fid-detector {src})")
    if errs[256] > NVLABS_TOL:
        print(f"WARNING: at 256² the ported detector deviates by {errs[256]:.2e} (the export's "
              "own resize against the TF1 convention); 299² agrees")
    print(f"checked on {device}: 299² relative deviation {errs[299]:.2e}, 256² {errs[256]:.2e}")
    ckpt.save_pytree(tree, dst, extra_files={FID_CONVENTION: json.dumps({"convention":
                                                                           "nvlabs"})})
    return tree


def port_weights(args: argparse.Namespace) -> None:
    kind, src, dst = args.kind, args.src, args.dst
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("port-weights --device cuda: no CUDA device is available; pass "
                           "--device cpu to load and check the weights on the CPU")
    if dst is None and not args.check:
        args.parser.error(f"port-weights {kind} needs DST (or --check)")
    if kind.startswith("export-"):
        if args.check:
            args.parser.error("--check applies to the porting kinds")
        return _export(kind, src, dst, device)

    if kind == "stylegan":
        nets = load_nvlabs_pickle(src)
        sd = porting.state_dict_to_numpy(nvlabs_generator(nets))
        d_sd = porting.state_dict_to_numpy(nvlabs_discriminator(nets))
        if not sd:
            raise SystemExit(f"no generator tensors in {src}: not a stylegan2-ada network "
                             "pickle with a G/G_ema entry?")
    elif kind == "inception-nvlabs":
        if args.check:
            args.parser.error("inception-nvlabs has no manifest: its check is the comparison "
                              "with the TorchScript module")
        port_inception_nvlabs(src, dst, device)
        print(f"ported inception-nvlabs: {src} -> {dst}")
        return
    else:
        obj = torch.load(src, map_location="cpu", weights_only=False)
        if kind == "viscoin":
            sd = {m: porting.state_dict_to_numpy(_state_dict(obj[m]))
                  for m in ("classifier", "concept_extractor", "explainer", "gan")}
        else:
            sd = porting.state_dict_to_numpy(_state_dict(obj))
    problems = check_source(kind, sd["classifier"] if kind == "viscoin" else sd,
                            args.strict and not args.check)
    if args.check:
        raise SystemExit(1 if problems else 0)

    if kind == "classifier":
        tree = porting.convert_torch_classifier(sd)
        classifier_from_tree(tree, device)
        ckpt.save_pytree(tree, dst)
    elif kind == "lpips":
        from viscoin_tpu_torch.models.lpips import LPIPS

        params = porting.convert_torch_lpips(sd)
        load_jax_tree(LPIPS(device=device), {"params": params})
        ckpt.save_pytree(params, dst)
    elif kind == "inception":
        from viscoin_tpu_torch.models.inception import inception_from_tree

        tree = porting.convert_torch_inception(sd)
        inception_from_tree(tree, device)
        ckpt.save_pytree(tree, dst)
    elif kind == "clip":
        convert = (porting.convert_hf_clip if porting.clip_manifest_kind(sd) == "clip_hf"
                   else porting.convert_torch_clip)
        params = convert(sd, *clip_depths(sd))
        clip_from_params(params, device)
        ckpt.save_pytree(params, dst)
    elif kind == "stylegan":
        tree = porting.convert_torch_generator(sd)
        generator_from_tree(tree, device)
        ckpt.save_pytree(tree, dst)
        if d_sd:
            d_params = porting.convert_torch_discriminator(d_sd)
            discriminator_from_tree(d_params, device)
            ckpt.save_pytree(d_params, f"{dst}.discriminator")
            print(f"ported stylegan discriminator: {src} -> {dst}.discriminator")
    elif kind == "viscoin":
        gan_sd = sd["gan"]
        num_layers = len({k.split(".")[2] for k in gan_sd if re.match(r"mapping\.s\d+\.\d+\.", k)})
        tree = {"classifier": porting.convert_torch_classifier(sd["classifier"]),
                "concept_extractor": porting.convert_torch_concept_extractor(
                    sd["concept_extractor"]),
                "explainer": porting.convert_torch_explainer(sd["explainer"]),
                "gan": porting.convert_torch_generator_adapted(gan_sd, num_layers=num_layers)}
        ckpt.save_viscoin(viscoin_from_tree(tree, device), dst)
    ckpt.wait_for_saves()
    print(f"ported {kind}: {src} -> {dst}")


def _export(kind: str, src: str, dst: str, device: torch.device) -> None:
    """A checkpoint of the port, loaded into its modules on ``device``, out
    to the reference's state_dict layout."""
    if kind == "export-viscoin":
        joint = exporting.export_viscoin_torch(ckpt.load_viscoin_bundle(src, device=device))
        torch.save({m: _to_torch(sd) for m, sd in joint.items()}, dst)
        print(f"exported the viscoin joint state_dict (load_viscoin format): {src} -> {dst}")
    elif kind == "export-classifier":
        model = classifier_from_tree(ckpt.restore_pytree(src), device)
        torch.save(_to_torch(exporting.export_classifier_torch(module_to_jax_tree(model))), dst)
        print(f"exported the classifier state_dict (reference Classifier naming): {src} -> {dst}")
    elif kind == "export-concept2clip":
        model = concept2clip_from_params(ckpt.restore_pytree(src), device)
        params = module_to_jax_tree(model)["params"]
        torch.save(_to_torch(exporting.export_concept2clip_torch(params)), dst)
        print(f"exported the concept2clip state_dict (reference nn.Sequential naming): {src} -> "
              f"{dst}")
    else:
        g = generator_from_tree(ckpt.restore_pytree(src), device)
        torch.save(_to_torch(exporting.export_generator_torch(module_to_jax_tree(g))), dst)
        d_src = f"{src}.discriminator"
        if os.path.exists(d_src):
            d = discriminator_from_tree(ckpt.restore_pytree(d_src), device)
            torch.save(_to_torch(exporting.export_discriminator_torch(
                module_to_jax_tree(d)["params"])), f"{dst}.discriminator")
            print(f"exported the stylegan discriminator: {d_src} -> {dst}.discriminator")
        print(f"exported the stylegan generator state_dict (NVlabs naming): {src} -> {dst}")
