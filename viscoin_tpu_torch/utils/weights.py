"""Carry the JAX package's variables into the port's modules.

:func:`load_jax_variables` takes the dict the JAX ``InferenceEngine`` builds
from a bundle (``classifier`` {params, batch_stats}, ``psi``, ``theta``,
``gan`` {params, noise}) with numpy (or array-like) leaves;
:func:`load_jax_tree` takes one module's variables ({collection: tree}, for
example a frozen ``Generator``'s {params, moving_stats, noise} or
{"params": lpips_params}). The port's modules mirror the JAX module paths,
so each leaf maps by its path, across every collection; only the layout
changes (the same conventions as the JAX package's torch exporters):

  * conv kernels HWIO -> OIHW (flax ``kernel`` and StyleGAN ``weight``);
  * flax ``Dense`` kernels (in, out) -> (out, in); StyleGAN's equalized-LR
    weights are stored (out, in) already and pass through;
  * BatchNorm ``scale`` -> ``weight``, ``mean``/``var`` ->
    ``running_mean``/``running_var`` (plus a zero ``num_batches_tracked``);
  * the synthesis ``const`` HWC -> CHW; the ``noise_const`` and ``w_avg``
    buffers pass.

Both raise on any key missing or left over on either side.

:func:`module_to_jax_tree` and :func:`bundle_to_jax_tree` are the inverse: a
module's parameters and buffers back to the JAX collections, names and
layouts, decided by the module that owns each leaf (``nn.Conv2d`` and
``nn.Linear`` hold flax ``kernel``s, ``nn.BatchNorm2d`` its ``scale`` and
``batch_stats``, ``nn.LayerNorm`` its ``scale``; the StyleGAN modules keep
``weight``; ``noise_const`` buffers form the ``noise`` collection and
``w_avg`` the ``moving_stats``). ``num_batches_tracked`` has no JAX leaf and
is dropped.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

# Variables key of the JAX engine -> submodule of VisCoINModels.
SUBMODULES = {"classifier": "classifier", "psi": "concept_extractor",
              "theta": "explainer", "gan": "gan"}
_RENAME = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
           "var": "running_var"}


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, object]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, path + "."))
        else:
            out[path] = value
    return out


def _convert_leaf(name: str, value) -> tuple[str, np.ndarray]:
    arr = np.asarray(value)
    if arr.dtype.kind == "f" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    if name in ("kernel", "weight") and arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    elif name == "kernel" and arr.ndim == 2:
        arr = arr.T  # Dense (in, out) -> (out, in)
    elif name == "const":
        arr = arr.transpose(2, 0, 1)  # HWC -> CHW
    return _RENAME.get(name, name), np.array(arr, order="C")  # keeps 0-d leaves 0-d


def tree_to_state_dict(variables: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """One module's JAX variables ({collection: tree}) -> its state_dict
    (numpy), every key under ``prefix``."""
    sd: dict[str, np.ndarray] = {}
    for collection in variables.values():
        for path, value in _flatten(collection).items():
            parent, _, leaf = path.rpartition(".")
            name, arr = _convert_leaf(leaf, value)
            sd[f"{prefix}{parent + '.' if parent else ''}{name}"] = arr
    for key in list(sd):
        if key.endswith(".running_mean"):
            sd[key[: -len("running_mean")] + "num_batches_tracked"] = np.zeros((), np.int64)
    return sd


def jax_to_state_dict(variables: Mapping) -> dict[str, np.ndarray]:
    """The JAX engine's variables dict -> a VisCoINModels state_dict (numpy).
    Keys of ``variables`` that are absent give no entries."""
    sd: dict[str, np.ndarray] = {}
    for key, module in SUBMODULES.items():
        if key not in variables:
            continue
        tree = variables[key]
        if key in ("psi", "theta"):
            tree = {"params": tree}
        sd.update(tree_to_state_dict(tree, f"{module}."))
    return sd


def load_jax_variables(models: nn.Module, variables: Mapping) -> nn.Module:
    """Fill ``models`` (a VisCoINModels) in place from the JAX variables.

    Raises if a key is missing on either side or a shape differs."""
    return _load(models, jax_to_state_dict(variables))


def load_jax_tree(module: nn.Module, variables: Mapping) -> nn.Module:
    """Fill ``module`` in place from its JAX variables ({collection: tree}).

    Raises if a key is missing on either side or a shape differs."""
    return _load(module, tree_to_state_dict(variables))


def _jax_leaf(owner: nn.Module, name: str, t: torch.Tensor):
    """(collection, JAX leaf name, tensor in the JAX layout, a view), or None
    for a leaf JAX does not have."""
    if isinstance(owner, nn.BatchNorm2d):
        return {"weight": ("params", "scale", t), "bias": ("params", "bias", t),
                "running_mean": ("batch_stats", "mean", t),
                "running_var": ("batch_stats", "var", t)}.get(name)
    if isinstance(owner, nn.LayerNorm):
        return "params", "scale" if name == "weight" else name, t
    if isinstance(owner, (nn.Conv2d, nn.Linear)) and name == "weight":
        return "params", "kernel", t.permute(2, 3, 1, 0) if t.ndim == 4 else t.T
    if name == "noise_const":
        return "noise", name, t
    if name == "w_avg":
        return "moving_stats", name, t
    if name == "weight" and t.ndim == 4:
        return "params", name, t.permute(2, 3, 1, 0)  # OIHW -> HWIO
    if name == "const":
        return "params", name, t.permute(1, 2, 0)  # CHW -> HWC
    return "params", name, t


@torch.no_grad()
def module_to_jax_tree(module: nn.Module) -> dict[str, dict]:
    """A module's variables as the JAX package holds them: {collection:
    nested dict} with fp32 numpy leaves, copied to the host (the layouts
    change on the module's device, so a card's weights cross once)."""
    tree: dict[str, dict] = {}
    owners = dict(module.named_modules())
    leaves = list(module.named_parameters()) + list(module.named_buffers())
    for path, t in leaves:
        parent, _, name = path.rpartition(".")
        leaf = _jax_leaf(owners[parent], name, t.detach())
        if leaf is None:
            continue
        collection, jname, view = leaf
        node = tree.setdefault(collection, {})
        for part in filter(None, parent.split(".")):
            node = node.setdefault(part, {})
        node[jname] = view.float().contiguous().to("cpu", copy=True).numpy()
    return tree


def bundle_to_jax_tree(models: nn.Module) -> dict[str, dict]:
    """A VisCoINModels as the JAX package's checkpoint tree: ``classifier``
    {params, batch_stats}, ``concept_extractor`` and ``explainer`` (params
    only), ``gan`` {params, noise}."""
    tree = {}
    for key, module in (("classifier", models.classifier), ("psi", models.concept_extractor),
                        ("theta", models.explainer), ("gan", models.gan)):
        variables = module_to_jax_tree(module)
        if key in ("psi", "theta"):
            variables = variables["params"]
        tree[SUBMODULES[key]] = variables
    return tree


@torch.no_grad()
def _load(module: nn.Module, sd: dict[str, np.ndarray]) -> nn.Module:
    own = module.state_dict()
    missing, unexpected = sorted(own.keys() - sd.keys()), sorted(sd.keys() - own.keys())
    if missing or unexpected:
        raise KeyError(f"JAX variables do not match the modules: missing {missing[:10]}, "
                       f"unexpected {unexpected[:10]}")
    for key, arr in sd.items():
        target = own[key]
        if tuple(target.shape) != arr.shape:
            raise ValueError(f"{key}: module shape {tuple(target.shape)} != JAX {arr.shape}")
        target.copy_(torch.from_numpy(arr))
    return module
