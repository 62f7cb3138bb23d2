"""Sealed serving artifacts through ``torch.export``.

Counterpart of ``viscoin_tpu/serve/export.py``. An artifact seals each
endpoint (``classify``, ``reconstruct``, ``explain``: the functions of
``serve/engine.py::build_endpoint_fns``) as an ``ExportedProgram``, next to
the weights and a JSON manifest. Loading needs no model code: it imports
``viscoin_tpu_torch.ops``, which registers the hand-written kernels as the
operators ``viscoin::bias_act``, ``viscoin::bias_act_grad`` and
``viscoin::upfirdn2d`` that the programs call, and none of
``viscoin_tpu_torch.models``. On the card a loaded program launches those
kernels (and counts their launches) as the live engine does.

Layout::

    <path>/manifest.json     batch size, resolution, compute dtype, endpoints,
                             torch version, platforms, the device traced on
    <path>/variables.npz     the weights, once, under the JAX package's flat
                             "a/b/c" keys and layouts (classifier, psi, theta,
                             gan); bf16 leaves stored as fp32 (exact) and cast
                             back at load
    <path>/<endpoint>.pt2    torch.export.save of the endpoint's program

**Weights once.** An ``ExportedProgram`` carries the state it was traced
with, so three programs saved as traced would store ResNet-50, Psi, Theta
and G three times. Here the loader rebinds them: each program is traced over
the modules, then saved with its state dict on the ``meta`` device (shapes
and types, no data), so it holds the graph and the generator's FIR taps
only. The loader reads ``variables.npz`` once, rebuilds the state dict
(``utils/weights.py::jax_to_state_dict``) on its device and binds those
tensors into every program, which share them. A call then takes the images
alone, as the live engine's does.

**Devices.** ``platforms`` lists the devices the artifact serves ("cuda",
"cpu"). It is traced once, on the first; the registered operators dispatch
by device, so the same program runs on the other after
``torch.export.passes.move_to_device_pass`` at load. Loading on a device it
does not list raises.

**Torch version.** The programs are traced below autograd with torch's own
tracer (:func:`_trace`, a private entry point of ``torch.export``), whose
graphs and serialized form are not promised to carry across releases. The
manifest records the torch version that wrote the artifact, and loading it
with another release (the build tag after "+" aside) raises: export the
bundle again with that release.

**Determinism.** ``explain`` differentiates under cuDNN's deterministic
algorithms (``utils/gradcam.py``), a global switch that a traced program
does not carry: the loaded engine sets it around each ``explain`` call, as
the live engine's GradCAM does, so two calls give the same maps.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os

import numpy as np
import torch

import viscoin_tpu_torch.ops  # noqa: F401 - registers the viscoin:: operators
from viscoin_tpu_torch.serve.batching import COMPUTE_DTYPES, prepare_image, run_padded
from viscoin_tpu_torch.utils import cudnn
from viscoin_tpu_torch.utils.weights import jax_to_state_dict, module_to_jax_tree

MANIFEST = "manifest.json"
WEIGHTS = "variables.npz"
ENDPOINTS = ("classify", "reconstruct", "explain")
PLATFORMS = ("cuda", "cpu")


def _flat(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


def _unflat(flat) -> dict:
    out: dict = {}
    for key in flat:
        node = out
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = flat[key]
    return out


def _jax_variables(models) -> dict:
    """The weights as the JAX engine's variables: classifier {params,
    batch_stats}, psi and theta (params), gan {params, noise}; fp32 numpy."""
    return {"classifier": module_to_jax_tree(models.classifier),
            "psi": module_to_jax_tree(models.concept_extractor)["params"],
            "theta": module_to_jax_tree(models.explainer)["params"],
            "gan": module_to_jax_tree(models.gan)}


def _weights(variables: dict, dtype: torch.dtype, device) -> dict[str, torch.Tensor]:
    """The weights the programs are bound to, from the JAX-layout variables:
    the VisCoINModels state dict, float leaves cast to the compute dtype."""
    return {k: torch.from_numpy(v).to(device=device,
                                      dtype=dtype if v.dtype.kind == "f" else None)
            for k, v in jax_to_state_dict(variables).items()}


def _release(version: str) -> str:
    """A torch version without its build tag: "2.11.0+cu128" -> "2.11.0"."""
    return version.split("+")[0]


def _device(name) -> torch.device:
    """A device with its index (a CUDA device without one is the current)."""
    device = torch.device(name)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class _Program(torch.nn.Module):
    """One endpoint function over the modules it closes over (their state
    dict keys under ``models.``)."""

    def __init__(self, models, fn):
        super().__init__()
        self.models = models
        self.fn = fn

    def forward(self, images_u8):
        return self.fn(images_u8)


def _bind(program, weights: dict[str, torch.Tensor]) -> None:
    """Put ``weights`` (the VisCoINModels state dict, or its ``meta``
    shadow) in the program's state dict, as Parameters where it had them."""
    state = program.state_dict
    if state.keys() != {f"models.{k}" for k in weights}:
        raise KeyError("the weights do not match the program's state: "
                       f"{sorted(state.keys() ^ {f'models.{k}' for k in weights})[:10]}")
    for key, t in weights.items():
        old = state[f"models.{key}"]
        if (old.shape, old.dtype) != (t.shape, t.dtype):
            raise ValueError(f"{key}: program {tuple(old.shape)} {old.dtype}, weights "
                             f"{tuple(t.shape)} {t.dtype}")
        if isinstance(old, torch.nn.Parameter):
            t = torch.nn.Parameter(t, requires_grad=False)
        state[f"models.{key}"] = t


def _trace(module: torch.nn.Module, args: tuple):
    """``torch.export`` of ``module`` on ``args``, traced below autograd (as
    AOTAutograd traces a backward), where the program is an ATen graph. The
    default tracer works above autograd: it turns every tensor a backward
    taken inside the program (explain's GradCAM) reads from autograd's saved
    state into a constant of the trace, which it then refuses, and its graph
    checks the type of every ``.to`` at run time (on an H100's host that
    artifact's fp32 classify took 17.0 ms per batch of 8 against the live
    engine's 9.2, PERF.md)."""
    from torch.export._trace import _export

    return _export(module, args, strict=False, pre_dispatch=False)


def export_serving(
    models,
    path: str,
    batch_size: int = 8,
    compute_dtype: str = "float32",
    endpoints: tuple[str, ...] = ENDPOINTS,
    platforms: tuple[str, ...] | None = None,
) -> dict:
    """Export serving endpoints as a sealed artifact in ``path``.

    Args:
        models: a VisCoINModels with weights loaded (not modified: the
            export casts a copy to ``compute_dtype``).
        platforms: the devices the artifact serves, from "cuda" and "cpu";
            default the device ``models`` lie on. The programs are traced
            on the first, which must be present.

    Returns the manifest dict.
    """
    from viscoin_tpu_torch.serve.engine import build_endpoint_fns

    unknown = set(endpoints) - set(ENDPOINTS)
    if unknown or not endpoints:
        raise ValueError(f"unknown endpoints {sorted(unknown)}; available: {list(ENDPOINTS)}")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}")
    platforms = tuple(platforms or (next(models.parameters()).device.type,))
    if not platforms or set(platforms) - set(PLATFORMS):
        raise ValueError(f"platforms must be taken from {list(PLATFORMS)}, got {platforms}")
    if platforms[0] == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("export_serving(platforms=('cuda', ...)): no CUDA device is "
                           "available to trace on")
    device = _device(platforms[0])
    dtype = COMPUTE_DTYPES[compute_dtype]
    sealed_models = copy.deepcopy(models).to(device=device, dtype=dtype)
    sealed_models.eval().requires_grad_(False)
    resolution = sealed_models.gan.img_resolution

    variables = _jax_variables(sealed_models)
    weights = _weights(variables, dtype, device)
    own = sealed_models.state_dict()
    if weights.keys() != own.keys():
        raise KeyError("the JAX layout does not round-trip the modules' state: "
                       f"{sorted(weights.keys() ^ own.keys())[:10]}")

    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, WEIGHTS), **_flat(variables))
    fns = build_endpoint_fns(sealed_models, compute_dtype)
    images = torch.zeros((batch_size, resolution, resolution, 3), dtype=torch.uint8,
                         device=device)
    shadow = {k: t.to("meta") for k, t in weights.items()}
    for name in endpoints:
        program = _trace(_Program(sealed_models, fns[name]), (images,))
        _bind(program, shadow)  # the weights are variables.npz's, bound at load
        program.example_inputs = None
        torch.export.save(program, os.path.join(path, f"{name}.pt2"))

    manifest = {
        "batch_size": int(batch_size),
        "resolution": int(resolution),
        "compute_dtype": compute_dtype,
        "endpoints": list(endpoints),
        "torch_version": torch.__version__,
        "platforms": list(platforms),
        "traced_on": str(device),
    }
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class ExportedEngine:
    """Padded fixed-batch inference over a sealed artifact: the call surface
    of ``InferenceEngine``'s ``classify``, ``reconstruct``, ``explain`` and
    ``prepare_image`` (no ``amplify``: it needs model code), rebuilt from
    the artifact directory alone, on ``device`` ("cuda" by default)."""

    def __init__(self, path: str, device="cuda"):
        with open(os.path.join(path, MANIFEST)) as f:
            self.manifest = json.load(f)
        exported_with = self.manifest["torch_version"]
        if _release(exported_with) != _release(torch.__version__):
            raise ValueError(f"the artifact at {path} was exported with torch {exported_with}, "
                             f"this is torch {torch.__version__}: export the bundle again "
                             "with this release (`export-serving`)")
        device = torch.device(device)
        platforms = self.manifest["platforms"]
        if device.type not in platforms:
            raise ValueError(f"the artifact at {path} was exported for {platforms}, not "
                             f"{device.type!r}")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ExportedEngine(device='cuda'): no CUDA device is available; "
                               "pass device='cpu' for an artifact exported for the CPU")
        self.device = _device(device)
        self.batch_size = int(self.manifest["batch_size"])
        self.resolution = int(self.manifest["resolution"])
        self.compute_dtype = self.manifest["compute_dtype"]
        self.endpoints = tuple(self.manifest["endpoints"])
        with np.load(os.path.join(path, WEIGHTS)) as data:
            variables = _unflat({k: data[k] for k in data.files})
        self.weights = _weights(variables, COMPUTE_DTYPES[self.compute_dtype], self.device)
        moved = str(self.device) != self.manifest["traced_on"]
        self._fns = {}
        for name in self.endpoints:
            program = torch.export.load(os.path.join(path, f"{name}.pt2"))
            _bind(program, self.weights)
            if moved:
                from torch.export.passes import move_to_device_pass

                program = move_to_device_pass(program, self.device)
            self._fns[name] = program.module()

    def _run(self, name: str, chunk: np.ndarray) -> dict:
        if self.device.type == "cuda":
            ctx = torch.cuda.device(self.device)
        else:
            ctx = contextlib.nullcontext()
        if name == "explain":  # looked up at call time, as utils/gradcam.py does
            switch = cudnn.deterministic_cudnn()
        else:
            switch = contextlib.nullcontext()
        with ctx, switch, torch.inference_mode():
            out = self._fns[name](torch.from_numpy(chunk).to(self.device))
        return {k: v.cpu().numpy() for k, v in out.items()}

    def _call_endpoint(self, name: str, images_u8: np.ndarray) -> dict:
        if name not in self._fns:
            raise KeyError(f"endpoint {name!r} not in artifact (has {sorted(self._fns)})")
        return run_padded(lambda c: self._run(name, c), images_u8, self.batch_size)

    def classify(self, images_u8: np.ndarray) -> dict:
        return self._call_endpoint("classify", images_u8)

    def reconstruct(self, images_u8: np.ndarray) -> dict:
        return self._call_endpoint("reconstruct", images_u8)

    def explain(self, images_u8: np.ndarray) -> dict:
        return self._call_endpoint("explain", images_u8)

    def prepare_image(self, img_u8: np.ndarray) -> np.ndarray:
        return prepare_image(img_u8, self.resolution)

    def warmup(self):
        """Run every endpoint of the artifact once on a dummy batch."""
        dummy = np.zeros((self.batch_size, self.resolution, self.resolution, 3), np.uint8)
        for name in self.endpoints:
            self._call_endpoint(name, dummy)
        return self


def load_exported(path: str, device="cuda") -> ExportedEngine:
    """Load a sealed serving artifact (no model code involved)."""
    return ExportedEngine(path, device=device)
