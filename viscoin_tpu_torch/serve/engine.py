"""Inference endpoints over a VisCoIN bundle, on the card.

Counterpart of ``viscoin_tpu/serve/engine.py``. Requests of any size are
chunked into fixed device batches; a short last chunk is padded by repeating
its first row, and the padded rows are dropped on the host. Outputs are
numpy arrays with the JAX engine's keys, shapes and layouts (the
reconstruction is (N, H, W, 3) uint8). ``explain`` differentiates Psi and
Theta with respect to Psi's taps (``utils/gradcam.py``), in the compute
dtype, as JAX does. ``amplify`` takes one image and runs its 2M + 1
variants as one device batch.

The engine runs on ``device`` ("cuda" by default) and raises at
construction when that device is a CUDA device and none is present; it
never carries on on the CPU unless asked for ``device="cpu"``. With
``devices`` (data parallelism, as the JAX engine's mesh) it keeps one
replica per device, splits each padded device batch into equal parts, one
per replica, and concatenates the outputs; ``amplify`` stays on the first.

The batched endpoints are the tensor functions of :func:`build_endpoint_fns`,
which ``serve/export.py`` seals into an artifact.
"""

from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch

from viscoin_tpu_torch.data.transforms import denormalize, device_preprocess
from viscoin_tpu_torch.eval.viscoin import amplify_concepts, make_amplify_fns
from viscoin_tpu_torch.models.bundle import VisCoINModels
from viscoin_tpu_torch.models.concept_extractor import max_pool_concepts
from viscoin_tpu_torch.parallel.mesh import pad_to_multiple  # noqa: F401 - re-exported
from viscoin_tpu_torch.serve.batching import COMPUTE_DTYPES, prepare_image, run_padded
from viscoin_tpu_torch.utils.gradcam import psi_gradcams


def build_endpoint_fns(models: VisCoINModels, compute_dtype: str = "float32") -> dict:
    """The pure tensor functions behind the engine, ``fn(images_u8) ->
    {name: tensor}``: a (B, H, W, 3) uint8 batch on the models' device in,
    device tensors out. ``models`` is cast to ``compute_dtype`` already.
    :mod:`~viscoin_tpu_torch.serve.export` traces these very functions, so
    the live engine and a sealed artifact compute the same graph. They set
    no grad mode of their own: the engine runs classify and reconstruct
    under ``torch.inference_mode`` and explain (a backward) outside it."""
    dtype = COMPUTE_DTYPES[compute_dtype]

    def encode(images_u8):
        x = device_preprocess(images_u8).to(dtype)
        logits, hidden = models.classify(x)
        phi, phi_prime = models.extract_concepts(hidden)
        return logits.float(), phi, phi_prime, models.explain(phi).float()

    def classify(images_u8):
        """u8 batch -> classifier and explainer logits/probas, pooled concepts."""
        logits, phi, _, expl_logits = encode(images_u8)
        return {
            "logits": logits,
            "probas": torch.softmax(logits, dim=-1),
            "expl_logits": expl_logits,
            "expl_probas": torch.softmax(expl_logits, dim=-1),
            "concepts": max_pool_concepts(phi).float(),
        }

    def reconstruct(images_u8):
        """u8 batch -> u8 reconstructions G(Psi(f(x))) and both predictions."""
        logits, phi, phi_prime, expl_logits = encode(images_u8)
        recon = models.reconstruct(phi, phi_prime, noise_mode="const")
        # The generator reconstructs in ImageNet-normalized space; invert to
        # display range and quantize on the device (3 bytes/px to the host).
        img01 = denormalize(recon.float()).clamp(0.0, 1.0)
        recon_u8 = torch.round(img01 * 255.0).to(torch.uint8).permute(0, 2, 3, 1)
        return {"reconstruction_u8": recon_u8, "preds": logits.argmax(dim=-1),
                "expl_preds": expl_logits.argmax(dim=-1)}

    def explain(images_u8):
        """u8 batch -> GradCAM maps of Psi's convs (utils/gradcam.py). The
        classifier runs without a graph; only the taps require a gradient."""
        x = device_preprocess(images_u8).to(dtype)
        with torch.no_grad():
            logits, hidden = models.classify(x)
        heatmaps, phi, expl_logits = psi_gradcams(models, hidden[-3:])
        logits = logits.float()
        return {"logits": logits, "expl_logits": expl_logits, "preds": logits.argmax(dim=-1),
                "expl_preds": expl_logits.argmax(dim=-1),
                "concepts": max_pool_concepts(phi).float(),
                **{f"heatmap_{name}": m for name, m in heatmaps.items()}}

    return {"classify": classify, "reconstruct": reconstruct, "explain": explain}


class InferenceEngine:
    """Padded fixed-batch inference over a bundle.

    Args:
        models: a VisCoINModels with weights loaded. The engine keeps its own
            copy, moved to ``device`` and cast once to ``compute_dtype``.
        batch_size: the device batch; requests are chunked and padded to it.
        compute_dtype: "float32" or "bfloat16". Logits, probabilities and
            concept activations always come out fp32.
        device: "cuda" (default) or "cpu".
        devices: data parallelism: one replica on each of these devices
            (``device`` is then the first); each device batch splits into
            equal parts over them, so ``batch_size`` must divide by their
            count, as the JAX engine's by its mesh.
    """

    def __init__(self, models: VisCoINModels, batch_size: int = 8,
                 compute_dtype: str = "float32", device="cuda", devices=None):
        devices = [torch.device(d) for d in (devices or [device])]
        if any(d.type == "cuda" for d in devices) and not torch.cuda.is_available():
            raise RuntimeError("InferenceEngine(device='cuda'): no CUDA device is available; "
                               "pass device='cpu' to run the plain versions on the CPU")
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}")
        self.batch_size = int(batch_size)
        if self.batch_size % len(devices):
            raise ValueError(f"batch_size {self.batch_size} must divide by the {len(devices)} "
                             "devices")
        self.device = devices[0]
        self.compute_dtype = compute_dtype
        self.dtype = COMPUTE_DTYPES[compute_dtype]
        self.resolution = models.gan.img_resolution
        self.replicas = []
        for d in devices:
            replica = copy.deepcopy(models).to(device=d, dtype=self.dtype)
            self.replicas.append((d, replica.eval().requires_grad_(False)))
        self.models = self.replicas[0][1]
        self._fns = [build_endpoint_fns(m, compute_dtype) for _, m in self.replicas]
        self._amplify_fns = make_amplify_fns(self.models)

    def prepare_image(self, img_u8: np.ndarray) -> np.ndarray:
        return prepare_image(img_u8, self.resolution)

    # ------------------------------ device side ----------------------------- #

    def _split(self, name: str, chunk: np.ndarray) -> dict:
        """Endpoint ``name`` on every replica's equal part of the device
        batch, each under its device (the kernels launch on the current one);
        every part is issued before any is read back, then the outputs are
        concatenated in order. classify and reconstruct run under inference
        mode; explain differentiates, so it does not."""
        parts = np.split(chunk, len(self.replicas))
        grad_mode = contextlib.nullcontext if name == "explain" else torch.inference_mode
        outs = []
        for (device, _), fns, part in zip(self.replicas, self._fns, parts):
            ctx = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
            with ctx, grad_mode():
                outs.append(fns[name](torch.from_numpy(part).to(device)))
        return {k: np.concatenate([o[k].cpu().numpy() for o in outs]) for k in outs[0]}

    # ------------------------------- endpoints ------------------------------ #

    def classify(self, images_u8: np.ndarray) -> dict:
        """u8 batch -> classifier and explainer logits/probas, pooled concepts."""
        return run_padded(lambda c: self._split("classify", c), images_u8, self.batch_size)

    def reconstruct(self, images_u8: np.ndarray) -> dict:
        """u8 batch -> u8 reconstructions G(Psi(f(x))) and both predictions."""
        return run_padded(lambda c: self._split("reconstruct", c), images_u8, self.batch_size)

    def explain(self, images_u8: np.ndarray) -> dict:
        """u8 batch -> GradCAM heatmaps of Psi's conv1..conv5 (``heatmap_conv1``
        ... (B, h, w) fp32) for the explainer's cross-entropy at its own
        prediction, both predictions, the logits and pooled concepts."""
        return run_padded(lambda c: self._split("explain", c), images_u8, self.batch_size)

    def amplify(self, image_u8: np.ndarray, selection, multipliers, seed: int = 0):
        """One image's concept amplification: every variant (2 x len(multipliers)
        + 1 images) in one generator + classifier pass
        (``eval/viscoin.py::amplify_concepts``); the random concepts come
        from ``seed``."""
        u8 = np.ascontiguousarray(self.prepare_image(image_u8)[None])
        x = device_preprocess(torch.from_numpy(u8).to(self.device))[0]
        return amplify_concepts(x, self.models, selection, multipliers,
                                rng=np.random.default_rng(seed), fns=self._amplify_fns)

    def warmup(self):
        """Run every batched endpoint once on a dummy batch."""
        dummy = np.zeros((self.batch_size, self.resolution, self.resolution, 3), np.uint8)
        self.classify(dummy)
        self.reconstruct(dummy)
        self.explain(dummy)
        return self
