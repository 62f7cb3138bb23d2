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
"""

from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch

from viscoin_tpu_torch.data.transforms import denormalize, device_preprocess, host_test_transform
from viscoin_tpu_torch.eval.viscoin import amplify_concepts, make_amplify_fns
from viscoin_tpu_torch.models.bundle import VisCoINModels
from viscoin_tpu_torch.models.concept_extractor import max_pool_concepts
from viscoin_tpu_torch.parallel.mesh import pad_to_multiple
from viscoin_tpu_torch.utils.gradcam import psi_gradcams

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def prepare_image(img_u8: np.ndarray, resolution: int) -> np.ndarray:
    """Arbitrary-size HWC u8 -> the model resolution with the eval geometry
    (Resize(short = size / 0.875) + CenterCrop)."""
    img_u8 = np.asarray(img_u8, np.uint8)
    if img_u8.shape[:2] != (resolution, resolution):
        img_u8 = host_test_transform(img_u8, size=resolution, resize_to=int(resolution / 0.875))
    return img_u8


def run_padded(call, images_u8: np.ndarray, batch_size: int) -> dict:
    """Chunk a u8 batch to ``batch_size``, pad the last chunk, drop the
    padding rows from each output and concatenate. ``call(chunk) -> dict``
    runs one fixed-size device batch and returns numpy arrays."""
    images_u8 = np.asarray(images_u8, np.uint8)
    if images_u8.ndim == 3:
        images_u8 = images_u8[None]
    n = images_u8.shape[0]
    if n == 0:
        raise ValueError("empty image batch")
    chunks: list[dict] = []
    for start in range(0, n, batch_size):
        chunk, rows = pad_to_multiple(images_u8[start: start + batch_size], batch_size)
        out = call(chunk)
        chunks.append({k: v[:rows] for k, v in out.items()})
    return {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}


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
        self._amplify_fns = make_amplify_fns(self.models)

    def prepare_image(self, img_u8: np.ndarray) -> np.ndarray:
        return prepare_image(img_u8, self.resolution)

    # ------------------------------ device side ----------------------------- #

    def _split(self, fn, chunk: np.ndarray) -> dict:
        """``fn(models, device, part) -> {name: tensor}`` on every replica's
        equal part of the device batch, each under its device (the kernels
        launch on the current one); every part is issued before any is read
        back, then the outputs are concatenated in order."""
        parts = np.split(chunk, len(self.replicas))
        outs = []
        for (device, models), part in zip(self.replicas, parts):
            ctx = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
            with ctx:
                outs.append(fn(models, device, part))
        return {k: np.concatenate([o[k].cpu().numpy() for o in outs]) for k in outs[0]}

    def _encode(self, models, device, chunk: np.ndarray):
        images = torch.from_numpy(chunk).to(device)
        x = device_preprocess(images).to(self.dtype)
        logits, hidden = models.classify(x)
        phi, phi_prime = models.extract_concepts(hidden)
        return logits.float(), phi, phi_prime, models.explain(phi).float()

    @torch.inference_mode()
    def _classify(self, models, device, chunk: np.ndarray) -> dict:
        logits, phi, _, expl_logits = self._encode(models, device, chunk)
        return {
            "logits": logits,
            "probas": torch.softmax(logits, dim=-1),
            "expl_logits": expl_logits,
            "expl_probas": torch.softmax(expl_logits, dim=-1),
            "concepts": max_pool_concepts(phi).float(),
        }

    @torch.inference_mode()
    def _reconstruct(self, models, device, chunk: np.ndarray) -> dict:
        logits, phi, phi_prime, expl_logits = self._encode(models, device, chunk)
        recon = models.reconstruct(phi, phi_prime, noise_mode="const")
        # The generator reconstructs in ImageNet-normalized space; invert to
        # display range and quantize on the device (3 bytes/px to the host).
        img01 = denormalize(recon.float()).clamp(0.0, 1.0)
        recon_u8 = torch.round(img01 * 255.0).to(torch.uint8).permute(0, 2, 3, 1)
        return {"reconstruction_u8": recon_u8, "preds": logits.argmax(dim=-1),
                "expl_preds": expl_logits.argmax(dim=-1)}

    def _explain(self, models, device, chunk: np.ndarray) -> dict:
        # Not under inference mode: the backward needs autograd. The
        # classifier runs without a graph; only the taps require a gradient.
        images = torch.from_numpy(chunk).to(device)
        x = device_preprocess(images).to(self.dtype)
        with torch.no_grad():
            logits, hidden = models.classify(x)
        heatmaps, phi, expl_logits = psi_gradcams(models, hidden[-3:])
        logits = logits.float()
        return {"logits": logits, "expl_logits": expl_logits, "preds": logits.argmax(dim=-1),
                "expl_preds": expl_logits.argmax(dim=-1),
                "concepts": max_pool_concepts(phi).float(),
                **{f"heatmap_{name}": m for name, m in heatmaps.items()}}

    # ------------------------------- endpoints ------------------------------ #

    def classify(self, images_u8: np.ndarray) -> dict:
        """u8 batch -> classifier and explainer logits/probas, pooled concepts."""
        return run_padded(lambda c: self._split(self._classify, c), images_u8, self.batch_size)

    def reconstruct(self, images_u8: np.ndarray) -> dict:
        """u8 batch -> u8 reconstructions G(Psi(f(x))) and both predictions."""
        return run_padded(lambda c: self._split(self._reconstruct, c), images_u8,
                          self.batch_size)

    def explain(self, images_u8: np.ndarray) -> dict:
        """u8 batch -> GradCAM heatmaps of Psi's conv1..conv5 (``heatmap_conv1``
        ... (B, h, w) fp32) for the explainer's cross-entropy at its own
        prediction, both predictions, the logits and pooled concepts."""
        return run_padded(lambda c: self._split(self._explain, c), images_u8, self.batch_size)

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
