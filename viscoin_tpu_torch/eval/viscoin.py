"""VisCoIN ensemble evaluation, concept amplification and the faithfulness probe.

Counterpart of ``viscoin_tpu/eval/viscoin.py``:

  * :func:`test_viscoin` runs one fixed-shape batch function
    (:func:`make_test_step`) over a test loader; each batch returns masked
    per-sample sums, which reach the host in one transfer, so the metrics
    are exact averages over the valid samples whatever the batch size or
    the padding of the last batch. FID features, when a detector is given,
    accumulate on the host in :class:`FeatureStats`.
  * :func:`amplify_concepts` runs every variant (M multipliers on the best
    concepts, M on random ones, and the zeroed default) through one
    generator + classifier call of 2M + 1 images.
  * :func:`faithfulness_probe` is the training loop's 200-image probe as
    fixed 32-image chunks (the last one padded by repetition) of one pass:
    the explainer's probability, on the reconstruction, of the class it
    predicted on the original.

Every generator pass uses ``noise_mode="const"``. The functions run on the
device and in the dtype of the bundle's parameters, under ``no_grad``, and
return numpy; images come back in the JAX package's HWC layout.

With a data-parallel ``mesh`` (``parallel/mesh.py``) every rank runs its
shard of each global batch: the metric sums are all-reduced and the FID
features gathered, padding rows masked, so every rank returns the numbers
of one process over the whole loader. On a 2-D mesh each data shard's
images are also split along H over its model ranks (``parallel/spatial.py``):
the metrics are whole within a model group and summed over the data axis
only, and for FID each model rank gathers the batch's rows and runs the
detector on its 1 / model of the batch, so every image counts once.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal, TypedDict

import numpy as np
import torch
import torch.nn.functional as F

from viscoin_tpu_torch.data.loader import pad_batch
from viscoin_tpu_torch.data.transforms import device_preprocess
from viscoin_tpu_torch.eval.fid import FeatureStats, fid_from_stats
from viscoin_tpu_torch.models.bundle import VisCoINModels
from viscoin_tpu_torch.models.concept_extractor import max_pool_concepts
from viscoin_tpu_torch.parallel import spatial as S
from viscoin_tpu_torch.parallel.mesh import all_gather_batch, all_sum
from viscoin_tpu_torch.utils.types import TestingResults


class ThresholdSelection(TypedDict):
    method: Literal["threshold"]
    threshold: float


class TopKSelection(TypedDict):
    method: Literal["top_k"]
    k: int


class IndicesSelection(TypedDict):
    method: Literal["indices"]
    indices: list[int]


Selection = ThresholdSelection | TopKSelection | IndicesSelection

METRIC_KEYS = ("acc_loss", "cr_loss", "of_loss", "lp_loss", "rec_loss_l1", "rec_loss_l2",
               "preds_overlap", "correct_preds", "correct_expl_preds", "n_valid")
PROBE_BATCH = 32


def _placement(models: torch.nn.Module) -> tuple[torch.device, torch.dtype]:
    p = next(models.parameters())
    return p.device, p.dtype


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; on a CUDA device through pinned memory."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _encode(models: VisCoINModels, x: torch.Tensor, spatial=None):
    """f -> Psi -> Theta on a preprocessed batch: (phi, phi', explainer
    logits); ``spatial``: ``x`` is this rank's rows of an H-sharded batch."""
    _, hidden = models.classifier(x, spatial=spatial)
    phi, phi_prime = models.concept_extractor(tuple(hidden[-3:]), spatial=spatial)
    return phi, phi_prime, models.explainer(phi)


def make_test_step(models: VisCoINModels, lpips_module, mesh=None):
    """The per-batch metric function of :func:`test_viscoin`.

    Returns ``step(images_u8 (B, H, W, 3) uint8, labels (B,), valid (B,)
    float) -> (sums, rebuilt, x)``, tensors on the bundle's device: ``sums``
    maps :data:`METRIC_KEYS` to 0-d fp32 tensors (per-sample values times
    ``valid``, summed), ``rebuilt`` the reconstruction and ``x`` the
    preprocessed batch (fp32 NCHW). With a ``mesh`` the batch is this rank's
    shard and the sums are the global batch's (one all-reduce); on a 2-D
    mesh the images, ``rebuilt`` and ``x`` are this rank's rows along H."""
    data = None if mesh is None else mesh.data_axis

    @torch.no_grad()
    def step(images_u8, labels, valid):
        _, dtype = _placement(models)
        x = device_preprocess(images_u8)
        xc = x.to(dtype)
        sp = S.bundle_spatial(models, mesh, x.shape[3])
        classes, hidden = models.classifier(xc, spatial=sp)
        phi, phi_prime = models.concept_extractor(tuple(hidden[-3:]), spatial=sp)
        expl = models.explainer(phi).float()
        rebuilt = models.gan(phi, phi_prime, noise_mode="const", spatial=sp)
        classes, phi = classes.float(), phi.float()
        lp_dtype = next(lpips_module.parameters()).dtype
        lpips_d = lpips_module(rebuilt.to(lp_dtype), x.to(lp_dtype), spatial=sp).float()
        rebuilt = rebuilt.float()

        preds, preds_expl = classes.argmax(1), expl.argmax(1)
        ce = -F.log_softmax(classes, dim=-1).gather(1, labels[:, None].long())[:, 0]
        pooled = phi.amax(dim=(2, 3))
        normed = pooled / torch.linalg.vector_norm(pooled, dim=1, keepdim=True).clamp_min(1e-12)
        cr = normed.abs().mean(1) + phi.abs().mean(dim=(1, 2, 3))
        of = (-F.softmax(classes, dim=1) * F.log_softmax(expl, dim=1)).sum(1)
        diff = rebuilt - x
        if sp is None:
            l1, l2 = diff.abs().mean(dim=(1, 2, 3)), diff.square().mean(dim=(1, 2, 3))
        else:  # the means over whole images
            l1, l2 = S.model_sum(torch.stack([diff.abs().sum(dim=(1, 2, 3)),
                                              diff.square().sum(dim=(1, 2, 3))]),
                                 sp) / (diff[0].numel() * sp.model)
        valid = valid.float()
        out = {
            "acc_loss": (ce * valid).sum(),
            "cr_loss": (cr * valid).sum(),
            "of_loss": (of * valid).sum(),
            "lp_loss": (lpips_d * valid).sum(),
            "rec_loss_l1": (l1 * valid).sum(),
            "rec_loss_l2": (l2 * valid).sum(),
            "preds_overlap": ((preds == preds_expl) * valid).sum(),
            "correct_preds": ((preds == labels) * valid).sum(),
            "correct_expl_preds": ((preds_expl == labels) * valid).sum(),
            "n_valid": valid.sum(),
        }
        if mesh is not None:
            out = dict(zip(out, all_sum(torch.stack([v.float() for v in out.values()]), data)))
        return out, rebuilt, x

    return step


def _host(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _gathered(rows, mesh) -> np.ndarray:
    """Host fp32 rows (a tensor or an array) of this rank, with a ``mesh``
    those of the whole global batch in rank order."""
    if mesh is None:
        return _host(rows)
    return _host(all_gather_batch(torch.as_tensor(rows, device=mesh.device).float(), mesh))


def _model_share(images: torch.Tensor, valid: torch.Tensor, mesh):
    """On a 2-D mesh: the whole images of this rank's 1 / model of its data
    shard's batch (the H rows gathered over the model group; the batch
    padded to a multiple of the model ranks, the padding not valid), in
    the order in which gathering over the whole mesh puts them."""
    axis = mesh.model_axis
    sp = S.Spatial(axis=axis)
    images = S.gather_rows(images, sp)
    pad = -images.shape[0] % axis.world
    if pad:
        images = torch.cat([images, images[:1].expand(pad, -1, -1, -1)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    rows = axis.rows(axis.local(images.shape[0]))
    return images[rows], valid[rows]


def test_viscoin(models: VisCoINModels, lpips_module, dataloader, compute_fid: bool = False,
                 fid_detector=None, verbose: bool = True, mesh=None,
                 step=None) -> TestingResults:
    """The ensemble's metrics over a test loader: losses averaged over the
    valid samples, prediction statistics in percent. ``step``: a prebuilt
    :func:`make_test_step` (the training loop builds it once).
    ``fid_detector``: a callable (float NCHW images) -> (B, D) features.

    ``mesh``: every rank passes its loader shard (``DataLoader(shard=(rank,
    world))``, with ``pad_final`` when the last global batch is ragged);
    the sums are reduced over the ranks and the FID features of each global
    batch gathered in rank order (B x D floats, where the JAX package
    reduces D x D moments), so every rank holds the one-process statistics.
    On a 2-D mesh the loaders are sharded over its data axis
    (``mesh.data_axis``); each rank places its H rows of every batch."""
    del verbose
    world = 1 if mesh is None else mesh.data_axis.world
    model_axis = None if mesh is None else mesh.model_axis
    if getattr(dataloader, "shard", (0, 1))[1] != world:
        raise ValueError(f"test loader shard world {getattr(dataloader, 'shard', (0, 1))[1]} "
                         f"!= {world}: over a mesh every rank passes its DataLoader(shard=(rank, "
                         "world)), without one an unsharded loader")
    if (world > 1 and not getattr(dataloader, "pad_final", False)
            and len(dataloader.dataset) % dataloader.batch_size):
        # A sharded loader without pad_final drops the ragged tail: the
        # metrics would leave those samples out.
        raise ValueError(f"a sharded test loader needs DataLoader(pad_final=True): the dataset's "
                         f"{len(dataloader.dataset)} samples leave a ragged last batch")
    if step is None:
        step = make_test_step(models, lpips_module, mesh)
    device, _ = _placement(models)
    use_fid = compute_fid and fid_detector is not None
    local_bs = dataloader.batch_size // world
    sums = np.zeros(len(METRIC_KEYS))
    stats_real, stats_fake = FeatureStats(), FeatureStats()
    for images, labels in dataloader:
        images, labels, valid = pad_batch(local_bs, images, labels)
        if model_axis is not None:  # this rank's rows of the (B, H, W, 3) batch
            images = images[:, model_axis.rows(model_axis.local(images.shape[1]))]
        valid_t = to_device(valid, device)
        metrics, rebuilt, x = step(to_device(images, device),
                                   to_device(labels.astype(np.int64), device), valid_t)
        # One device-to-host transfer for all the sums of the batch.
        sums += torch.stack([metrics[k] for k in METRIC_KEYS]).double().cpu().numpy()
        if use_fid:
            if model_axis is not None:
                x, _ = _model_share(x, valid_t, mesh)
                rebuilt, valid_t = _model_share(rebuilt, valid_t, mesh)
            keep = _gathered(valid_t, mesh) > 0
            stats_fake.append(_gathered(fid_detector(rebuilt), mesh)[keep])
            stats_real.append(_gathered(fid_detector(x), mesh)[keep])
    total = dict(zip(METRIC_KEYS, sums.tolist()))
    n_total = max(total["n_valid"], 1.0)
    results = TestingResults(
        acc_loss=total["acc_loss"] / n_total,
        cr_loss=total["cr_loss"] / n_total,
        of_loss=total["of_loss"] / n_total,
        lp_loss=total["lp_loss"] / n_total,
        rec_loss_l1=total["rec_loss_l1"] / n_total,
        rec_loss_l2=total["rec_loss_l2"] / n_total,
        preds_overlap=100 * total["preds_overlap"] / n_total,
        correct_preds=100 * total["correct_preds"] / n_total,
        correct_expl_preds=100 * total["correct_expl_preds"] / n_total,
    )
    if use_fid and stats_real.num_items > 0:
        results.fid_score = fid_from_stats(stats_real, stats_fake)
    return results


# ------------------------------ amplification ------------------------------- #


@dataclass
class AmplifiedConceptsResults:
    """``image`` and ``amplified_images`` are HWC numpy arrays in the
    normalized space, as the JAX package returns them."""

    image: np.ndarray
    default_probas: np.ndarray
    multipliers: list[float]
    best_concept_probas_best: list[float] = field(default_factory=list)
    best_concept_probas_rand: list[float] = field(default_factory=list)
    amplified_images: list[np.ndarray] = field(default_factory=list)


def make_amplify_fns(models: VisCoINModels):
    """(encode one preprocessed image, amplify and reclassify 2M + 1 variants)."""

    @torch.no_grad()
    def encode(x: torch.Tensor):
        return _encode(models, x if x.ndim == 4 else x[None])

    @torch.no_grad()
    def amplify(phi, phi_prime, scale_best, scale_rand):
        """scale_*: (M, K) per-multiplier, per-concept scale factors. One
        generator + classifier pass over 2M + 1 variants: M best, M random,
        and the zeroed default."""
        m2 = 2 * scale_best.shape[0]
        scales = torch.cat([scale_best, scale_rand]).to(phi.dtype)  # (2M, K)
        phis = torch.cat([phi * scales[:, :, None, None], torch.zeros_like(phi)])
        pps = torch.cat([phi_prime.expand(m2, -1), torch.zeros_like(phi_prime)])
        imgs = models.gan(phis, pps, noise_mode="const")
        _, _, logits = _encode(models, imgs)
        return imgs, F.softmax(logits.float(), dim=1)

    return encode, amplify


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).cpu().numpy()


def amplify_concepts(image, models: VisCoINModels, concept_selection: Selection,
                     multipliers: list[float], rng: np.random.Generator | None = None,
                     fns=None) -> AmplifiedConceptsResults:
    """Amplify the selected concepts of one preprocessed image ((3, H, W) or
    (1, 3, H, W), normalized) and measure faithfulness. ``fns``: from
    :func:`make_amplify_fns`, to reuse them."""
    rng = rng or np.random.default_rng()
    encode, amplify = fns if fns is not None else make_amplify_fns(models)
    device, dtype = _placement(models)
    image = torch.as_tensor(image, device=device).to(dtype)
    if image.ndim == 3:
        image = image[None]
    phi, phi_prime, expl_logits = encode(image)
    expl_logits = expl_logits.float()

    class_pred = int(F.softmax(expl_logits, dim=1).argmax(1)[0])
    concept_pred = int(expl_logits.argmax(1)[0])  # the reference's argmax over classes

    # Concept intensities: max-pooled Phi times the explainer's weight row of
    # the predicted class, normalized to [-1, 1] (an all-zero Phi gives 0,
    # not NaN).
    pooled = max_pool_concepts(phi).float().cpu().numpy()[0]
    weights = models.explainer.effective_weight().detach().float().cpu().numpy()
    intensities = pooled * weights[class_pred]
    intensities = intensities / max(np.abs(intensities).max(), 1e-12)

    K = intensities.shape[0]
    if concept_selection["method"] == "threshold":
        best = np.where(intensities > concept_selection["threshold"])[0]
    elif concept_selection["method"] == "top_k":
        best = np.argsort(intensities)[::-1][: concept_selection["k"]]
    else:
        best = np.asarray(concept_selection["indices"], int)
    rand = rng.choice(K, len(best), replace=False)

    M = len(multipliers)
    mults = np.asarray(multipliers, np.float32)
    scale_best = np.ones((M, K), np.float32)
    scale_rand = np.ones((M, K), np.float32)
    scale_best[:, best] = mults[:, None]
    scale_rand[:, rand] = mults[:, None]

    imgs, probas = amplify(phi, phi_prime, torch.from_numpy(scale_best).to(device),
                           torch.from_numpy(scale_rand).to(device))
    imgs, probas = _nhwc(imgs), probas.cpu().numpy()
    results = AmplifiedConceptsResults(image=_nhwc(image)[0], default_probas=probas[2 * M],
                                       multipliers=list(multipliers))
    for i in range(M):
        results.amplified_images.append(imgs[i])
        results.best_concept_probas_best.append(float(probas[i, concept_pred]))
        results.best_concept_probas_rand.append(float(probas[M + i, concept_pred]))
    return results


def amplify_specific_concepts(image, models: VisCoINModels, concept_indices: list[int],
                              multipliers: list[float], fns=None) -> list[np.ndarray]:
    """Amplify explicit concept indices."""
    res = amplify_concepts(image, models, {"method": "indices", "indices": concept_indices},
                           multipliers, rng=np.random.default_rng(0), fns=fns)
    return res.amplified_images


# ---------------------------- faithfulness probe ----------------------------- #


def make_faithfulness_fn(models: VisCoINModels, mesh=None):
    """The probe of the training loop as one batched pass. At multiplier x1
    every concept scale is 1, so the "amplified" image the reference scores
    is the reconstruction G(Phi, Phi'):

        x -> f -> Psi -> Theta   (concept_pred = argmax of the logits)
        rebuilt = G(Phi, Phi', const noise) -> f -> Psi -> Theta -> softmax

    Returns ``probe(images_u8 (B, H, W, 3) uint8 on the device) -> (B,)``,
    the probability of concept_pred on the reconstruction. With a ``mesh``
    every rank passes the same B images, scores its B / world of them and
    returns all B, gathered in order; on a 2-D mesh B / data of them, on its
    H rows, the model group's ranks together."""
    data = None if mesh is None else mesh.data_axis
    model_axis = None if mesh is None else mesh.model_axis

    @torch.no_grad()
    def probe(images_u8: torch.Tensor) -> torch.Tensor:
        _, dtype = _placement(models)
        if mesh is not None:
            images_u8 = images_u8[mesh.rows(mesh.local(images_u8.shape[0]))]
        if model_axis is not None:
            images_u8 = images_u8[:, model_axis.rows(model_axis.local(images_u8.shape[1]))]
        x = device_preprocess(images_u8).to(dtype)
        sp = S.bundle_spatial(models, mesh, x.shape[3])
        phi, phi_prime, logits = _encode(models, x, spatial=sp)
        concept_pred = logits.float().argmax(1)
        rebuilt = models.gan(phi, phi_prime, noise_mode="const", spatial=sp)
        _, _, logits2 = _encode(models, rebuilt, spatial=sp)
        probas = F.softmax(logits2.float(), dim=1)
        return all_gather_batch(probas.gather(1, concept_pred[:, None])[:, 0], data)

    return probe


def faithfulness_probe(models: VisCoINModels, images_u8: np.ndarray,
                       batch_size: int = PROBE_BATCH, fn=None) -> np.ndarray:
    """The probe's statistic for N images, in fixed ``batch_size`` chunks
    (the last one padded by repeating its first row, then sliced)."""
    probe = fn if fn is not None else make_faithfulness_fn(models)
    device, _ = _placement(models)
    n = images_u8.shape[0]
    out = []
    for lo in range(0, n, batch_size):
        chunk = images_u8[lo: lo + batch_size]
        valid = chunk.shape[0]
        if valid < batch_size:
            chunk = np.concatenate([chunk, np.repeat(chunk[:1], batch_size - valid, axis=0)])
        out.append(probe(to_device(chunk, device)).cpu().numpy()[:valid])
    return np.concatenate(out) if out else np.zeros((0,), np.float32)
