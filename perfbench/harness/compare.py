"""The numbers that decide ``correct``: gaps between the measured side and
the plain reference, each taken by the worst leaf or the worst value."""

from __future__ import annotations

import statistics

import torch

# A leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone (a bias under a softmax): its change is not
# compared.
ROUNDOFF_SHARE = 1e-3


@torch.no_grad()
def norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    """Each leaf's L2 norm (in float64, read back once)."""
    names = list(tensors)
    if not names:
        return {}
    vals = torch.stack([torch.linalg.vector_norm(tensors[n].double()) for n in names]).cpu()
    return dict(zip(names, vals.tolist()))


def leaf_gap(test: dict[str, float], ref: dict[str, float], keep=None) -> tuple[float, str]:
    """max over leaves of |‖test‖ - ‖ref‖| / max(‖ref‖, the median leaf's
    ‖ref‖); ``keep``: the leaves compared (all of ``ref`` by default).
    Returns the gap and its leaf. A leaf missing on the test side counts
    as a gap of 1 (it did not move)."""
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    worst, leaf = 0.0, ""
    for n in names:
        g = abs(test.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30)
        if not g <= worst:  # NaN propagates as the worst
            worst, leaf = g, n
    return worst, leaf


def moving_leaves(grad_norms: dict[str, float]) -> set[str]:
    """The leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(grad_norms.values())
    return {n for n, v in grad_norms.items() if v >= ROUNDOFF_SHARE * med}


def value_gap(test: list[dict], ref: list[dict], keys, scale_key: str | None = None) -> float:
    """max over steps and ``keys`` of |test - ref| / |scale|, the scale
    being the step's ``scale_key`` value of the reference (each value's own
    when None)."""
    worst = 0.0
    for t, r in zip(test, ref, strict=True):
        for k in keys:
            scale = abs(r[scale_key]) if scale_key else abs(r[k])
            g = abs(t[k] - r[k]) / max(scale, 1e-30)
            if not g <= worst:
                worst = g
    return worst
