"""Metrics.

Counterpart of ``viscoin_tpu/utils/metrics.py``.
"""

from __future__ import annotations

import torch


def _normalize_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-12)


def cosine_matching(original: torch.Tensor, rebuilt: torch.Tensor) -> float:
    """Fraction of rows whose best cosine match is their own pair, compared
    by value (``max == diagonal``) as the reference does, so ties count as
    matches."""
    if original.shape != rebuilt.shape or original.ndim != 2:
        raise ValueError(f"expected two (n, d) arrays of one shape, got {tuple(original.shape)} "
                         f"and {tuple(rebuilt.shape)}")
    sims = _normalize_rows(original) @ _normalize_rows(rebuilt).T  # (n, n)
    highest = sims.max(dim=1).values
    return float((highest == sims.diagonal()).float().mean())
