"""The result record of VisCoIN's eval.

Counterpart of ``viscoin_tpu/utils/types.py``. The field names define the
jsonl schema of the ``test_*`` keys (``train/viscoin.py::TRAIN_METRICS``
names the ``train_*`` ones), so logs of either package read the same.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class TestingResults:
    """Averages over a test set (losses) and percentages (predictions)."""

    __test__ = False  # a record, not a pytest class

    acc_loss: float
    cr_loss: float
    of_loss: float
    lp_loss: float
    rec_loss_l1: float
    rec_loss_l2: float
    preds_overlap: float
    correct_preds: float
    correct_expl_preds: float
    fid_score: float | None = None

