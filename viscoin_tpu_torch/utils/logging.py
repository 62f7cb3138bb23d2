"""jsonl metric logging.

Counterpart of ``viscoin_tpu/utils/logging.py``: one bare JSON object per
line, written through a non-propagating logger of its own, so records of
other libraries never land in the file and the ``logs`` command reads the
files of either package.
"""

from __future__ import annotations

import logging

_LOGGER_NAME = "viscoin_tpu_torch.metrics"


def get_logger() -> logging.Logger:
    """The metrics logger."""
    return logging.getLogger(_LOGGER_NAME)


def configure_score_logging(log_path: str) -> None:
    """Log bare INFO messages to ``log_path``, overwriting it."""
    logger = get_logger()
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    handler = logging.FileHandler(log_path, mode="w")
    handler.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(handler)
