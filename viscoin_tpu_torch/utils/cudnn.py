"""cuDNN's deterministic algorithms, as a scoped switch.

The generator's up-convs run as transposed convolutions and GradCAM's
backward through Psi runs their adjoints; cuDNN's default algorithms for
both add with atomics, so two runs of one input would differ. The commands
that must be reproducible (``generate``, ``style-mixing``, ``amplify-pca``)
and GradCAM (``utils/gradcam.py``, and a sealed artifact's ``explain``,
``serve/export.py``) run under :func:`deterministic_cudnn`.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside, the caller's setting after."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved
