"""Concept extractor Psi, NCHW.

Counterpart of ``viscoin_tpu/models/concept_extractor.py``: the three last
ResNet hidden states are projected to a common 7x7 (at 224², 8x8 at 256²)
space by conv1 (5x5/4), conv2 (3x3/2) and conv3 (3x3/1), concatenated, mixed
by conv4 (3x3), then split into two heads:

  * ``Phi``  — conv5 (1x1 -> n_concepts) + adaptive average pool to 3x3:
               (B, n_concepts, 3, 3) concept maps;
  * ``Phi'`` — pool(conv4 output) -> channel-major flatten (the natural NCHW
               flatten) -> linear1 -> linear2 (no bias): (B, 9 * n_concepts).

All activations are ReLU. The pooling to 3x3 is torch's adaptive average
pooling (window i covers [floor(i * n / 3), ceil((i + 1) * n / 3))), computed
as the JAX package computes it: two contractions with fixed averaging
matrices, whose backward is a matrix product too. ``F.adaptive_avg_pool2d``
would give the same values, but its CUDA backward adds overlapping windows
with atomics, in no fixed order, so a resumed run would not be bit-equal to
the unbroken one.

With ``spatial`` (``parallel/spatial.py``) the three latent layers are in
their planes' layouts of the shard plan; conv1-conv3 run in their inputs'
layouts, their outputs take the "psi.latent" plane's, and on a sharded plane
the pooling contracts this rank's rows of the averaging matrix, then sums
over the model group, so Phi and Phi' are whole on every rank.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from viscoin_tpu_torch.models.resnet import lecun_normal_
from viscoin_tpu_torch.parallel import spatial as S


def _adaptive_pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) averaging matrix of torch's adaptive average pooling."""
    m = np.zeros((in_size, out_size), np.float32)
    for o in range(out_size):
        lo = (o * in_size) // out_size
        hi = -(-((o + 1) * in_size) // out_size)  # ceil
        m[lo:hi, o] = 1.0 / (hi - lo)
    return m


_POOL_MATRICES: dict[tuple, torch.Tensor] = {}


def _pool_matrix(in_size: int, out_size: int, like: torch.Tensor) -> torch.Tensor:
    """The averaging matrix on ``like``'s device and dtype, made once (a copy
    to the card per call would wait for the stream), outside inference mode
    so that a matrix first made while serving can enter autograd later.
    While a program is traced for ``torch.export`` it is made afresh and not
    kept: it becomes the program's constant, and a tensor of the tracer's
    must not outlive its trace."""
    if torch.compiler.is_exporting():
        return torch.from_numpy(_adaptive_pool_matrix(in_size, out_size)).to(like.device,
                                                                             like.dtype)
    key = (in_size, out_size, like.device, like.dtype)
    m = _POOL_MATRICES.get(key)
    if m is None:
        with torch.inference_mode(False):
            m = _POOL_MATRICES[key] = torch.from_numpy(
                _adaptive_pool_matrix(in_size, out_size)).to(like.device, like.dtype)
    return m


def adaptive_avg_pool(x: torch.Tensor, out_size: int, sp: S.Spatial | None = None
                      ) -> torch.Tensor:
    """Adaptive average pooling of an NCHW tensor to (out_size, out_size):
    a contraction over H, then one over W. ``sp``: ``x`` is this rank's rows
    of an H-sharded plane; the result is whole on every rank."""
    if sp is None:
        mh = _pool_matrix(x.shape[2], out_size, x)
    else:
        height = x.shape[2] * sp.model
        mh = _pool_matrix(height, out_size, x)[sp.rows(height)]
    mw = _pool_matrix(x.shape[3], out_size, x)
    x = torch.einsum("bchw,hy->bcyw", x, mh)
    x = torch.einsum("bcyw,wx->bcyx", x, mw)
    return x if sp is None else S.model_sum(x, sp)


class ConceptExtractor(nn.Module):
    def __init__(self, *, n_concepts: int = 256, latent_channels: int = 512,
                 input_channels1: int = 512, input_channels2: int = 1024,
                 input_channels3: int = 2048, device="cuda"):
        super().__init__()
        self.config = dict(n_concepts=n_concepts, latent_channels=latent_channels,
                           input_channels1=input_channels1, input_channels2=input_channels2,
                           input_channels3=input_channels3)
        lc = latent_channels
        self.conv1 = nn.Conv2d(input_channels1, lc, 5, stride=4, padding=2, device=device)
        self.conv2 = nn.Conv2d(input_channels2, lc, 3, stride=2, padding=1, device=device)
        self.conv3 = nn.Conv2d(input_channels3, lc, 3, stride=1, padding=1, device=device)
        self.conv4 = nn.Conv2d(3 * lc, 3 * lc, 3, padding=1, device=device)
        self.conv5 = nn.Conv2d(3 * lc, n_concepts, 1, device=device)
        self.linear1 = nn.Linear(9 * 3 * lc, 9 * n_concepts, device=device)
        self.linear2 = nn.Linear(9 * n_concepts, 9 * n_concepts, bias=False, device=device)

    def init_weights(self, generator: torch.Generator):
        for m in (self.conv1, self.conv2, self.conv3, self.conv4, self.conv5,
                  self.linear1, self.linear2):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()

    def tap_shapes(self, latent_layers) -> list[tuple[int, ...]]:
        """The shapes of conv1..conv5's outputs on ``latent_layers``: what
        each of the ``perturbations`` must have."""
        b = latent_layers[0].shape[0]
        shapes = []
        for conv, x in zip((self.conv1, self.conv2, self.conv3), latent_layers):
            hw = [(n + 2 * p - k) // s + 1 for n, p, k, s in
                  zip(x.shape[2:], conv.padding, conv.kernel_size, conv.stride)]
            shapes.append((b, conv.out_channels, *hw))
        return shapes + [(b, conv.out_channels, *shapes[0][2:]) for conv in (self.conv4,
                                                                              self.conv5)]

    def forward_taps(self, latent_layers, perturbations=None,
                     spatial: S.Spatial | None = None):
        """``forward``, and conv1..conv5's outputs before their ReLU (the
        JAX module's ``perturb`` taps). ``perturbations``: None, or five
        tensors of :meth:`tap_shapes` added to those outputs; GradCAM
        differentiates with respect to zero perturbations. ``spatial``: see
        :meth:`forward`; the taps and the perturbations are in the
        "psi.latent" plane's layout.

        Returns (Phi (B, K, 3, 3), Phi' (B, 9K), [five NCHW conv outputs])."""
        if len(latent_layers) != 3:
            raise ValueError(f"expected 3 latent layers, got {len(latent_layers)}")
        sp, latent = spatial, "psi.latent"
        taps = []

        def tap(conv, x, plane):
            a = S.conv2d(x, conv.weight, conv.bias, conv.stride[0], conv.padding[0],
                         S.at(sp, plane))
            a = S.convert(a, sp, plane, latent)
            taps.append(a)
            return torch.relu(a if perturbations is None else a + perturbations[len(taps) - 1])

        x1 = tap(self.conv1, latent_layers[0], "f.stage1")
        x2 = tap(self.conv2, latent_layers[1], "f.stage2")
        x3 = tap(self.conv3, latent_layers[2], "f.stage3")
        x = tap(self.conv4, torch.cat([x1, x2, x3], dim=1), latent)

        at = S.at(sp, latent)
        phi = adaptive_avg_pool(tap(self.conv5, x, latent), 3, at)

        y = adaptive_avg_pool(x, 3, at).reshape(x.shape[0], -1)
        y = torch.relu(self.linear1(y))
        y = torch.relu(self.linear2(y))
        return phi, y, taps

    def forward(self, latent_layers, perturbations=None,
                spatial: S.Spatial | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """latent_layers: the classifier's hidden_states[-3:] (NCHW);
        ``perturbations``: see :meth:`forward_taps`. ``spatial``: the layers
        are in the layouts of the shard plan's "f.stage1".."f.stage3".

        Returns (Phi (B, K, 3, 3), Phi' (B, 9K))."""
        phi, y, _ = self.forward_taps(latent_layers, perturbations, spatial)
        return phi, y


def max_pool_concepts(phi: torch.Tensor) -> torch.Tensor:
    """(B, K, 3, 3) -> (B, K): per-concept max over the 3x3 map."""
    return phi.amax(dim=(2, 3))
