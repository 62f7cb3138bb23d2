"""Style-modulated convolution with weight demodulation (StyleGAN2 core op).

Counterpart of ``viscoin_tpu/ops/modulated_conv.py``: the input/output
scaling decomposition around one dense batched conv,

    y[b] = demod[b] * conv(x[b] * styles[b], w),
    demod[b, co] = rsqrt((styles[b]^2) @ (sum_{kh,kw} w^2)[co, :]^T + 1e-8),

with the demodulation coefficients in fp32 and, when the compute dtype is
not fp32, a pre-normalisation of ``w`` and ``styles`` that keeps the
16-bit products in range: in bfloat16 the JAX package's (``w`` over its
root mean square per output channel, ``styles`` over their largest
magnitude per sample), in float16 stylegan2-ada-pytorch's (``w`` times
``1 / sqrt(fan_in) / max |w|`` per output channel, ``styles`` over their
largest magnitude). Both are identities under demodulation.
"""

from __future__ import annotations

import torch

from viscoin_tpu_torch.ops.conv2d_resample import conv2d_resample


def modulated_conv2d(x: torch.Tensor, w: torch.Tensor, styles: torch.Tensor, *,
                     noise: torch.Tensor | None = None, up: int = 1, down: int = 1,
                     padding: int = 0, resample_filter=None, demodulate: bool = True,
                     flip_weight: bool = True,
                     input_gain: torch.Tensor | None = None, sp=None) -> torch.Tensor:
    """Modulated conv over NCHW activations with OIHW weights.

    Args:
        x: (B, Ci, H, W) input.
        w: (Co, Ci, kh, kw) weights.
        styles: (B, Ci) per-sample modulation from the affine layer.
        noise: optional noise broadcastable to (B, 1, H', W'), added after demod.
        up / down / padding / resample_filter / flip_weight: see
            :func:`conv2d_resample`.
        demodulate: apply weight demodulation (False for ToRGB).
        input_gain: optional extra per-channel input scale.
        sp: ``x`` is this rank's rows of an H-sharded plane (see
            :func:`conv2d_resample`); ``noise`` then holds the same rows.
    """
    compute_dtype = x.dtype
    if demodulate and compute_dtype == torch.float16:
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        w = w * (1.0 / fan_in**0.5 / w.abs().amax(dim=(1, 2, 3), keepdim=True))
        styles = styles / styles.abs().amax(dim=1, keepdim=True)
    elif demodulate and compute_dtype != torch.float32:
        w = w * torch.rsqrt(w.square().mean(dim=(1, 2, 3), keepdim=True) + 1e-8)
        styles = styles / styles.abs().amax(dim=1, keepdim=True)

    dcoefs = None
    if demodulate:
        w2 = w.float().square().sum(dim=(2, 3))  # (Co, Ci)
        dcoefs = torch.rsqrt(styles.float().square() @ w2.T + 1e-8)  # (B, Co)

    if input_gain is not None:
        styles = styles * input_gain

    x = x * styles[:, :, None, None].to(compute_dtype)
    x = conv2d_resample(x, w.to(compute_dtype), f=resample_filter, up=up, down=down,
                        padding=padding, flip_weight=flip_weight, sp=sp)
    if dcoefs is not None:
        x = x * dcoefs[:, :, None, None].to(x.dtype)
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x
