"""Seeded weights, made on the device in one draw per network.

A network's initial distributions come from ``init_plan()`` of the
reference's modules (each leaf: ``("normal", mean, std)`` or ``("uniform",
lo, hi)``, named as in the state dict). One ``torch.randn`` on a generator
on the device, seeded from (seed, network tag), fills every floating leaf
of the network; integer buffers (BatchNorm's counters) are 0. The same
(seed, tag) gives the same tensors, which both the measured program and
the reference load by name.
"""

from __future__ import annotations

import math
import zlib

import torch

from perfbench.reference.steps import fold_seed

TAG_BASE = 0x57454947  # "WEIG": apart from every seed the steps fold


def tag_of(name: str) -> int:
    return zlib.crc32(name.encode())


def plan_of(module: torch.nn.Module) -> dict[str, tuple]:
    plan = {}
    for prefix, m in module.named_modules():
        init = getattr(m, "init_plan", None)
        if init is not None:
            for k, v in init().items():
                plan[f"{prefix}.{k}" if prefix else k] = v
    return plan


@torch.no_grad()
def make_state(module: torch.nn.Module, seed: int, name: str, device) -> dict[str, torch.Tensor]:
    """The state dict of ``module`` (a reference module, on any device,
    meta included) drawn from (seed, name), on ``device``."""
    plan = plan_of(module)
    spec = list(module.state_dict().items())
    floating = [(k, t.shape) for k, t in spec if t.is_floating_point()]
    missing = [k for k, _ in floating if k not in plan]
    if missing:
        raise KeyError(f"no initial distribution for {missing[:5]} ({len(missing)} leaves)")
    total = sum(math.prod(s) for _, s in floating)
    gen = torch.Generator(device=device).manual_seed(fold_seed(seed, TAG_BASE, tag_of(name)))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for k, shape in floating:
        n = math.prod(shape)
        z = flat[at: at + n].view(shape)
        at += n
        kind, a, b = plan[k]
        if kind == "normal":
            out[k] = z * b + a
        elif kind == "uniform":  # the normal's CDF: uniform on [0, 1)
            out[k] = (0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))) * (b - a) + a
        else:
            raise ValueError(f"{k}: unknown distribution {kind!r}")
    for k, t in spec:
        if not t.is_floating_point():
            out[k] = torch.zeros(t.shape, dtype=t.dtype, device=device)
    return out


def make_states(factories: dict, seed: int, device) -> dict[str, dict[str, torch.Tensor]]:
    """:func:`make_state` of each named reference module (built on the
    meta device from its factory)."""
    out = {}
    for name, factory in factories.items():
        with torch.device("meta"):
            module = factory()
        out[name] = make_state(module, seed, name, device)
    return out


def build(factory, device):
    """A reference module built on the meta device and given empty storage
    on ``device`` (no initialisation runs)."""
    with torch.device("meta"):
        module = factory()
    return module.to_empty(device=device)


def load(module: torch.nn.Module, state: dict[str, torch.Tensor]) -> torch.nn.Module:
    """Load ``state`` by name, every leaf present on both sides."""
    module.load_state_dict(state, strict=True)
    return module
