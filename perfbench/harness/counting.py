"""Counting on the reference: the model FLOPs (:class:`FlopCount`) and the
kernels' bytes (:class:`~perfbench.reference.ops.ByteCounter`) of a block,
at the cell's shapes."""

from __future__ import annotations

from perfbench.reference.ops import ByteCounter


class FlopCount:
    """The FLOPs of every operation dispatched in the block (forward and
    every backward order), by ``torch.utils.flop_counter``'s formulas
    (matrix products, convolutions, attention); without the module
    tracking of ``FlopCounterMode``, which fails on a module called under
    ``no_grad`` with inputs that require a gradient."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                formula = flop_registry.get(func._overloadpacket)
                if formula is not None:
                    counter.total += formula(*args, **kwargs, out_val=out)
                return out

        self.total = 0
        self._mode = _Mode()

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)

    def get_total_flops(self) -> int:
        return self.total


class Counted:
    """``with Counted(on, store, key):`` stores ``{"flops", "bytes"}`` of
    the block under ``store[key]``; does nothing when not ``on``."""

    def __init__(self, on: bool, store: dict, key: str):
        self.on, self.store, self.key = on, store, key
        self.modes = (FlopCount(), ByteCounter()) if on else ()

    def __enter__(self):
        for m in self.modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self.modes):
            m.__exit__(*exc)
        if self.on and exc[0] is None:
            flops, nbytes = self.modes
            self.store[self.key] = {"flops": flops.get_total_flops(), "bytes": dict(nbytes.bytes)}
        return False


def total(counted: dict, mix: dict[str, int]) -> tuple[int, dict[str, int]]:
    """FLOPs and bytes of ``mix`` (key -> how many times it ran)."""
    flops = sum(counted[k]["flops"] * n for k, n in mix.items())
    ops = next(iter(counted.values()))["bytes"]
    return flops, {op: sum(counted[k]["bytes"][op] * n for k, n in mix.items()) for op in ops}
