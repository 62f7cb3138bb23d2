"""What every run shares: the benchmark's files found by name, the run's
context, the isolation check and the result line.

Everything that belongs to one configuration, one cell or one per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``workloads/<cell>.json`` (its ``driver`` names
``drivers/<driver>.py``) and ``metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # perfbench/
ROOT = HERE.parent
PROGRAM = "viscoin_tpu_torch"
# The JAX package and its ecosystem, compared by whole top-level module name.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "viscoin_tpu")
GIB = 1024**3


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload_file(name: str, base: Path = HERE) -> Path:
    return base / "workloads" / f"{name}.json"


def config_file(name: str, base: Path = HERE) -> Path:
    return base / "configs" / f"{name}.json"


def load_module(path: Path, name: str | None = None):
    """Import a file by path (names may hold '.' or '-')."""
    name = name or f"perfbench_file_{path.stem.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, base: Path = HERE):
    return load_module(base / "drivers" / f"{name}.py")


def metric_reader(name: str, base: Path = HERE):
    return load_module(base / "metrics" / f"{name}.py")


def metrics_of(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    without a ``workloads`` list, and those whose list names it."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def forbidden_modules(modules=None) -> list[str]:
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


@dataclass
class Context:
    """One run of one cell (one rank of it on several cards)."""

    cell: str
    wl: dict
    config: dict
    seed: int
    seconds: float
    traced: bool
    t_start: float  # time.time() when the run's first process started
    rank: int = 0
    world: int = 1
    device: object = None
    setup_s: float | None = None
    e2e: dict = field(default_factory=dict)
    layer: dict = field(default_factory=dict)
    checks: dict = field(default_factory=dict)  # name -> (value, limit)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    trace: object = None

    @property
    def params(self) -> dict:
        return self.wl["params"]

    def setup_done(self) -> None:
        self.setup_s = time.time() - self.t_start

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks[name] = (float(value), float(limit))

    def note(self, msg: str) -> None:
        print(f"[{self.cell} r{self.rank}] {msg}", file=sys.stderr, flush=True)


def device_info(world: int, peak_bytes: int, busy_s: float | None = None,
                window_s: float | None = None) -> dict:
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": world,
           "memory_peak_bytes": int(peak_bytes)}
    if busy_s is not None:
        out["busy_s"] = busy_s
        out["window_s"] = window_s
    return out


def result_line(attempted: int, failed: int, metrics: dict, device: dict,
                breakdown: dict | None, checks: dict, correct: bool) -> str:
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return json.dumps(out)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    import torch

    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def free(device) -> None:
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
