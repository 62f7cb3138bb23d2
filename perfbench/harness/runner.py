"""One run of one cell: its ranks, its metrics and its result line."""

from __future__ import annotations

import gc
import math
import socket
import sys
import traceback

from perfbench.harness import core


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_rank(cell: str, wl: dict, config: dict, seed: int, seconds: float, traced: bool,
             t_start: float, rank: int = 0, world: int = 1, port: int = 0, device=None) -> dict:
    """Run the cell's driver on this rank and reduce what it recorded."""
    import torch

    if device is None:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    ctx = core.Context(cell=cell, wl=wl, config=config, seed=seed, seconds=seconds, traced=traced,
                       t_start=t_start, rank=rank, world=world, device=device)
    ctx.layer["port"] = port
    core.driver(wl["driver"]).run(ctx)
    summary = {"rank": rank, "setup_s": ctx.setup_s, "e2e": ctx.e2e, "checks": ctx.checks,
               "attempted": ctx.attempted, "failed": ctx.failed,
               "memory_peak_bytes": ctx.memory_peak_bytes, "forbidden": core.forbidden_modules()}
    if traced:
        tr = ctx.trace
        summary["busy_s"], summary["window_s"] = tr.busy_s(), tr.window_s
        if rank == 0:
            bench = core.benchmark()
            values = {}
            for m in core.metrics_of(bench, cell, "per_layer"):
                v = core.metric_reader(m["name"]).read(ctx)
                if v is not None:
                    values[m["name"]] = {"value": float(v), "unit": m["unit"]}
            summary["per_layer"] = values
            summary["breakdown"] = tr.breakdown()
    del ctx
    gc.collect()
    return summary


def _child(queue, jobs: list, ports: list, rank: int, world: int, device_type: str,
           plant: tuple | None) -> None:
    import contextlib

    import torch

    device = None
    if device_type == "cpu":
        device = torch.device("cpu")
        torch.set_num_threads(2)  # the ranks share the host's cores
    job = 0
    try:
        if plant is not None:  # a fault planted in this rank's program (faults.py)
            from perfbench.faults import planted

            guard = planted(*plant)
        else:
            guard = contextlib.nullcontext()
        with guard:
            for job, (args, port) in enumerate(zip(jobs, ports)):
                summary = run_rank(*args, rank=rank, world=world, port=port, device=device)
                queue.put(dict(summary, job=job))
    except BaseException:  # the parent reports it and exits non-zero
        queue.put({"rank": rank, "job": job, "error": traceback.format_exc()})
        raise


def run_ranks(args: tuple, world: int, timeout_s: float, device_type: str = "cuda",
              plant: tuple | None = None) -> list[dict]:
    """``world`` processes, one per card, each running :func:`run_rank`;
    waits for all of them and returns their summaries by rank.
    ``device_type`` "cpu" runs the ranks on the CPU over gloo (tests);
    ``plant`` a (driver, fault) of ``perfbench/faults.py`` for every rank."""
    return run_ranks_many([args], world, timeout_s, device_type, plant)[0]


def run_ranks_many(jobs: list[tuple], world: int, timeout_s: float, device_type: str = "cuda",
                   plant: tuple | None = None) -> list[list[dict]]:
    """As :func:`run_ranks` for several runs (``jobs``, each :func:`run_rank`'s
    arguments) one after another in the same ``world`` processes, each run
    over a process group of its own; the summaries by run, then by rank."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    ports = [free_port() for _ in jobs]
    procs = [ctx.Process(target=_child, args=(queue, jobs, ports, r, world, device_type, plant))
             for r in range(world)]
    for p in procs:
        p.start()
    out: list[list[dict]] = [[] for _ in jobs]
    try:
        for _ in range(world * len(jobs)):
            s = queue.get(timeout=timeout_s)
            out[s.pop("job")].append(s)
            if "error" in s:
                break
    finally:
        for p in procs:
            p.join(timeout=60)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [sorted(o, key=lambda s: s["rank"]) for o in out]


def assemble(bench: dict, cell: str, world: int, traced: bool,
             summaries: list[dict]) -> tuple[dict, bool]:
    """The result line's parts from the ranks' summaries."""
    for s in summaries:
        if "error" in s:
            raise RuntimeError(f"rank {s['rank']} failed:\n{s['error']}")
    lead = summaries[0]
    checks = {}
    for s in summaries:
        for k, (v, lim) in s["checks"].items():
            name = k if len(summaries) == 1 else f"{k}.r{s['rank']}"
            checks[name] = (v, lim)
    correct = bool(checks) and all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    peak = max(s["memory_peak_bytes"] for s in summaries)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if traced:
        metrics = lead["per_layer"]
        busy = sum(s["busy_s"] for s in summaries) / len(summaries)
        window = lead["window_s"]
    else:
        metrics = {}
        for m in core.metrics_of(bench, cell, "end_to_end"):
            name = m["name"]
            v = lead["setup_s"] if name == "setup_s" else lead["e2e"].get(name)
            if name == "peak_mem_gib":
                v = peak / core.GIB
            if v is not None:
                metrics[name] = {"value": float(v), "unit": units[name]}
        busy = window = None
    forbidden = sorted({m for s in summaries for m in s["forbidden"]}
                       | set(core.forbidden_modules()))
    return {"metrics": metrics, "peak": peak, "busy": busy, "window": window, "checks": checks,
            "correct": correct, "attempted": lead["attempted"], "failed": lead["failed"],
            "breakdown": lead.get("breakdown") if traced else None, "forbidden": forbidden}, correct


def print_checks(checks: dict) -> None:
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
