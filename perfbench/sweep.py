"""Find the highest rate the serving cell sustains: the cell's open loop at
each of a list of rates, in one process (one engine, warmed once), each
window reporting the offered and completed rates, the latency quantiles and
whether the backlog grew (the last fifth of the requests waiting more than
twice as long as the first fifth, and 50 ms more).

    python3 perfbench/sweep.py --workload <serving cell> --seed <n> --seconds <s> \
        --rates 100,200,300

Runs on the card; prints one JSON line per rate.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.harness import core  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    import torch

    bench = core.benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}[args.workload]
    wl = core.load_json(core.workload_file(args.workload))
    config = core.load_json(core.config_file(entry["config"]))
    device = torch.device("cuda", 0)
    drv = core.driver(wl["driver"])
    ctx = core.Context(cell=args.workload, wl=wl, config=config, seed=args.seed,
                       seconds=args.seconds, traced=False, t_start=time.time(), device=device)
    server, engine, batch_s = drv.build(ctx, device)
    pool = drv.image_pool(ctx, device)
    for _ in range(wl["params"]["warm_batches"]):
        engine.reconstruct(pool[: wl["params"]["device_batch"]])
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            batch_s.clear()
            due, _, done, _, late, end = drv.window(ctx, server, pool, rate, args.seconds)
            lat = drv.latencies_ms(due, done)
            fifth = max(1, len(lat) // 5)
            first, last = statistics.median(lat[:fifth]), statistics.median(lat[-fifth:])
            completed = sum(1 for d in done if d is not None and d <= end)
            print(json.dumps({
                "rate": rate, "requests": len(lat), "completed_per_s": completed / end,
                "p50_ms": statistics.median(lat), "p95_ms": drv.p95(lat),
                "first_fifth_p50_ms": first, "last_fifth_p50_ms": last,
                "growing": bool(last > 2 * first + 50), "dispatch_late_ms": late * 1e3,
                "batches": len(batch_s),
                "batch_ms_median": statistics.median(batch_s) * 1e3 if batch_s else None,
                "failed": sum(1 for d in done if d is None)}), flush=True)
    finally:
        server.close()


if __name__ == "__main__":
    main()
