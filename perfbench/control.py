"""The control of a cell's ``correct``: the plain reference computed in the
nearest precision below the configuration's (bfloat16 under autocast for
the fp32 configurations), compared with the reference itself by the same
numbers and limits a run uses. Every seed must come out not correct.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3

Runs on the card at the cell's own size; prints one JSON line per seed.
The benchmark's own runs never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.harness import core  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch

    bench = core.benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}[args.workload]
    wl = core.load_json(core.workload_file(args.workload))
    config = core.load_json(core.config_file(entry["config"]))
    device = torch.device("cuda", 0)
    drv = core.driver(wl["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = core.Context(cell=args.workload, wl=wl, config=config, seed=seed,
                           seconds=float(bench["run_seconds"]), traced=False, t_start=time.time(),
                           world=entry["chips"], device=device)  # the reference on one card
        gaps = drv.control(ctx, device)
        limits = wl["limits"]
        fails = [k for k, v in gaps.items() if not v <= limits[k]]
        print(json.dumps({"workload": args.workload, "seed": seed, "gaps": gaps,
                          "limits": limits, "correct": not fails}), flush=True)
        core.free(device)


if __name__ == "__main__":
    main()
