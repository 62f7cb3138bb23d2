"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cells; each cell's
file (``perfbench/workloads/<cell>.json``) names its configuration, its
traffic driver and the traffic's parameters. The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``: each number compared with its limit). Without a CUDA card, or
with fewer cards than the cell asks for, or if the measured program is not
in the checkout, it exits non-zero and prints no result.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# Build and kernel caches of the program stay inside the checkout, at fixed
# paths (the port's own nvcc libraries: viscoin_tpu_torch/csrc/build/).
CACHE = ROOT / ".bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")

from perfbench.harness import core, runner  # noqa: E402


def fail(msg: str, code: int = 2) -> None:
    print(f"perfbench: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = core.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        fail(f"no cell {args.workload!r} in BENCHMARK.json")
    entry = cells[args.workload]
    wl = core.load_json(core.workload_file(args.workload))
    config = core.load_json(core.config_file(entry["config"]))
    if not (ROOT / core.PROGRAM).is_dir():
        fail(f"the measured program ({core.PROGRAM}/) is not in this checkout")
    import torch

    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"cell {args.workload} needs {chips} CUDA card(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", 3)

    rank_args = (args.workload, wl, config, args.seed, args.seconds, bool(args.trace), T_START)
    if chips == 1:
        summaries = [runner.run_rank(*rank_args)]
    else:
        summaries = runner.run_ranks(rank_args, chips, timeout_s=1500)
    out, correct = runner.assemble(bench, args.workload, chips, bool(args.trace), summaries)
    if out["forbidden"]:
        fail(f"modules of the JAX package or its ecosystem were loaded: {out['forbidden']}", 4)
    device = core.device_info(chips, out["peak"], out["busy"], out["window"])
    runner.print_checks(out["checks"])
    sys.stderr.flush()
    print(core.result_line(out["attempted"], out["failed"], out["metrics"], device,
                           out["breakdown"], out["checks"], correct), flush=True)


if __name__ == "__main__":
    main()
