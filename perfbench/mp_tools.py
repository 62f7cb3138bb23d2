"""``faults.py`` and ``phases.py`` for the cells of the ``train_gan_mp``
driver (the mixed-precision and global 16-bit GAN cells), whose names those
tools key by driver:

    python3 perfbench/mp_tools.py faults --workload <cell> --fault <name> --seeds 1,2,3
    python3 perfbench/mp_tools.py phases --workload <cell> --seed <n> [--out FILE]
    python3 perfbench/mp_tools.py precision --workload <cell> --seeds 1,2,3

The faults are ``train_gan``'s one-card faults (they patch program functions
this driver also calls) and ``fp32_blocks``, a silent fall back to float32:
the step is made with every G and D block in float32 and ``compute_dtype``
float32, whatever the networks and the parameters ask. The phases are
``train_gan``'s (``gan_draw`` and ``gan_step`` the step's top-level spans).
``precision`` prints, per seed, the numbers a run compares three ways: the
program's set-up readings against the float32 reference (what a run
reads), the reference at the cell's stated precision (float16 blocks, or
the global 16-bit autocast) against the float32 one, and the program
against that stated-precision reference: how far the stated precision
alone moves each number, and how far the program lies from a plain
computation at that precision. On the card, at the cell's own size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import faults, phases  # noqa: E402


def _fp32_blocks():
    import dataclasses

    import viscoin_tpu_torch.train.gan as T
    from viscoin_tpu_torch.models.stylegan import DiscriminatorBlock, SynthesisBlock

    orig = T.make_gan_train_step

    def in_fp32(generator, discriminator, cfg, mesh=None):
        for m in (*generator.modules(), *discriminator.modules()):
            if isinstance(m, (SynthesisBlock, DiscriminatorBlock)):
                m.dtype = None
        generator.num_fp16_res = generator.synthesis.num_fp16_res = 0
        discriminator.num_fp16_res = 0
        return orig(generator, discriminator, dataclasses.replace(cfg, compute_dtype="float32"),
                    mesh)

    return T, "make_gan_train_step", in_fp32


faults.FAULTS["train_gan_mp"] = {
    **{k: v for k, v in faults.FAULTS["train_gan"].items() if k not in faults.ACROSS_CARDS},
    "fp32_blocks": _fp32_blocks}
phases.TOPS["train_gan_mp"] = phases.TOPS["train_gan"]


def precision_readings(ctx, device) -> dict:
    """The gaps of the program's set-up readings and of the reference at the
    stated precision from the float32 reference, and of the program from
    the stated-precision reference, with each comparison's worst leaves."""
    from perfbench.drivers import train_gan_mp as drv
    from perfbench.harness import core

    test, program = drv.setup(ctx, device)
    del program
    core.free(device)
    ref = drv.reference_readings(ctx, device)
    stated = drv.stated_readings(ctx, device)
    return {"program": drv.gaps(test, ref), "stated": drv.gaps(stated, ref),
            "program_vs_stated": drv.gaps(test, stated),
            "leaves": {"program": drv.TG.detail(test, ref), "stated": drv.TG.detail(stated, ref),
                       "program_vs_stated": drv.TG.detail(test, stated)}}


def precision(argv=None) -> None:
    import torch

    from perfbench.harness import core

    ap = argparse.ArgumentParser(prog="mp_tools.py precision")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    bench = core.benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}[args.workload]
    wl = core.load_json(core.workload_file(args.workload))
    config = core.load_json(core.config_file(entry["config"]))
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = core.Context(cell=args.workload, wl=wl, config=config, seed=seed,
                           seconds=float(bench["run_seconds"]), traced=False, t_start=time.time(),
                           world=1, device=device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **precision_readings(ctx, device)}), flush=True)
        core.free(device)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    tools = {"faults": faults.main, "phases": phases.main, "precision": precision}
    if not argv or argv[0] not in tools:
        raise SystemExit(f"usage: mp_tools.py {{{','.join(tools)}}} ...")
    tools[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
