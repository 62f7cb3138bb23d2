"""Faults planted in the measured program under the timed path, to show
that a run's ``correct`` catches each: a step that leaves the state
unchanged, half of the batch left out (the mean over the rest), the
exchange between cards left out, an answer altered where it is produced.

    python3 perfbench/faults.py --workload <cell> --fault <name> --seeds 1,2,3

runs the whole cell (set-up, window, comparison) with the fault planted and
prints one JSON line per seed with the numbers compared; on the card, at
the cell's own size. ``--fault none`` runs the program as it is, so the
sound runs of many seeds share one process (on several cards, one process
per card runs them all). The tests under ``perfbench/tests`` plant the same
faults at toy widths on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _viscoin_state_unchanged():
    import viscoin_tpu_torch.train.viscoin as T

    def no_update(state, cfg, schedule, mesh=None):
        state.step += 1
        return True

    return T, "optimizer_update", no_update


def _viscoin_half_batch():
    import viscoin_tpu_torch.train.viscoin as T

    orig = T.make_loss_fn

    def make(*args, **kwargs):
        loss_fn = orig(*args, **kwargs)

        def half(params, frozen, real, labels, step, rng, fake=None, dropout_mask=None):
            h = real.shape[0] // 2
            return loss_fn(params, frozen, real[:h], labels[:h], step, rng,
                           None if fake is None else fake[:h], dropout_mask)
        return half

    return T, "make_loss_fn", make


def _gan_state_unchanged():
    import viscoin_tpu_torch.train.gan as T

    return T, "_adam_step", lambda opt, params, grads: None


def _gan_half_batch():
    import viscoin_tpu_torch.train.gan as T

    orig = T.make_gan_loss_fns

    def make(*args, **kwargs):
        fns = dict(orig(*args, **kwargs))
        g, d, pl = fns["g_loss_fn"], fns["d_loss_fn"], fns["ppl_penalty"]

        def rows(draws, h):
            return None if draws is None else draws.rows(slice(0, h))

        def g_half(g_params, d_params, z, z_mix, cutoff, noise_seed, aug_p, aug_draws):
            h = z.shape[0] // 2
            return g(g_params, d_params, z[:h], z_mix[:h], cutoff, noise_seed, aug_p,
                     rows(aug_draws, h))

        def d_half(d_params, g_params, real, z, z_mix, cutoff, noise_seed, do_r1, aug_p, df, dr):
            h = real.shape[0] // 2
            return d(d_params, g_params, real[:h], z[:h], z_mix[:h], cutoff, noise_seed, do_r1,
                     aug_p, rows(df, h), rows(dr, h))

        def pl_half(g_params, z, noise_seed, pl_y, pl_mean):
            h = z.shape[0] // 2
            return pl(g_params, z[:h], noise_seed, pl_y[:h], pl_mean)

        fns.update(g_loss_fn=g_half, d_loss_fn=d_half, ppl_penalty=pl_half)
        return fns

    return T, "make_gan_loss_fns", make


def _gan_ema_unchanged():
    import viscoin_tpu_torch.train.gan as T

    return T, "ema_beta", lambda cfg, step, batch: 1.0


def _gan_ema_local_batch():
    import torch.distributed as dist

    import viscoin_tpu_torch.train.gan as T

    orig = T.ema_beta

    def local(cfg, step, batch):  # the half-life counted in this card's images
        world = dist.get_world_size() if dist.is_initialized() else 1
        return orig(cfg, step, batch // world)

    return T, "ema_beta", local


def _gan_no_exchange():
    import viscoin_tpu_torch.train.gan as T

    return T, "_reduced", lambda grads, mesh: grads


def _serve_altered_answer():
    import viscoin_tpu_torch.serve.engine as E

    orig = E.build_endpoint_fns

    def build(models, compute_dtype="float32"):
        fns = dict(orig(models, compute_dtype))
        rec = fns["reconstruct"]

        def altered(images_u8):
            out = dict(rec(images_u8))
            n = models.explainer.linear.out_features
            out["preds"] = (out["preds"] + 1) % n
            return out

        fns["reconstruct"] = altered
        return fns

    return E, "build_endpoint_fns", build


FAULTS = {
    "train_viscoin": {"state_unchanged": _viscoin_state_unchanged,
                      "half_batch": _viscoin_half_batch},
    "train_gan": {"state_unchanged": _gan_state_unchanged, "half_batch": _gan_half_batch,
                  "ema_unchanged": _gan_ema_unchanged, "ema_local_batch": _gan_ema_local_batch,
                  "no_exchange": _gan_no_exchange},
    "serve_reconstruct": {"altered_answer": _serve_altered_answer},
}
# Faults that exist only across cards (on one card they change nothing).
ACROSS_CARDS = {"no_exchange", "ema_local_batch"}
SOUND = "none"  # --fault none: the program as it is (sound runs of many seeds in one process)


@contextlib.contextmanager
def planted(driver: str, fault: str):
    """The program with ``fault`` planted (a module attribute replaced)
    inside the block; :data:`SOUND` plants nothing."""
    if fault == SOUND:
        yield
        return
    module, name, replacement = FAULTS[driver][fault]()
    orig = getattr(module, name)
    setattr(module, name, replacement)
    try:
        yield
    finally:
        setattr(module, name, orig)


def main(argv=None) -> None:
    from perfbench.harness import core, runner

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0,
                    help="the window's length (the checks do not depend on it)")
    args = ap.parse_args(argv)
    bench = core.benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}[args.workload]
    wl = core.load_json(core.workload_file(args.workload))
    config = core.load_json(core.config_file(entry["config"]))
    seeds = [int(s) for s in args.seeds.split(",")]
    jobs = [(args.workload, wl, config, seed, args.seconds, False, time.time()) for seed in seeds]
    if entry["chips"] > 1:  # every rank plants the fault in its own process, runs every seed
        summaries = [by_rank[0] for by_rank in runner.run_ranks_many(
            jobs, entry["chips"], timeout_s=1500, plant=(wl["driver"], args.fault)) if by_rank]
    else:
        with planted(wl["driver"], args.fault):
            summaries = [runner.run_rank(*job) for job in jobs]
    for seed, summary in zip(seeds, summaries):
        if "error" in summary:
            raise RuntimeError(f"seed {seed}, rank {summary['rank']} failed:\n{summary['error']}")
        checks = summary["checks"]
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          "checks": checks,
                          "correct": all(v <= lim for v, lim in checks.values())}), flush=True)


if __name__ == "__main__":
    main()
