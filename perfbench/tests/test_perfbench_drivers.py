"""Each traffic driver at toy widths on the CPU, through the harness without
its look for a card: a sound run is correct; every fault a cell can have,
planted under the timed path, and the control (the reference in bfloat16)
come out not correct by the cell's own limits. On the card the same runs
are made at the cells' sizes by ``perfbench/faults.py`` and
``perfbench/control.py``; the test marked ``gpu`` runs a cell there."""

from __future__ import annotations

import copy
import time

import pytest
import torch

from perfbench import faults
from perfbench.harness import core, runner

TOY_SIZES = {
    "viscoin-cub256": dict(resolution=32, channel_base=256, channel_max=16, n_classes=10,
                           n_concepts=8, w_dim=16, z_dim=16),
    "stylegan2ada-256": dict(resolution=32, channel_base=256, channel_max=16, w_dim=16, z_dim=16),
}
TOY_PARAMS = {
    "train_viscoin": dict(batch=2, pool=8),
    "train_gan": dict(batch_per_card=4, pool=16),
    "serve_reconstruct": dict(rate=20.0, device_batch=4, pool=16, clients=16, check_requests=8),
}
# Every one-card cell with a file, also one kept for a later benchmark (PERF.md).
CELLS = {f.stem: w for f in sorted((core.HERE / "workloads").glob("*.json"))
         if (w := core.load_json(f))["chips"] == 1}
SEED = 2**33 + 17  # wider than 32 bits, as the driver's seeds are
CPU = torch.device("cpu")


def toy(cell: str) -> tuple[dict, dict]:
    wl = copy.deepcopy(core.load_json(core.workload_file(cell)))
    config = copy.deepcopy(core.load_json(core.config_file(wl["config"])))
    config["sizes"].update(TOY_SIZES[wl["config"]])
    wl["params"].update(TOY_PARAMS[wl["driver"]])
    return wl, config


def run(cell: str, traced: bool = False, seconds: float = 0.5) -> dict:
    wl, config = toy(cell)
    return runner.run_rank(cell, wl, config, SEED, seconds, traced, time.time(), device=CPU)


def correct(summary: dict) -> bool:
    return bool(summary["checks"]) and all(v <= lim for v, lim in summary["checks"].values())


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(cell):
    summary = run(cell)
    assert correct(summary), summary["checks"]
    assert summary["setup_s"] > 0 and summary["attempted"] > 0 and summary["failed"] == 0
    e2e = {m["name"] for m in core.metrics_of(core.benchmark(), cell, "end_to_end")}
    assert e2e - {"setup_s", "peak_mem_gib"} <= set(summary["e2e"])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_traced_run_reads_its_layers(cell):
    summary = run(cell, traced=True)
    assert correct(summary) and summary["window_s"] > 0
    assert set(summary["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in core.metrics_of(core.benchmark(), cell, "per_layer")}
    assert set(summary["per_layer"]) <= names  # no device on the CPU: rooflines stay silent


FAULTS = [(cell, f) for cell, w in sorted(CELLS.items()) for f in faults.FAULTS[w["driver"]]
          if f not in faults.ACROSS_CARDS]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not_correct(cell, fault):
    wl, _ = toy(cell)
    with faults.planted(wl["driver"], fault):
        summary = run(cell)
    assert not correct(summary), summary["checks"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_is_not_correct(cell):
    wl, config = toy(cell)
    ctx = core.Context(cell=cell, wl=wl, config=config, seed=SEED, seconds=1.0, traced=False,
                       t_start=time.time(), device=CPU)
    gaps = core.driver(wl["driver"]).control(ctx, CPU)
    assert any(not v <= wl["limits"][k] for k, v in gaps.items()), gaps


@pytest.mark.gpu
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = "viscoin-cub256.serve-reconstruct"
    wl = core.load_json(core.workload_file(cell))
    config = core.load_json(core.config_file(wl["config"]))
    summary = runner.run_rank(cell, wl, config, SEED, 2.0, False, time.time())
    assert correct(summary), summary["checks"]


def _two_ranks_args(seed: int = SEED) -> tuple:
    cell = "stylegan2ada-256.train-dp4"
    wl, config = toy("stylegan2ada-256.train")
    wl = dict(wl, chips=4)
    return (cell, wl, config, seed, 0.5, False, time.time())


def _two_ranks(plant=None) -> list[dict]:
    return runner.run_ranks(_two_ranks_args(), 2, timeout_s=600, device_type="cpu", plant=plant)


def test_data_parallel_ranks_over_gloo_are_correct():
    summaries = _two_ranks()
    assert correct(summaries[0]), summaries[0]["checks"]
    out, ok = runner.assemble(core.benchmark(), "stylegan2ada-256.train-dp4", 2, False, summaries)
    assert ok and out["attempted"] == summaries[0]["attempted"]


def test_data_parallel_without_the_exchange_is_not_correct():
    summaries = _two_ranks(plant=("train_gan", "no_exchange"))
    assert not correct(summaries[0]), summaries[0]["checks"]


def test_data_parallel_ema_over_the_local_batch_is_not_correct():
    summaries = _two_ranks(plant=("train_gan", "ema_local_batch"))
    assert not correct(summaries[0]), summaries[0]["checks"]
    assert summaries[0]["checks"]["ema_gap"][0] > summaries[0]["checks"]["ema_gap"][1]


def test_several_seeds_share_the_ranks():
    jobs = [_two_ranks_args(SEED), _two_ranks_args(SEED + 1)]
    by_job = runner.run_ranks_many(jobs, 2, timeout_s=600, device_type="cpu",
                                   plant=("train_gan", faults.SOUND))
    assert [[s["rank"] for s in ranks] for ranks in by_job] == [[0, 1], [0, 1]]
    assert all(correct(ranks[0]) for ranks in by_job), [r[0]["checks"] for r in by_job]
