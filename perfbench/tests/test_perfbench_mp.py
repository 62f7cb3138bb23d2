"""The ``train_gan_mp`` driver at toy widths on the CPU (32², float16 in
the two top blocks of the 1024 cell's configuration, the program's preset
table set to the same toy widths by ``conftest.py``): a sound run is correct and reads every
block in its dtype; each fault planted under the timed path
(``perfbench/mp_tools.py``'s table) and the control come out not correct
by the cell's own limits. The bfloat16 cell runs at its own batch (16;
``conftest.py`` says why), and its control is the bfloat16 reference with
each block's activations rounded through float8 e5m2."""

from __future__ import annotations

import copy
import math
import time

import pytest
import torch

from perfbench import faults, mp_tools  # noqa: F401 - registers the driver's faults
from perfbench.harness import core, runner
from perfbench.tests.conftest import BF16_TOY_PARAMS

SEED = 2**33 + 17
CPU = torch.device("cpu")
TOY = dict(resolution=32, channel_base=256, channel_max=16, w_dim=16, z_dim=16)
MIXED, BF16 = "stylegan2ada-1024.train", "stylegan2ada-256.train-bf16"


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def toy(cell: str) -> tuple[dict, dict]:
    wl = copy.deepcopy(core.load_json(core.workload_file(cell)))
    config = copy.deepcopy(core.load_json(core.config_file(wl["config"])))
    config["sizes"].update(TOY)
    if cell == MIXED:
        config["sizes"].update(mapping_layers=2, num_fp16_res=2)
    wl["params"].update(BF16_TOY_PARAMS if cell == BF16 else dict(batch_per_card=4, pool=16))
    return wl, config


def run(cell: str, fault: str = faults.SOUND, traced: bool = False) -> dict:
    wl, config = toy(cell)
    with faults.planted("train_gan_mp", fault):
        return runner.run_rank(cell, wl, config, SEED, 0.5, traced, time.time(), device=CPU)


def correct(summary: dict) -> bool:
    return all(v <= lim for v, lim in summary["checks"].values())


def test_a_sound_mixed_run_is_correct_and_traced_reads_its_layers():
    summary = run(MIXED, traced=True)
    assert correct(summary), summary["checks"]
    assert summary["checks"]["fp16_block_gap"] == (0.0, 0.0)
    names = {m["name"] for m in core.metrics_of(core.benchmark(), MIXED, "per_layer")}
    assert {"gan_mixed_mfu_pct", "gan_reg_pct"} <= set(summary["per_layer"]) <= names


@pytest.mark.parametrize("fault", ["half_batch", "state_unchanged", "ema_unchanged",
                                   "fp32_blocks"])
def test_a_planted_fault_is_not_correct(fault):
    summary = run(MIXED, fault)
    assert not correct(summary), summary["checks"]


def control_gaps(cell: str) -> tuple[dict, dict]:
    wl, config = toy(cell)
    ctx = core.Context(cell=cell, wl=wl, config=config, seed=SEED, seconds=1.0, traced=False,
                       t_start=time.time(), device=CPU)
    return core.driver("train_gan_mp").control(ctx, CPU), wl["limits"]


def test_the_control_is_not_correct():
    gaps, limits = control_gaps(MIXED)
    assert any(not v <= limits[k] for k, v in gaps.items()), gaps


def test_the_bf16_cell_reads_its_blocks_and_its_faults():
    sound = run(BF16)
    assert correct(sound), sound["checks"]
    assert sound["checks"]["bf16_block_gap"] == (0.0, 0.0)
    for fault in ("fp32_blocks", "state_unchanged", "half_batch"):
        assert not correct(run(BF16, fault)), fault


def test_the_bf16_control_is_not_correct():
    """The bfloat16 reference with float8 e5m2 block activations fails one
    of the bfloat16 cell's limits."""
    gaps, limits = control_gaps(BF16)
    assert any(not v <= limits[k] for k, v in gaps.items()), gaps


def test_a_program_without_the_precision_counter_fails_at_once(monkeypatch):
    """The parent of this driver's program has no precision counter: the run
    raises before any step."""
    import viscoin_tpu_torch.utils.tracing as tracing

    monkeypatch.delattr(tracing, "reset_precision_counts")
    with pytest.raises(AttributeError):
        run(MIXED)


@pytest.mark.parametrize("cell", [MIXED, BF16])
def test_the_precision_tool_reads_three_comparisons(cell):
    """``mp_tools.py precision``'s readings: the program and the reference at
    the stated precision, each against the float32 reference, and the one
    against the other, every number finite, the blocks' rounding visible in
    the image before any step."""
    wl, config = toy(cell)
    ctx = core.Context(cell=cell, wl=wl, config=config, seed=SEED, seconds=1.0, traced=False,
                       t_start=time.time(), device=CPU)
    out = mp_tools.precision_readings(ctx, CPU)
    assert set(out) == {"program", "stated", "program_vs_stated", "leaves"}
    for key in ("program", "stated", "program_vs_stated"):
        assert all(math.isfinite(v) for v in out[key].values()), out[key]
    assert out["stated"]["image_gap"] > 0 and out["program"]["image_gap"] > 0
