"""The tools and toy tables of the driver tests for the ``train_gan_mp``
driver, which they key by name: ``faults.FAULTS`` and ``phases.TOPS``
(``perfbench/mp_tools.py`` registers them), ``test_perfbench_drivers.py``'s
toy sizes and parameters, and the program's preset table at the same toy
widths while a test runs. The bfloat16 cell keeps its own batch (16) at the
toy widths: at batch 4 the first gradient of a bfloat16 step, the program's
and the plain reference's under bfloat16 autocast alike, departs from the
float32 one by 0.48-0.66 (``grad_gap``, worst leaf), where the cell at full
size reads 0.03-0.22; at batch 16 the toy reads 0.10-0.19."""

import copy

import pytest

from perfbench import mp_tools  # noqa: F401
from perfbench.tests import test_perfbench_drivers as drivers

TOY_PRESET = dict(z_dim=16, w_dim=16, mapping_layers=2, channel_base=256, channel_max=16,
                  mbstd_group_size=4, num_fp16_res=2, conv_clamp=256.0)
drivers.TOY_SIZES.setdefault("stylegan2ada-1024", dict(
    resolution=32, channel_base=256, channel_max=16, w_dim=16, z_dim=16, mapping_layers=2,
    num_fp16_res=2))
drivers.TOY_PARAMS.setdefault("train_gan_mp", dict(batch_per_card=4, pool=16))
BF16_CELL = "stylegan2ada-256.train-bf16"
BF16_TOY_PARAMS = dict(batch_per_card=16, pool=64)  # the cell's own batch


@pytest.fixture(autouse=True)
def toy_preset(monkeypatch):
    """The preset the 1024 cell's configuration names, at the toy widths."""
    import viscoin_tpu_torch.train.gan as T

    table = copy.deepcopy(T.GAN_PRESETS)
    table["paper1024"]["model"] = dict(TOY_PRESET)
    monkeypatch.setattr(T, "GAN_PRESETS", table)


@pytest.fixture(autouse=True)
def bf16_cell_at_its_batch(monkeypatch):
    """``test_perfbench_drivers.toy`` with the bfloat16 cell at its own batch."""
    toy = drivers.toy

    def with_batch(cell: str):
        wl, config = toy(cell)
        if cell == BF16_CELL:
            wl["params"].update(BF16_TOY_PARAMS)
        return wl, config

    monkeypatch.setattr(drivers, "toy", with_batch)
