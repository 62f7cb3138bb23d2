"""``python -m viscoin_tpu_torch train viscoin|gan --device cpu --model-parallel
2`` as two gloo processes of one group (``tests/torch_dp_worker.py``, each in
its own working directory, ``main`` called in-process with the function
that builds the models patched to toy widths), on a (1 data, 2 model) mesh:
``train viscoin`` (the widths of tests/torch_port_helpers.py) on the
synthetic 32² dataset, 2 iterations with a checkpoint after each, then a
resume to 3 from rank 0's training state; ``train gan --data-parallel`` (the
toy GAN of tests/test_torch_gan_cli.py) on 8 synthetic 16² images, 2
iterations, a resume to 4 from rank 0's training state, and an unbroken run
to 4."""

import json
import os
from dataclasses import fields

import numpy as np
import torch

from torch_dp_worker import free_port, run_ranks
from torch_port_helpers import CLASSIFIER, GAN, PSI
from viscoin_tpu.utils.types import TestingResults as JTestingResults
from viscoin_tpu.utils.types import TrainingResults as JTrainingResults


def test_train_viscoin_model_parallel_command(tmp_path):
    """Rank 0 alone writes (the jsonl of every eval, the bundles, the
    training state; rank 1's directory stays empty); the records carry the
    JAX command's keys with finite values; the resumed run continues from
    step 2 and writes its own record."""
    command = dict(dir=str(tmp_path / "command"), classifier=CLASSIFIER, psi=PSI, gan=GAN,
                   ports=[free_port(), free_port()],
                   argv=["--model-parallel", "2", "--checkpoint-every", "1"], epochs=(2, 3))
    cmd = [c["command"] for c in run_ranks(tmp_path, {"command": command}, 2, timeout=240)]
    assert all(c["rcs"] == [0, 0] for c in cmd), cmd
    assert cmd[1]["first"] == [] and cmd[1]["files"] == []
    assert {"viscoin_2.jsonl", "viscoin_3.jsonl", "viscoin0-2", "viscoin1-2", "viscoin2-3",
            "train_state"} <= set(cmd[0]["files"]), cmd[0]["files"]
    work = os.path.join(command["dir"], "rank0")
    want = {f"train_{f.name}" for f in fields(JTrainingResults)} | {
        f"test_{f.name}" for f in fields(JTestingResults)}
    with open(os.path.join(work, "viscoin_2.jsonl")) as f:
        first = [json.loads(line) for line in f]
    with open(os.path.join(work, "viscoin_3.jsonl")) as f:
        resumed = [json.loads(line) for line in f]
    assert len(first) == 2 and len(resumed) == 1
    for rec in first + resumed:
        assert set(rec) == want
        assert all(np.isfinite(v) for k, v in rec.items() if k != "test_fid_score"), rec
    state = torch.load(os.path.join(work, "train_state", "train_state.pt"), weights_only=True)
    assert state["step"] == 3


def test_train_gan_model_parallel_command(tmp_path):
    """``train gan --data-parallel --model-parallel 2``: every run exits 0;
    rank 0 alone writes (the jsonl, the export, the training state; rank
    1's directories stay empty); the resumed run's training state after
    4 steps is bit-equal to the unbroken run's (R1 and the path length at
    step 0, the loader fast-forwarded, the draws from (seed, step))."""
    command = dict(dir=str(tmp_path / "gan"), size=16, epochs=(2, 4),
                   ports=[free_port() for _ in range(3)],
                   g=dict(z_dim=8, w_dim=16, channel_base=256, channel_max=16,
                          mapping_layers=1),
                   d=dict(channel_base=256, channel_max=16),
                   argv=["--data-parallel", "--model-parallel", "2"])
    out = [c["gan_command"] for c in run_ranks(tmp_path, {"gan_command": command}, 2,
                                               timeout=240)]
    assert all(c["rcs"] == [0, 0, 0] for c in out), out
    assert out[1]["files"] == [] and out[1]["files_c"] == [], out[1]
    assert {"gan", "gan.train_state", "gan_2.jsonl", "gan_4.jsonl"} <= set(out[0]["files"])
    assert {"gan", "gan.train_state", "gan_4.jsonl"} <= set(out[0]["files_c"])
    resumed, unbroken = out[0]["states"]
    assert resumed["step"] == unbroken["step"] == 4
    _assert_equal(resumed, unbroken)
    with open(os.path.join(command["dir"], "rank0", "gan_2.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["iteration"] for r in records] == [0, 1]
    assert records[0]["r1"] > 0 and records[0]["pl_lengths"] > 0
    assert all(np.isfinite(v) for r in records for v in r.values()), records


def _assert_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            _assert_equal(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path
