"""``python -m viscoin_tpu_torch train viscoin --device cpu --model-parallel 2``
as two gloo processes of one group (``tests/torch_dp_worker.py``, each in
its own working directory, ``main`` called in-process with the function
that builds the models patched to the toy widths of
tests/torch_port_helpers.py), on the
synthetic 32² dataset: a (1 data, 2 model) mesh, 2 iterations with a
checkpoint after each, then a resume to 3 from rank 0's training state."""

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
