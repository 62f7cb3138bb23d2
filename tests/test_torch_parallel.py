"""Data parallelism in the port (``viscoin_tpu_torch/parallel/mesh.py``) on the
CPU: two gloo processes (``tests/torch_dp_worker.py``) against one process
holding the whole batch, for the collectives (values, first and second
derivatives through ``all_gather_batch``, ``all_mean`` and ``all_sum``;
``all_reduce_grads``, ``broadcast_tree``), the discriminator's minibatch
stddev whose groups span the ranks (and a per-rank control that must
differ), and train-mode BatchNorm on the global batch's statistics; in this
process, the sharded loaders against the unsharded one and the serving
engine over two devices against one. Tolerances (fp32): 1e-5 of each
quantity's scale where only the order of a sum changes."""

import numpy as np
import pytest
import torch

from torch_dp_worker import (
    classifier_inputs,
    free_port,
    gan_inputs,
    run_batchnorm,
    run_classifier_steps,
    run_collectives,
    run_gan_steps,
    run_mbstd,
    run_ranks,
    run_test_viscoin,
)
from torch_port_helpers import IMG, bundle_pair, images
from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from viscoin_tpu_torch.data.datasets import SyntheticDataset
from viscoin_tpu_torch.data.loader import DataLoader, pad_batch
from viscoin_tpu_torch.models.bundle import init_models
from viscoin_tpu_torch.models.lpips import LPIPS
from viscoin_tpu_torch.models.resnet import ConvBN
from viscoin_tpu_torch.parallel import mesh as M
from viscoin_tpu_torch.serve.engine import InferenceEngine

WORLD = 2
TOL = 1e-5


def _close(got, want, tol=TOL, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=msg)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One run of two worker processes over every scenario of this module,
    and the inputs they had."""
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    torch.manual_seed(0)
    layer = ConvBN(3, 4, 3, device="cpu")
    with torch.no_grad():
        layer.bn.weight.copy_(t(4) + 1.0)
        layer.bn.bias.copy_(t(4))
    inputs = {
        "collectives": dict(x=t(6, 5), a=t(5, 3), v=t(5), u=t(6, 5),
                            grads=[{"w": t(3, 2), "b": t(4), "d": t(2, 2).double()}
                                   for r in range(WORLD)]),
        "mbstd": dict(x=t(16, 8, 4, 4), w=t(16, 9, 4, 4)),
        "batchnorm": dict(layer=layer, x=t(8, 3, 6, 6), w=t(8, 4, 6, 6)),
    }
    outs = run_ranks(tmp_path_factory.mktemp("dp"), inputs, WORLD)
    return inputs, outs


def _cat(outs, scenario, key):
    return torch.cat([o[scenario][key] for o in outs])


@pytest.mark.parametrize("key", ["loss", "g", "h"])
def test_collectives_match_one_process(ranks, key):
    """The loss each rank computes through the collectives, its gradient and
    its second derivative (the backward of the backward runs the
    collectives' adjoints again) equal those of one process: the gradient
    and the Hessian-vector product of the sum of every rank's loss,
    computed with the whole batch."""
    inputs, outs = ranks
    inp = inputs["collectives"]
    x = inp["x"].clone().requires_grad_(True)
    b = x.shape[0] // WORLD
    total = 0.0
    for r in range(WORLD):  # every rank's loss, the collectives replaced by their values
        xr, ur = x[r * b:(r + 1) * b], inp["u"][r * b:(r + 1) * b]
        xg = x
        std = torch.sqrt(((xg - xg.mean(0)) ** 2).mean(0) + 1e-8)
        f = (torch.tanh(xg @ inp["a"]) ** 2).sum() + (std * xg[:, :1]).sum()
        m = torch.stack([x[s * b:(s + 1) * b].mean(0) for s in range(WORLD)]).mean(0)
        loss_r = f + (m @ inp["v"]) ** 2 + (torch.sin(xr) * ur).sum() + (x ** 3).sum()
        if key == "loss":
            _close(outs[r]["collectives"]["loss"].numpy(), loss_r.detach().numpy(),
                   msg=f"rank {r}")
        total = total + loss_r
    (g,) = torch.autograd.grad(total, x, create_graph=True)
    (h,) = torch.autograd.grad((g ** 2).sum(), x)
    if key != "loss":
        want = {"g": g, "h": h}[key]
        _close(_cat(outs, "collectives", key).numpy(), want.detach().numpy())
    # Without a mesh the same code is the plain computation on its input.
    plain = run_collectives({**inp, "x": inp["x"][:b], "u": inp["u"][:b]}, None)
    assert plain["loss"].shape == () and plain["g"].shape == (b, 5)


def test_all_reduce_grads_and_broadcast(ranks):
    """all_reduce_grads: each tensor's mean over the ranks, in order and
    shape (one buffer per dtype: the float64 one too); broadcast_tree: rank
    0's values everywhere, in place."""
    inputs, outs = ranks
    grads = inputs["collectives"]["grads"]
    for r in range(WORLD):
        got = outs[r]["collectives"]["mean_grads"]
        for k, t in zip(sorted(grads[0]), got):
            want = sum(g[k].double() for g in grads) / WORLD
            assert t.shape == grads[0][k].shape and t.dtype == grads[0][k].dtype
            _close(t.numpy(), want.to(t.dtype).numpy(), 1e-6, k)
        for k, t in outs[r]["collectives"]["broadcast"].items():
            assert torch.equal(t, grads[0][k]), (r, k)


def test_mbstd_groups_span_the_ranks(ranks):
    """Batch 16, group 4: group m holds samples {m, m + 4, m + 8, m + 12},
    so half of each group lies on the other rank. Over the ranks the layer
    gives each rank its rows of the one-process output, and the gradient
    its rows of the one-process gradient; the statistic taken per rank (as
    a DDP discriminator would) differs."""
    inputs, outs = ranks
    inp = inputs["mbstd"]
    want = run_mbstd(inp, None)
    _close(_cat(outs, "mbstd", "y").numpy(), want["y"].numpy())
    _close(_cat(outs, "mbstd", "g").numpy(), want["g"].numpy())
    per_rank = torch.cat([run_mbstd({"x": inp["x"][r * 8:(r + 1) * 8],
                                     "w": inp["w"][r * 8:(r + 1) * 8]}, None)["y"]
                          for r in range(WORLD)])
    assert float((per_rank - want["y"]).abs().max()) > 1e-2


def test_batchnorm_over_the_ranks(ranks):
    """Train-mode BatchNorm with a mesh normalises with the global batch's
    mean and variance (one differentiable all-reduce): the outputs, the
    gradients (the input's rows; the weights' summed over the ranks, as the
    all-reduce of a step sums the local losses) and the running statistics,
    identical on every rank, equal one process's."""
    inputs, outs = ranks
    inp = inputs["batchnorm"]
    layer = inp["layer"]
    want = run_batchnorm({**inp, "layer": layer}, None)
    _close(_cat(outs, "batchnorm", "y").numpy(), want["y"].numpy())
    _close(_cat(outs, "batchnorm", "gx").numpy(), want["gx"].numpy())
    for key in ("gw", "gscale"):
        _close(sum(o["batchnorm"][key] for o in outs).numpy(), want[key].numpy(), msg=key)
    for o in outs:
        for got, ref in zip(o["batchnorm"]["running"], want["running"]):
            _close(got.numpy(), ref.numpy(), 1e-6)


@pytest.mark.parametrize("kw", [dict(shuffle=False), dict(shuffle=True, seed=3),
                                dict(shuffle=True, pad_final=True)],
                         ids=["ordered", "shuffled", "pad_final"])
def test_sharded_loaders_concatenate_to_the_global_batch(kw):
    """Over 2 and 4 ranks the shards of every global batch concatenate to
    the unsharded loader's batch (13 samples, batch 4: the ragged tail is
    dropped, or with pad_final padded with rows labelled -1, which
    pad_batch masks); every epoch the same."""
    ds = SyntheticDataset(n=13, n_classes=5, image_size=8, mode="test")
    for world in (2, 4):
        one = DataLoader(ds, 4, num_threads=0, **kw)
        shards = [DataLoader(ds, 4, num_threads=0, shard=(r, world), **kw) for r in range(world)]
        for _ in range(2):
            full = [b for b in one if kw.get("pad_final") or b[0].shape[0] == 4]
            parts = list(zip(*[list(s) for s in shards]))
            assert len(parts) == len(full) == (4 if kw.get("pad_final") else 3)
            for (imgs, labels), part in zip(full, parts):
                got_imgs = np.concatenate([p[0] for p in part])
                got_labels = np.concatenate([p[1] for p in part])
                n = imgs.shape[0]
                np.testing.assert_array_equal(got_imgs[:n], imgs)
                np.testing.assert_array_equal(got_labels[:n], labels)
                assert (got_labels[n:] == -1).all() and got_labels.shape[0] == 4
                valid = sum(pad_batch(4 // world, *p)[2].sum() for p in part)
                assert valid == (labels >= 0).sum()


def test_serving_engine_over_two_devices_equals_one():
    """InferenceEngine(devices=["cpu", "cpu"]): one replica each, every
    padded device batch of 4 split 2 + 2; classify, reconstruct and explain
    on 5 images (a ragged chunk) equal the one-device engine's; a batch
    that does not divide over the devices is refused."""
    _, tm = bundle_pair(seed=3)
    u8 = images(5, IMG, seed=4)
    one = InferenceEngine(tm, batch_size=4, compute_dtype="float32", device="cpu")
    two = InferenceEngine(tm, batch_size=4, compute_dtype="float32", device="cpu",
                          devices=["cpu", "cpu"])
    assert len(two.replicas) == 2 and two.replicas[0][1] is not two.replicas[1][1]
    for endpoint in ("classify", "reconstruct", "explain"):
        want, got = getattr(one, endpoint)(u8), getattr(two, endpoint)(u8)
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape and got[k].shape[0] == 5, (endpoint, k)
            if want[k].dtype == np.uint8:
                assert int(np.abs(got[k].astype(int) - want[k].astype(int)).max()) <= 1
            else:
                _close(got[k], want[k], 1e-5, f"{endpoint}.{k}")
    with pytest.raises(ValueError, match="divide by the 2 devices"):
        InferenceEngine(tm, batch_size=3, device="cpu", devices=["cpu", "cpu"])


def test_mesh_helpers_and_refusals(monkeypatch):
    """Without a mesh every collective is the identity and is_main holds;
    make_mesh refuses an environment that names no group (no silent
    one-process fallback); a 2-D mesh of more ranks than the group has is
    refused with the JAX package's words; a batch that
    does not divide over the ranks is refused."""
    x = torch.ones(3)
    assert M.all_mean(x, None) is x and M.all_gather_batch(x, None) is x
    assert M.all_sum(x, None) is x and M.is_main(None)
    M.barrier(None)
    M.broadcast_tree([x], None)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="WORLD_SIZE is not set"):
        M.make_mesh("cpu")
    with pytest.raises(RuntimeError, match="WORLD_SIZE is not set"):
        M.make_mesh_2d(2, 2, "cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")  # JAX's refusal, in its words
    with pytest.raises(ValueError, match="need 4 devices for a 2x2 mesh, have 2"):
        M.make_mesh_2d(2, 2, "cpu")
    mesh = M.Mesh(rank=1, world=2, device=torch.device("cpu"))
    assert not M.is_main(mesh) and mesh.local(8) == 4 and mesh.rows(4) == slice(4, 8)
    with pytest.raises(ValueError, match="does not divide"):
        mesh.local(5)
    padded, n = M.pad_to_multiple(np.arange(5)[:, None], 4)
    assert n == 5 and padded[:, 0].tolist() == [0, 1, 2, 3, 4, 0, 0, 0]


def test_world_1_group_is_the_one_process_run(monkeypatch):
    """A group of one process (what `torchrun --nproc-per-node 1` gives the
    trainers) runs every mesh branch, and its results are the one-process
    results, bit for bit: the GAN steps (mbstd gathered, gradients and
    statistics all-reduced), the classifier steps (global BatchNorm) and
    test_viscoin on a test set with a ragged last batch, which an unsharded
    loader keeps."""
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(free_port())).items():
        monkeypatch.setenv(k, v)
    mesh = M.make_mesh("cpu")
    try:
        assert (mesh.rank, mesh.world) == (0, 1)
        for run, inputs in ((run_gan_steps, gan_inputs), (run_classifier_steps,
                                                          classifier_inputs)):
            got, want = run(inputs(), mesh), run(inputs(), None)
            for key in want:
                if key in ("g", "d", "g_ema", "exp_avg", "state"):
                    for n, t in want[key].items():
                        assert torch.equal(got[key][n], t), (key, n)
                elif isinstance(want[key], torch.Tensor):
                    assert torch.equal(got[key], want[key]), key
                else:
                    assert got[key] == want[key], key
        _, tm = bundle_pair(seed=6)
        proj = np.random.default_rng(0).standard_normal((3 * 32 * 32, 6)).astype(np.float32)
        inp = dict(models=tm, lpips=init_models(LPIPS(device="cpu"), 2), n=7, n_classes=5,
                   size=32, batch=4, probe_images=torch.from_numpy(images(4, 32, 9)),
                   proj=torch.from_numpy(proj))
        got, want = run_test_viscoin(inp, mesh), run_test_viscoin(inp, None)
        assert got["results"] == want["results"] and torch.equal(got["probe"], want["probe"])
    finally:
        M.destroy_mesh(mesh)
