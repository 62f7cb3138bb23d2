"""The port's checkpoints against the JAX package's, on the CPU: a bundle the
port saves is the JAX package's npz layout (its ``restore_pytree`` gives back
the JAX variables exactly, its ``load_viscoin_bundle`` serves it through the
JAX ``InferenceEngine`` as the port serves it), a JAX-layout npz bundle loads
into the port, the inverse weight map covers every collection, and the
training state saves and restores with the meta check, asynchronous writes,
``wait_for_saves`` and the ``.old`` fallback of the atomic install."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import (images, jax_bundle, jax_variables, perturb, run_once,
                                torch_bundle)
from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from viscoin_tpu.models.stylegan import Generator as JGenerator
from viscoin_tpu.serve.engine import InferenceEngine as JaxInferenceEngine
from viscoin_tpu.utils import checkpoints as jckpt
from viscoin_tpu_torch.models.stylegan import Generator
from viscoin_tpu_torch.serve.engine import InferenceEngine
from viscoin_tpu_torch.train import viscoin as T
from viscoin_tpu_torch.utils import checkpoints as ckpt
from viscoin_tpu_torch.utils.weights import bundle_to_jax_tree, load_jax_tree, module_to_jax_tree


@pytest.fixture(scope="module")
def pair():
    jm = jax_bundle(seed=6)
    return jm, torch_bundle(jm)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jax_tree(jm):
    return {"classifier": jm.classifier_vars, "concept_extractor": jm.concept_params,
            "explainer": jm.explainer_params, "gan": jm.gan_vars}


def test_port_bundle_is_the_jax_layout(pair, tmp_path):
    """The JAX package's restore_pytree of a bundle the port saved is the
    JAX variables, key for key and bit for bit; its config has JAX's fields."""
    jm, tm = pair
    ckpt.save_viscoin(tm, str(tmp_path / "b"))
    assert sorted(os.listdir(tmp_path / "b")) == ["arrays.npz", "viscoin_config.json"]
    got, want = _flat(jckpt.restore_pytree(str(tmp_path / "b"))), _flat(_jax_tree(jm))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with open(tmp_path / "b" / "viscoin_config.json") as f:
        assert json.load(f) == json.loads(json.dumps(jckpt._module_config(jm)))


def test_jax_serves_a_port_bundle_as_the_port_does(pair, tmp_path):
    """JAX load_viscoin_bundle of the port's save (the variables it restores
    are the JAX ones bit for bit, test above) serves through the JAX engine
    as the port's engine serves the port's bundle: logits within 1e-4, u8
    within one level."""
    jm, tm = pair
    ckpt.save_viscoin(tm, str(tmp_path / "b"), async_save=True)
    ckpt.wait_for_saves()
    loaded = jckpt.load_viscoin_bundle(str(tmp_path / "b"))
    imgs = images(3, seed=21)
    jeng = JaxInferenceEngine(loaded, batch_size=4)
    teng = InferenceEngine(tm, batch_size=4, device="cpu")
    want = jeng.reconstruct(imgs)
    got = teng.reconstruct(imgs)
    assert np.abs(got["reconstruction_u8"].astype(int)
                  - want["reconstruction_u8"].astype(int)).max() <= 1
    np.testing.assert_allclose(teng.classify(imgs)["logits"], jeng.classify(imgs)["logits"],
                               rtol=1e-4, atol=1e-4)


def test_jax_layout_npz_loads_into_the_port(pair, tmp_path):
    """A bundle in the JAX package's npz layout (its own key flattening and
    module config) loads through the port's load_viscoin_bundle to the same
    weights the port carries across from the JAX variables."""
    jm, tm = pair
    keys, vals, _ = jckpt._flat_keys(_jax_tree(jm))
    os.makedirs(tmp_path / "j")
    np.savez(tmp_path / "j" / "arrays.npz", **dict(zip(keys, [np.asarray(v) for v in vals])))
    with open(tmp_path / "j" / "viscoin_config.json", "w") as f:
        json.dump(jckpt._module_config(jm), f)
    loaded = ckpt.load_viscoin_bundle(str(tmp_path / "j"), device="cpu")
    want = tm.state_dict()
    got = loaded.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_inverse_map_round_trips_every_collection():
    """module_to_jax_tree of the original generator gives JAX's params,
    noise and moving_stats back; bundle_to_jax_tree drops num_batches_tracked."""
    g = JGenerator(z_dim=16, w_dim=32, img_resolution=16, channel_base=512, channel_max=32,
                   mapping_layers=2)
    v = perturb(run_once(lambda k: g.init({"params": k}, jnp.zeros((1, 16)), noise_mode="const"),
                         jax.random.PRNGKey(0)), 1)
    tg = load_jax_tree(Generator(z_dim=16, w_dim=32, img_resolution=16, channel_base=512,
                                 channel_max=32, mapping_layers=2, device="cpu"), v)
    got, want = _flat(module_to_jax_tree(tg)), _flat(v)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_orbax_directories_raise_naming_the_npz_layout(tmp_path):
    os.makedirs(tmp_path / "orbax")
    (tmp_path / "orbax" / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="npz layout"):
        ckpt.restore_pytree(str(tmp_path / "orbax"))
    with pytest.raises(ValueError, match="orbax.*arrays.npz"):
        ckpt.restore_train_state(None, str(tmp_path / "orbax"))


def _state(tm):
    cfg = T.VisCoINTrainingParams(gradient_accumulation=2)
    state = T.create_train_state(tm, cfg)
    for grp in state.params.values():
        for p in grp.values():
            p.grad = torch.ones_like(p)
    T.optimizer_update(state, cfg, lambda s: 1e-3)
    T.optimizer_update(state, cfg, lambda s: 1e-3)  # one Adam update: the states are set
    for grp in state.params.values():
        for p in grp.values():
            p.grad = torch.full_like(p, 0.5)
    T.optimizer_update(state, cfg, lambda s: 1e-3)  # one micro-step into the next window
    return state


def test_train_state_round_trip_and_meta(pair, tmp_path):
    """Step, parameters, both Adam states and the accumulation buffers come
    back exactly into a fresh state; the snapshot is taken before an
    asynchronous save returns (later in-place updates do not reach it)."""
    _, tm = pair
    import copy

    m = copy.deepcopy(tm)
    state = _state(m)
    meta = {"fake_presample_steps": 2, "batch_size": 8, "seed": 0, "compute_dtype": "float32"}
    ckpt.save_train_state(state, str(tmp_path / "s"), meta=meta, async_save=True)
    want = ckpt.train_state_dict(state)
    with torch.no_grad():
        for grp in state.params.values():
            for p in grp.values():
                p.add_(1.0)  # the next step's in-place update, racing the writer
    ckpt.wait_for_saves()
    fresh_m = copy.deepcopy(tm)
    fresh = T.create_train_state(fresh_m, T.VisCoINTrainingParams(gradient_accumulation=2))
    ckpt.restore_train_state(fresh, str(tmp_path / "s"), expect_meta=meta)
    got = ckpt.train_state_dict(fresh)
    assert got["step"] == want["step"] == 3
    for g in want["params"]:
        for n in want["params"][g]:
            assert torch.equal(got["params"][g][n], want["params"][g][n])
            assert torch.equal(got["acc"][g][n], want["acc"][g][n])
    for key in ("opt", "gan_opt"):
        for i, st in want[key]["state"].items():
            for name, t in st.items():
                assert torch.equal(got[key]["state"][i][name], t), (key, i, name)
    with pytest.raises(ValueError, match="seed: 0 != 1"):
        ckpt.restore_train_state(fresh, str(tmp_path / "s"), expect_meta=dict(meta, seed=1))
    with pytest.raises(ValueError, match="accumulation"):
        ckpt.restore_train_state(T.create_train_state(fresh_m, T.VisCoINTrainingParams()),
                                 str(tmp_path / "s"))


def test_old_fallback_across_the_crash_window(pair, tmp_path):
    """A crash between the install's two renames leaves only <path>.old:
    both the bundle and the training state load from it. A crash while
    writing leaves <path>.tmp beside the intact checkpoint."""
    _, tm = pair
    path = str(tmp_path / "b")
    ckpt.save_viscoin(tm, path)
    os.rename(path, path + ".old")
    loaded = ckpt.load_viscoin_bundle(path, device="cpu")
    assert torch.equal(loaded.explainer.linear.weight, tm.explainer.linear.weight)
    ckpt.save_viscoin(tm, path)  # a new save replaces the stale .old
    assert os.path.isdir(path) and not os.path.exists(path + ".old")

    def crash(tmp):
        raise OSError("disk full")

    with pytest.raises(OSError, match="disk full"):
        ckpt._atomic_install(path, crash)
    assert os.path.isdir(path + ".tmp") and os.path.isdir(path)
    ckpt.load_viscoin_bundle(path, device="cpu")

    import copy

    state = T.create_train_state(copy.deepcopy(tm), T.VisCoINTrainingParams())
    ckpt.save_train_state(state, str(tmp_path / "s"), meta={"seed": 0})
    os.rename(tmp_path / "s", str(tmp_path / "s") + ".old")
    ckpt.restore_train_state(state, str(tmp_path / "s"), expect_meta={"seed": 0})


def test_wait_for_saves_joins_every_save_then_raises_the_first_error(pair, tmp_path):
    _, tm = pair
    order = []

    def failing(tmp):
        order.append("fail")
        raise RuntimeError("first")

    ckpt._writer.submit(ckpt._atomic_install, str(tmp_path / "x"), failing)
    ckpt.save_viscoin(tm, str(tmp_path / "y"), async_save=True)
    ckpt._writer.submit(ckpt._atomic_install, str(tmp_path / "z"), failing)
    with pytest.raises(RuntimeError, match="first"):
        ckpt.wait_for_saves()
    assert order == ["fail", "fail"]
    assert os.path.isdir(tmp_path / "y")  # the save between the failures was installed
    ckpt.wait_for_saves()  # nothing pending


def test_bundle_to_jax_tree_matches_the_helpers_variables(pair):
    jm, tm = pair
    got, want = _flat(bundle_to_jax_tree(tm)), _flat(_jax_tree(jm))
    assert sorted(got) == sorted(want)
    assert set(jax_variables(jm)) == {"classifier", "psi", "theta", "gan"}
