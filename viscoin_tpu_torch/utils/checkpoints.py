"""Checkpoints: the model bundle in the JAX package's npz layout, and the
training state in the port's own format.

Counterpart of ``viscoin_tpu/utils/checkpoints.py``.

  * A **bundle** (:func:`save_viscoin`, :func:`load_viscoin`,
    :func:`load_viscoin_bundle`) is a directory with ``arrays.npz``, keyed by
    the JAX pytree paths joined by "/" (``classifier/params/...``,
    ``classifier/batch_stats/...``, ``concept_extractor/...``,
    ``explainer/...``, ``gan/params/...``, ``gan/noise/...``) in the JAX
    layouts (HWIO convs, (in, out) Dense kernels, HWC constant), and
    ``viscoin_config.json`` with the modules' hyperparameters. The JAX
    package's ``restore_pytree`` and ``load_viscoin_bundle`` read it, and this
    module reads such a bundle written by the JAX side. A JAX checkpoint
    written by orbax cannot be read without JAX: loading one raises.
  * A **training state** (:func:`save_train_state`,
    :func:`restore_train_state`) is a directory with ``train_state.pt``
    (step, trainable parameters, both Adam ``state_dict``s, gradient
    accumulation buffers) and ``train_state_meta.json``, the run's
    invariants under the JAX package's keys and mismatch rule. The GAN
    trainer's (:func:`save_gan_train_state`, :func:`restore_gan_train_state`)
    has the same two files, with the generator, discriminator and EMA state
    dicts, both Adams, w_avg, pl_mean and the ADA state.

Every save is atomic: written into ``<path>.tmp`` and swapped in by two
renames, so a crash leaves the old or the new checkpoint loadable (between
the renames the old one survives as ``<path>.old``, which loading falls back
to). With ``async_save`` the host snapshot is taken before the call returns
(the training step updates the parameters in place, so the copy cannot
wait) and the write runs on one background thread, in submission order;
:func:`wait_for_saves` joins every pending save and then raises the first
error.

Under data parallelism every rank holds the same state: rank 0 alone
writes (the trainers guard their saves with ``parallel.mesh.is_main``) and
the other ranks wait for its writes at :func:`wait_for_saves`' barrier;
every rank reads a checkpoint on resume.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from viscoin_tpu_torch.models.bundle import VisCoINModels
from viscoin_tpu_torch.models.concept_extractor import ConceptExtractor
from viscoin_tpu_torch.models.explainer import Explainer
from viscoin_tpu_torch.models.resnet import Classifier
from viscoin_tpu_torch.models.stylegan import GeneratorAdapted
from viscoin_tpu_torch.parallel.mesh import barrier
from viscoin_tpu_torch.utils.weights import bundle_to_jax_tree, load_jax_variables

NPZ_NAME = "arrays.npz"
CONFIG_NAME = "viscoin_config.json"
STATE_NAME = "train_state.pt"
META_NAME = "train_state_meta.json"
_OLD, _TMP = ".old", ".tmp"


class _Writer:
    """One background writer thread and the futures of its pending saves."""

    def __init__(self):
        self._pool: ThreadPoolExecutor | None = None
        self._pending: list[Future] = []
        self._lock = threading.Lock()

    def submit(self, fn, *args) -> None:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
            self._pending.append(self._pool.submit(fn, *args))

    def wait(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        first_error = None
        for fut in pending:
            try:
                fut.result()
            except BaseException as e:  # noqa: BLE001 - re-raised below, after every join
                if first_error is None:
                    first_error = e
        if first_error is not None:
            raise first_error


_writer = _Writer()


def wait_for_saves(mesh=None) -> None:
    """Block until every pending asynchronous save has been installed; then
    raise the first writer error, if any. With a data-parallel ``mesh``,
    then wait for every rank (rank 0's writes are on disk for all)."""
    _writer.wait()
    barrier(mesh)


def _atomic_install(path: str, write_fn) -> None:
    """``write_fn(tmp_dir)``, then swap ``tmp_dir`` into ``path``."""
    path = os.path.abspath(path)
    tmp, old = path + _TMP, path + _OLD
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    write_fn(tmp)
    shutil.rmtree(old, ignore_errors=True)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


def _resolve_existing(path: str) -> str:
    """The installed checkpoint: ``path``, or the ``.old`` fallback a crash
    between the two renames leaves."""
    path = os.path.abspath(path)
    if not os.path.exists(path) and os.path.exists(path + _OLD):
        return path + _OLD
    return path


def _save(path: str, write_fn, async_save: bool) -> None:
    if async_save:
        _writer.submit(_atomic_install, path, write_fn)
    else:
        _atomic_install(path, write_fn)


def _write_text(directory: str, files: dict[str, str]) -> None:
    for name, text in files.items():
        with open(os.path.join(directory, name), "w") as f:
            f.write(text)


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    out: dict = {}
    for key, value in flat.items():
        node = out
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out


def save_pytree(tree: dict, path: str, async_save: bool = False,
                extra_files: dict[str, str] | None = None) -> None:
    """Save a nested dict of arrays as ``arrays.npz`` (keys joined by "/"),
    with ``extra_files`` ({name: text}) in the same atomic unit. The arrays
    are copied to the host before this returns."""
    flat = {k: np.array(v) for k, v in _flatten(tree).items()}

    def write(tmp):
        np.savez(os.path.join(tmp, NPZ_NAME), **flat)
        _write_text(tmp, extra_files or {})

    _save(path, write, async_save)


def restore_pytree(path: str) -> dict:
    """A nested dict of numpy arrays from a directory in the npz layout (the
    JAX package's ``restore_pytree`` of such a directory gives the same)."""
    wait_for_saves()
    path = _resolve_existing(path)
    npz = os.path.join(path, NPZ_NAME)
    if not os.path.exists(npz):
        raise ValueError(
            f"{path}: no {NPZ_NAME}. The port reads checkpoints in the JAX package's npz layout "
            f"(a directory holding {NPZ_NAME}, keyed by the pytree paths joined by '/'); an "
            "orbax checkpoint cannot be read without JAX: re-save it there with "
            "np.savez over the flattened tree, or port the torch checkpoint it came from with "
            "`python -m viscoin_tpu_torch port-weights`")
    with np.load(npz) as data:
        return _unflatten({k: data[k] for k in data.files})


# ------------------------------- the bundle -------------------------------- #


def module_config(models: VisCoINModels) -> dict:
    """The hyperparameters ``viscoin_config.json`` records, with the JAX
    package's field names."""
    return {
        "classifier": dict(models.classifier.config),
        "concept_extractor": dict(models.concept_extractor.config),
        "explainer": dict(models.explainer.config),
        "gan": dict(models.gan.config),
    }


def save_viscoin(models: VisCoINModels, path: str, async_save: bool = False) -> None:
    """Save the ensemble as a bundle in the JAX package's npz layout."""
    save_pytree(bundle_to_jax_tree(models), path, async_save=async_save,
                extra_files={CONFIG_NAME: json.dumps(module_config(models), indent=2)})


def load_viscoin(models: VisCoINModels, path: str) -> VisCoINModels:
    """Load a bundle into existing modules (in place); raises on any key
    missing or left over."""
    tree = restore_pytree(path)
    return load_jax_variables(models, {"classifier": tree["classifier"],
                                       "psi": tree["concept_extractor"],
                                       "theta": tree["explainer"], "gan": tree["gan"]})


def load_viscoin_bundle(path: str, device="cuda") -> VisCoINModels:
    """Build the modules a bundle's ``viscoin_config.json`` describes, on
    ``device``, and load its weights."""
    with open(os.path.join(_resolve_existing(path), CONFIG_NAME)) as f:
        cfg = json.load(f)
    for key in ("classifier",):
        for name in ("hidden_sizes", "depths"):
            if name in cfg[key]:
                cfg[key][name] = tuple(cfg[key][name])
    models = VisCoINModels(
        classifier=Classifier(**cfg["classifier"], device=device),
        concept_extractor=ConceptExtractor(**cfg["concept_extractor"], device=device),
        explainer=Explainer(**cfg["explainer"], device=device),
        gan=GeneratorAdapted(**cfg["gan"], device=device),
    )
    return load_viscoin(models, path).eval()


# ---------------------------- the training state ---------------------------- #


def _check_meta(path: str, expect_meta: dict | None) -> None:
    """A key the current run expects and the checkpoint does not record, or
    records with another value, is a mismatch."""
    meta_path = os.path.join(_resolve_existing(path), META_NAME)
    if expect_meta is None or not os.path.exists(meta_path):
        return
    with open(meta_path) as f:
        saved = json.load(f)
    diffs = {k: (saved.get(k, "<absent from checkpoint>"), v)
             for k, v in expect_meta.items() if saved.get(k) != v}
    if diffs:
        raise ValueError("resume mismatch vs checkpoint metadata (saved != current): "
                         + ", ".join(f"{k}: {a} != {b}" for k, (a, b) in diffs.items()))


def _to_host(obj: Any) -> Any:
    """A deep copy with every tensor on the host."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def train_state_dict(state) -> dict:
    """The training state as host tensors: step, trainable parameters by
    group and name, both Adam state_dicts, accumulation buffers."""
    return _to_host({
        "step": int(state.step),
        "params": {g: {n: p for n, p in grp.items()} for g, grp in state.params.items()},
        "opt": state.opt.state_dict(),
        "gan_opt": state.gan_opt.state_dict(),
        "acc": state.acc,
    })


def save_train_state(state, path: str, meta: dict | None = None,
                     async_save: bool = False) -> None:
    """Save a ``train.viscoin.TrainState`` (snapshot to the host now)."""
    snapshot = train_state_dict(state)
    extra = {META_NAME: json.dumps(meta, indent=2)} if meta is not None else {}

    def write(tmp):
        torch.save(snapshot, os.path.join(tmp, STATE_NAME))
        _write_text(tmp, extra)

    _save(path, write, async_save)


@torch.no_grad()
def restore_train_state(state, path: str, expect_meta: dict | None = None):
    """Restore into a freshly created TrainState (in place: parameters,
    optimizer states, accumulation buffers, step). ``expect_meta``: the
    current run's invariants; a mismatch raises."""
    wait_for_saves()
    _check_meta(path, expect_meta)
    file = os.path.join(_resolve_existing(path), STATE_NAME)
    if not os.path.exists(file):
        raise ValueError(
            f"{path}: no {STATE_NAME}. The port resumes from its own training state "
            f"({STATE_NAME} + {META_NAME}, written by save_train_state); a JAX train_state "
            "written by orbax cannot be read without JAX (bundles use the npz layout, "
            f"{NPZ_NAME})")
    saved = torch.load(file, map_location="cpu", weights_only=True)
    for g, grp in state.params.items():
        missing = sorted(grp.keys() ^ saved["params"].get(g, {}).keys())
        if missing:
            raise KeyError(f"train state {path}: parameters of {g} differ: {missing[:10]}")
        for n, p in grp.items():
            p.copy_(saved["params"][g][n])
    state.opt.load_state_dict(saved["opt"])
    state.gan_opt.load_state_dict(saved["gan_opt"])
    if (saved["acc"] is None) != (state.acc is None):
        raise ValueError(f"train state {path}: gradient accumulation differs from this run")
    if state.acc is not None:
        for g, grp in state.acc.items():
            for n, buf in grp.items():
                buf.copy_(saved["acc"][g][n])
    state.step = int(saved["step"])
    return state


# -------------------------- the GAN training state -------------------------- #


def gan_train_state_dict(state) -> dict:
    """A ``train.gan.GANTrainState`` as host tensors: step, the generator's,
    discriminator's and EMA's state dicts, both Adam state_dicts, w_avg,
    pl_mean, ada_p and the r_t accumulator."""
    return _to_host({
        "step": int(state.step),
        "generator": state.generator.state_dict(),
        "discriminator": state.discriminator.state_dict(),
        "g_ema": state.g_ema.state_dict(),
        "g_opt": state.g_opt.state_dict(),
        "d_opt": state.d_opt.state_dict(),
        "w_avg": state.w_avg, "pl_mean": state.pl_mean, "ada_p": state.ada_p,
        "ada_rt": state.ada_rt,
    })


def save_gan_train_state(state, path: str, meta: dict | None = None,
                         async_save: bool = False) -> None:
    """Save a ``GANTrainState`` (snapshot to the host now) as
    ``train_state.pt`` + ``train_state_meta.json``, like
    :func:`save_train_state`."""
    snapshot = gan_train_state_dict(state)
    extra = {META_NAME: json.dumps(meta, indent=2)} if meta is not None else {}

    def write(tmp):
        torch.save(snapshot, os.path.join(tmp, STATE_NAME))
        _write_text(tmp, extra)

    _save(path, write, async_save)


@torch.no_grad()
def restore_gan_train_state(state, path: str, expect_meta: dict | None = None):
    """Restore into a freshly created GANTrainState of the same config (in
    place: the three modules, both optimizers, w_avg, pl_mean, the ADA
    state, step). ``expect_meta``: the current run's invariants; a mismatch
    raises, as does a module whose keys or shapes differ."""
    wait_for_saves()
    _check_meta(path, expect_meta)
    file = os.path.join(_resolve_existing(path), STATE_NAME)
    if not os.path.exists(file):
        raise ValueError(f"{path}: no {STATE_NAME}; the port resumes `train gan` from its own "
                         f"training state ({STATE_NAME} + {META_NAME}, written by "
                         "save_gan_train_state)")
    saved = torch.load(file, map_location="cpu", weights_only=True)
    for key in ("generator", "discriminator", "g_ema"):
        getattr(state, key).load_state_dict(saved[key])
    state.g_opt.load_state_dict(saved["g_opt"])
    state.d_opt.load_state_dict(saved["d_opt"])
    for key in ("w_avg", "pl_mean", "ada_rt"):
        setattr(state, key, saved[key].to(getattr(state, key).device))
    state.ada_p = saved["ada_p"].to(torch.float32)
    state.step = int(saved["step"])
    return state
