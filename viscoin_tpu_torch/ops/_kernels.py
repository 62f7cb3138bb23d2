"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` into its own
shared library with a plain C interface (``-gencode arch=compute_90a,
code=sm_90a``, Hopper) and loaded with :mod:`ctypes`. The libraries land in
``viscoin_tpu_torch/csrc/build/`` (listed in ``.gitignore``) under a name
that carries a hash of the source and flags, so an edited source is rebuilt
and a stale library is never loaded. All sources build in parallel, one
``nvcc`` process each. A failed build raises; nothing falls back.

A source may hold several kernels, each with its own C entry point and its
own launch count (``bias_act.cu`` holds ``bias_act`` and its backward,
``bias_act_grad``). Every wrapper calls :func:`count_launch` right after its
kernel launched successfully, and nowhere else, so a run can show that the
main path went through the kernels (:func:`launch_counts`,
:func:`reset_launch_counts`).

Nothing here runs at import: this module imports on machines without
``nvcc`` or a card, where only the plain versions of the ops run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("bias_act", "upfirdn2d")  # csrc/<source>.cu, one library each
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel -> (source, C entry point, argument count). Every argument is a
# pointer (see the .cu sources): tensors, then the plan (a ctypes structure
# built once per shape by the op's wrapper), then the stream.
_SIGNATURES = {
    "bias_act": ("bias_act", "viscoin_bias_act", 5),            # x, b, y, plan, stream
    "bias_act_grad": ("bias_act", "viscoin_bias_act_grad", 7),  # x, b, dy, dx, db, plan, stream
    "upfirdn2d": ("upfirdn2d", "viscoin_upfirdn2d", 4),         # x, y, plan, stream
}
KERNELS = tuple(_SIGNATURES)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, ctypes._CFuncPtr] = {}
_launches = {name: 0 for name in KERNELS}
build_log: dict[str, str] = {}


def count_launch(name: str) -> None:
    with _lock:
        _launches[name] += 1


def launch_counts() -> dict[str, int]:
    with _lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _lock:
        for name in _launches:
            _launches[name] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME, /usr/local/cuda and PATH); "
                           "the CUDA kernels of viscoin_tpu_torch cannot be built")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str) -> tuple[Path, Path, subprocess.Popen | None]:
    out = _lib_path(name)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    if out.exists():
        return out, tmp, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)


def build_all() -> float:
    """Build (in parallel) and load every source not loaded yet; returns
    the wall seconds it took. Raises if any build or load fails."""
    t0 = time.perf_counter()
    with _lock:
        todo = [n for n in SOURCES if n not in _libs]
        started = {}
        try:
            for name in todo:
                started[name] = _start_build(name)
        finally:
            errors = []
            for name, (out, tmp, proc) in started.items():
                if proc is None:
                    continue
                log, _ = proc.communicate()
                build_log[name] = log
                if proc.returncode != 0:
                    errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
                    tmp.unlink(missing_ok=True)
                else:
                    os.replace(tmp, out)
            if errors:
                raise RuntimeError("\n".join(errors))
        for source, (out, _, _) in started.items():
            _libs[source] = ctypes.CDLL(str(out))
        for name, (source, fn_name, nargs) in _SIGNATURES.items():
            if name not in _fns and source in _libs:
                fn = getattr(_libs[source], fn_name)
                fn.argtypes = [ctypes.c_void_p] * nargs
                fn.restype = ctypes.c_int
                _fns[name] = fn
    return time.perf_counter() - t0


def entry(name: str):
    """The C entry point of kernel ``name``, bound once; builds everything on
    first use."""
    fn = _fns.get(name)
    if fn is None:
        build_all()
        fn = _fns[name]
    return fn


def current_stream(x) -> int:
    """The raw handle of the current CUDA stream on ``x``'s device (what
    ``torch.cuda.current_stream(x.device).cuda_stream`` gives, without building
    a Stream object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def check(name: str, rc: int) -> None:
    """Raise if a C entry point reported a CUDA error; count the launch otherwise."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    count_launch(name)
