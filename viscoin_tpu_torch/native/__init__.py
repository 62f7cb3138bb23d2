"""Native (C++) batch crop and resize for the host data path.

Counterpart of ``viscoin_tpu/native``: ``transform.cpp`` crops and resizes a
whole batch with a thread pool (PIL-equivalent antialiased bilinear); the
Python side computes the crop boxes (RandomResizedCrop, Resize+CenterCrop or
the GAN center crop) and hands pointers over through ctypes. This is host
code, not a CUDA kernel.

The library builds with ``g++`` at first use into the ignored
``viscoin_tpu_torch/csrc/build/``, never beside its source. Its name carries
a hash of the source, so an edited source is rebuilt; it is built under a
name private to the process and renamed into place, so processes building at
once do not clash. Without a toolchain :func:`available` is False and the
loader takes the PIL path of ``data/transforms.py``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from viscoin_tpu_torch.data.transforms import random_resized_crop_params

SOURCE = Path(__file__).resolve().parent / "transform.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "csrc" / "build"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failed = False


def _build_and_load() -> ctypes.CDLL | None:
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
        out = BUILD_DIR / f"libvctransform-{digest}.so"
        try:
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                # Builds of older sources go; never the current digest's file,
                # which another process may have just built and not loaded yet.
                for stale in glob.glob(str(BUILD_DIR / "libvctransform-*.so")):
                    if stale != str(out):
                        try:
                            os.remove(stale)
                        except OSError:
                            pass
                tmp = f"{out}.{os.getpid()}.tmp"
                subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
                                str(SOURCE), "-o", tmp], check=True, capture_output=True)
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.CalledProcessError):
            _failed = True
            return None
        ip = ctypes.POINTER(ctypes.c_int)
        lib.vct_transform_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),  # srcs
            ip, ip, ip, ip, ip, ip,  # hs, ws, tops, lefts, chs, cws
            ctypes.c_void_p,  # out
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n, size, threads
        ]
        lib.vct_transform_batch.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _build_and_load() is not None


def transform_batch(images: list[np.ndarray], boxes: np.ndarray, size: int,
                    n_threads: int = 8) -> np.ndarray:
    """Crop and resize a list of HWC uint8 images into one (N, size, size, 3)
    batch; ``boxes`` (N, 4) int32 holds (top, left, crop_h, crop_w) per image."""
    lib = _build_and_load()
    if lib is None:
        raise RuntimeError("the native transform library did not build (g++ missing?)")
    images = [np.ascontiguousarray(img, np.uint8) for img in images]
    for img in images:
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"expected (h, w, 3) uint8 images, got {img.shape}")
    n = len(images)
    boxes = np.ascontiguousarray(boxes, np.int32).reshape(n, 4)
    hs = np.asarray([img.shape[0] for img in images], np.int32)
    ws = np.asarray([img.shape[1] for img in images], np.int32)
    if (boxes[:, 0] < 0).any() or (boxes[:, 1] < 0).any() or (boxes[:, 2] < 1).any() \
            or (boxes[:, 3] < 1).any() or (boxes[:, 0] + boxes[:, 2] > hs).any() \
            or (boxes[:, 1] + boxes[:, 3] > ws).any():
        raise ValueError("crop boxes must lie inside their images")
    out = np.empty((n, size, size, 3), np.uint8)
    srcs = (ctypes.c_void_p * n)(*[img.ctypes.data for img in images])
    cols = [np.ascontiguousarray(boxes[:, j]) for j in range(4)]

    def iptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))

    lib.vct_transform_batch(srcs, iptr(hs), iptr(ws), *(iptr(c) for c in cols),
                            out.ctypes.data, n, size, n_threads)
    return out


def crop_boxes(shapes: list[tuple[int, int]], mode: str, size: int, rng) -> np.ndarray:
    """Crop boxes (N, 4) int32 for a batch of image shapes.

    train: RandomResizedCrop geometry; test: Resize(short = int(size / 0.875))
    + CenterCrop(size) as one crop, the center square of side
    short * size / int(size / 0.875); gan: the center square of the full
    short side. ``rng`` is one ``np.random.Generator`` for the batch or one
    per image (the loader keys each by (seed, epoch, index))."""
    rngs = rng if isinstance(rng, (list, tuple)) else [rng] * len(shapes)
    boxes = np.zeros((len(shapes), 4), np.int32)
    for i, (h, w) in enumerate(shapes):
        if mode == "train":
            boxes[i] = random_resized_crop_params(h, w, rngs[i])
        elif mode == "gan":
            side = min(h, w)
            boxes[i] = ((h - side) // 2, (w - side) // 2, side, side)
        else:
            side = int(round(min(h, w) * size / int(size / 0.875)))
            boxes[i] = ((h - side) // 2, (w - side) // 2, side, side)
    return boxes
