"""StyleGAN training zips: pack and read the stylegan2-ada archive layout.

Counterpart of ``viscoin_tpu/data/stylegan_zip.py``. An archive holds its
images as ``{idx//1000:05d}/img{idx:08d}.png`` (stored uncompressed: PNG is
compressed already) and a ``dataset.json`` with ``{"labels": [[arcname,
int], ...]}``, or ``{"labels": null}`` when the source has no classes.

* :func:`pack_stylegan_zip` packs an image tree (folder-per-class or flat),
  an existing training zip or a registry dataset into that layout.
* :class:`StyleGANZipDataset` reads such an archive (packed here, by the JAX
  package or by the upstream tool) for ``train gan`` and ``fid``.

``--transform center-crop`` is ``host_gan_transform``, the geometry of the
``gan`` transform, so packing at R and training on the zip feeds the
discriminator the pixels that training on the folder at ``out_size=R`` does.
"""

from __future__ import annotations

import io
import json
import os
import threading
import warnings
import zipfile
from typing import Iterator

import numpy as np

from viscoin_tpu_torch.data.datasets import IMAGE_EXTS, ImageDataset, Mode, TransformMode
from viscoin_tpu_torch.data.transforms import host_gan_transform


def _is_image(name: str) -> bool:
    return name.lower().endswith(IMAGE_EXTS)


def _iter_folder(source: str) -> Iterator[tuple[str, str]]:
    """(absolute path, relative path) of every image under ``source``, sorted
    by the relative path."""
    rels = []
    for dirpath, dirnames, filenames in os.walk(source):
        dirnames.sort()
        for name in sorted(filenames):
            if _is_image(name):
                full = os.path.join(dirpath, name)
                rels.append((full, os.path.relpath(full, source)))
    rels.sort(key=lambda t: t[1])
    yield from rels


def _folder_labels(rel_paths: list[str]) -> list[int] | None:
    """Labels from the top-level class folders, when every image sits in
    one; a flat or mixed tree is unlabeled."""
    norm = [os.path.normpath(r) for r in rel_paths]
    if any(os.sep not in r for r in norm):
        return None
    tops = [r.split(os.sep)[0] for r in norm]
    idx = {c: i for i, c in enumerate(sorted(set(tops)))}
    return [idx[t] for t in tops]


def _decode(data: bytes) -> np.ndarray:
    from PIL import Image

    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"), np.uint8)


def _encode_png(img: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img, "RGB").save(buf, format="PNG")
    return buf.getvalue()


def _arcname(idx: int) -> str:
    return f"{idx // 1000:05d}/img{idx:08d}.png"


def _read_zip_labels(zf: zipfile.ZipFile) -> dict[str, int] | None:
    """dataset.json -> {arcname: label}, or None when absent or unlabeled."""
    try:
        raw = json.loads(zf.read("dataset.json"))
    except KeyError:
        return None
    recs = raw.get("labels")
    if not recs:
        return None
    return {name: int(label) for name, label in recs}


def pack_stylegan_zip(source: str, dest: str, resolution: int | None = None,
                      transform: str = "center-crop",
                      max_images: int | None = None) -> tuple[int, int]:
    """Pack ``source`` (an image directory, a training zip, or a registry
    dataset name) into a training zip at ``dest``; returns (images,
    resolution).

    Without ``resolution`` the images are stored as they are and must be
    square and of one size. With it, ``transform="center-crop"`` applies
    ``host_gan_transform`` and ``"none"`` refuses an image that is not
    ``resolution``² already."""
    if transform not in ("center-crop", "none"):
        raise ValueError(f"unknown transform {transform!r}: expected 'center-crop' or 'none'")
    if resolution is not None and resolution < 4:
        raise ValueError(f"--resolution {resolution}: must be >= 4")
    from viscoin_tpu_torch.data.utils import DATASET_NAMES, get_datasets

    src_zip: zipfile.ZipFile | None = None
    labels: list[int] | None
    if source in DATASET_NAMES:
        # The raw train images (_load_raw: one streaming pass, no decode cache)
        # with the dataset's own labels.
        ds, _ = get_datasets(source, "gan", train_only=True)
        loaders = [(lambda i=i: ds._load_raw(i)) for i in range(len(ds))]
        labels = [int(ds._label(i)) for i in range(len(ds))]
    elif os.path.isdir(source):
        entries = list(_iter_folder(source))
        if not entries:
            raise ValueError(f"no images found under {source}")

        def read(path):
            with open(path, "rb") as fh:
                return _decode(fh.read())

        loaders = [(lambda p=p: read(p)) for p, _ in entries]
        labels = _folder_labels([r for _, r in entries])
    elif os.path.isfile(source) and zipfile.is_zipfile(source):
        src_zip = zipfile.ZipFile(source)  # closed in the finally below
        names = sorted(n for n in src_zip.namelist() if _is_image(n))
        if not names:
            src_zip.close()
            raise ValueError(f"no images found inside {source}")
        loaders = [(lambda n=n: _decode(src_zip.read(n))) for n in names]
        label_map = _read_zip_labels(src_zip)
        if label_map is not None and not all(n in label_map for n in names):
            warnings.warn(f"{source}: dataset.json covers only part of the archive — dropping "
                          "labels (the re-packed zip will be unlabeled)", stacklevel=2)
            label_map = None
        labels = [label_map[n] for n in names] if label_map is not None else None
    else:
        raise ValueError(f"unknown source {source!r}: expected an image directory, a training "
                         f"zip, or one of {sorted(DATASET_NAMES)}")

    if max_images is not None:
        loaders = loaders[:max_images]
        labels = labels[:max_images] if labels is not None else None
    if not loaders:
        if src_zip is not None:
            src_zip.close()
        raise ValueError("no images selected (is --max-images 0?)")

    out_res = resolution
    records: list[list] | None = [] if labels is not None else None
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    try:
        with zipfile.ZipFile(dest, "w", zipfile.ZIP_STORED) as zf:
            for idx, load in enumerate(loaders):
                img = load()
                h, w = img.shape[:2]
                if resolution is not None:
                    if transform == "center-crop":
                        img = host_gan_transform(img, size=resolution)
                    elif (h, w) != (resolution, resolution):
                        raise ValueError(f"image {idx} is {w}x{h}, not {resolution}² — use "
                                         "--transform center-crop or fix --resolution")
                elif h != w:
                    raise ValueError(f"image {idx} is {w}x{h} (non-square); pass --resolution "
                                     "to crop/resize")
                elif out_res is None:
                    out_res = h
                elif h != out_res:
                    raise ValueError(f"image {idx} is {h}², others are {out_res}²; pass "
                                     "--resolution for a uniform archive")
                name = _arcname(idx)
                zf.writestr(name, _encode_png(img))
                if records is not None:
                    records.append([name, int(labels[idx])])
            zf.writestr("dataset.json", json.dumps({"labels": records}, indent=2))
    finally:
        if src_zip is not None:
            src_zip.close()
    return len(loaders), int(out_res)


class StyleGANZipDataset(ImageDataset):
    """A training zip as a train-only dataset (there is no test split, as in
    the upstream trainer). Labels come from ``dataset.json``; an unlabeled
    archive reads as class 0. A ``dataset.json`` that labels only part of
    the images is a corrupted archive and is refused.

    Each thread reads through its own ``ZipFile`` (reads on one shared
    handle interleave their seeks): the loader's pool and the prefetcher
    read from worker threads."""

    def __init__(self, path: str, mode: Mode = "train", transform: TransformMode | None = None,
                 out_size: int | None = None, **kw):
        super().__init__(mode, transform, **kw)
        if not zipfile.is_zipfile(path):
            raise FileNotFoundError(f"not a zip archive: {path}")
        self.dataset_path = path
        self._local = threading.local()
        zf = self._zip()
        self.names = sorted(n for n in zf.namelist() if _is_image(n))
        if not self.names:
            raise ValueError(f"no images inside {path}")
        label_map = _read_zip_labels(zf)
        if label_map is None:
            self.labels = [0] * len(self.names)
        else:
            missing = [n for n in self.names if n not in label_map]
            if missing:
                raise ValueError(
                    f"{path}: dataset.json labels {len(self.names) - len(missing)}"
                    f"/{len(self.names)} image members (first missing: {missing[0]!r}) — "
                    "corrupted labeled archive")
            self.labels = [label_map[n] for n in self.names]
        self.N_CLASSES = max(self.labels) + 1
        native = _decode(zf.read(self.names[0])).shape[0]
        self.out_size = int(out_size) if out_size is not None else int(native)

    def _zip(self) -> zipfile.ZipFile:
        zf = getattr(self._local, "zf", None)
        if zf is None:
            zf = self._local.zf = zipfile.ZipFile(self.dataset_path)
        return zf

    def __len__(self) -> int:
        return len(self.names)

    def _label(self, index: int) -> int:
        return self.labels[index]

    def _load_raw(self, index: int) -> np.ndarray:
        return _decode(self._zip().read(self.names[index]))
