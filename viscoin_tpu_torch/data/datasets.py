"""Datasets: CUB-200-2011, FunnyBirds, folder-per-class images, and synthetic
images.

Counterpart of ``viscoin_tpu/data/datasets.py`` (the StyleGAN zip is
``data/stylegan_zip.py``). The dataset root
comes from an explicit argument, then ``$VISCOIN_DATA_DIR``, then
``~/.cache/viscoin/datasets``; nothing is downloaded. Decoded uint8 images
are cached, not transformed ones, so the training crop stays random across
epochs. ``__getitem__`` returns a fixed-size uint8 HWC image and its label;
the float conversion, flip and normalisation run on the device
(``data/transforms.py::device_preprocess``).

Augmentation randomness is a pure function of (seed, epoch, index), set by
the loader through :meth:`ImageDataset.set_epoch`: thread-safe under the
loader's pool, and replayed exactly by a resumed run.
"""

from __future__ import annotations

import os
from typing import Literal

import numpy as np

from viscoin_tpu_torch.data.transforms import (
    host_gan_transform,
    host_test_transform,
    host_train_transform,
)

Mode = Literal["train", "test"]
TransformMode = Literal["train", "test", "gan"]
IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def data_root() -> str:
    return os.environ.get("VISCOIN_DATA_DIR",
                          os.path.join(os.path.expanduser("~"), ".cache", "viscoin", "datasets"))


class ImageDataset:
    """Base class: decoded-uint8 cache + host geometric transform."""

    out_size: int = 256  # the model resolution the host transform targets

    def __init__(self, mode: Mode, transform: TransformMode | None = None, seed: int = 0,
                 cache_transformed: bool = False):
        self.mode: Mode = mode
        self.transform_mode: TransformMode = transform if transform is not None else mode
        self._cache: dict[int, np.ndarray] = {}
        self.seed = seed
        self._epoch = 0
        self.cache_transformed = cache_transformed

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _item_rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, self._epoch, index))

    def _load_raw(self, index: int) -> np.ndarray:  # uint8 HWC at its own size
        raise NotImplementedError

    def _label(self, index: int) -> int:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def raw_image(self, index: int) -> np.ndarray:
        if index in self._cache and not self.cache_transformed:
            return self._cache[index]
        img = self._load_raw(index)
        if not self.cache_transformed:
            self._cache[index] = img
        return img

    def __getitem__(self, index: int) -> tuple[np.ndarray, int]:
        if self.cache_transformed and index in self._cache:
            return self._cache[index], self._label(index)
        img = self.raw_image(index)
        if self.transform_mode == "train":
            out = host_train_transform(img, self._item_rng(index), size=self.out_size)
        elif self.transform_mode == "gan":
            out = host_gan_transform(img, size=self.out_size)
        else:
            out = host_test_transform(img, size=self.out_size,
                                      resize_to=int(self.out_size / 0.875))
        if self.cache_transformed:
            self._cache[index] = out
        return out, self._label(index)

    @property
    def labels_array(self) -> np.ndarray:
        return np.asarray([self._label(i) for i in range(len(self))], np.int64)


def _open_rgb(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), np.uint8)


class CUB_200_2011(ImageDataset):
    """CUB-200-2011 in its extracted layout under ``root``: images.txt,
    image_class_labels.txt, train_test_split.txt, bounding_boxes.txt, images/."""

    N_CLASSES = 200

    def __init__(self, mode: Mode = "train", bbox_only: bool = False,
                 transform: TransformMode | None = None, root: str | None = None, **kw):
        super().__init__(mode, transform, **kw)
        self.dataset_path = root or os.path.join(data_root(), "CUB_200_2011")
        if not os.path.isdir(self.dataset_path):
            raise FileNotFoundError(
                f"CUB_200_2011 not found at {self.dataset_path}; set VISCOIN_DATA_DIR or pass "
                "root= (layout: the extracted CUB_200_2011 directory).")
        self.bbox_only = bbox_only

        def table(name, dtype):
            return np.loadtxt(os.path.join(self.dataset_path, name), dtype=dtype, delimiter=" ")

        split = table("train_test_split.txt", int)
        self.train_indexes = split[split[:, 1] == 1][:, 0] - 1
        self.test_indexes = split[split[:, 1] == 0][:, 0] - 1
        self.labels = table("image_class_labels.txt", int)[:, 1] - 1  # the file is 1-based
        self.image_paths = table("images.txt", str)[:, 1]
        self.bboxes = table("bounding_boxes.txt", float).astype(int)[:, 1:]

    def _abs_index(self, index: int) -> int:
        return int(self.train_indexes[index] if self.mode == "train" else self.test_indexes[index])

    def __len__(self):
        return len(self.train_indexes) if self.mode == "train" else len(self.test_indexes)

    def _label(self, index: int) -> int:
        return int(self.labels[self._abs_index(index)])

    def _load_raw(self, index: int) -> np.ndarray:
        from PIL import Image

        ai = self._abs_index(index)
        with Image.open(os.path.join(self.dataset_path, "images", self.image_paths[ai])) as img:
            if img.mode != "RGB":
                img = img.convert("RGB")
            if self.bbox_only:
                x, y, w, h = self.bboxes[ai]
                img = img.crop((x, y, min(x + w, img.width), min(y + h, img.height)))
            return np.asarray(img, np.uint8)


class LabeledCUB(CUB_200_2011):
    """CUB with a caption per image: its class name and up to
    ``attributes_per_label`` of its present attributes, drawn at random.
    Needs ``classes.txt`` and ``attributes/attributes.txt`` and
    ``attributes/image_attribute_labels_clean.txt``."""

    def __init__(self, attributes_per_label: int = 3, **kw):
        super().__init__(**kw)
        self.attributes_per_label = attributes_per_label
        path = self.dataset_path

        def names(*parts) -> dict[int, str]:
            return {int(k): v for k, v in np.loadtxt(os.path.join(path, *parts), dtype=str,
                                                     delimiter=" ")}

        self.class_labels = {k: v.split(".")[1].replace("_", " ")
                             for k, v in names("classes.txt").items()}
        self.attributes_labels = names("attributes", "attributes.txt")
        raw = np.loadtxt(os.path.join(path, "attributes", "image_attribute_labels_clean.txt"),
                         dtype=float, delimiter=" ").astype(int)  # the last columns are floats
        # The present attributes grouped by image in one sorted pass.
        present = raw[raw[:, 2] == 1]
        order = np.argsort(present[:, 0], kind="stable")
        ids, attrs = present[order, 0], present[order, 1]
        starts = np.searchsorted(ids, np.arange(1, len(self.labels) + 2))
        self.attributes: list[np.ndarray] = [attrs[starts[i]:starts[i + 1]]
                                             for i in range(len(self.labels))]

    # Keeps the caption's draw apart from the crop's, both keyed by (seed, epoch, index).
    _CAPTION_TAG = 0xCA7

    def get_caption(self, index: int) -> str:
        """A function of (seed, epoch, index), as the crop is: the same in
        every thread of the loader and in a resumed run."""
        ai = self._abs_index(index)
        class_name = self.class_labels[int(self.labels[ai]) + 1]
        labels = [self.attributes_labels[int(a)].split("::") for a in self.attributes[ai]]
        n = min(self.attributes_per_label, len(labels))
        rng = np.random.default_rng((self.seed, self._epoch, index, self._CAPTION_TAG))
        chosen = rng.choice(len(labels), n, replace=False) if n else []
        parts = [f"with {labels[i][1].replace('_', ' ')}"
                 f"{labels[i][0].lstrip('has').replace('_', ' ')}" for i in chosen]
        return f"A picture of a {class_name} {', '.join(parts)}."

    def __getitem__(self, index: int):
        img, label = super().__getitem__(index)
        return img, label, self.get_caption(index)


class FunnyBirds(ImageDataset):
    """FunnyBirds: ``{root}/{train|test}/{class_id}/{image}.png``, 50
    classes; the label is the class folder's integer name."""

    N_CLASSES = 50

    def __init__(self, mode: Mode = "train", transform: TransformMode | None = None,
                 root: str | None = None, **kw):
        super().__init__(mode, transform, **kw)
        self.dataset_path = root or os.path.join(data_root(), "FunnyBirds")
        folder = os.path.join(self.dataset_path, mode)
        if not os.path.isdir(folder):
            raise FileNotFoundError(f"FunnyBirds not found at {folder}; set VISCOIN_DATA_DIR or "
                                    "pass root=.")
        self.image_paths: list[str] = []
        self.labels: list[int] = []
        for cls in sorted(os.listdir(folder)):
            sub = os.path.join(folder, cls)
            if not os.path.isdir(sub):
                continue
            for name in sorted(os.listdir(sub)):
                self.image_paths.append(os.path.join(cls, name))
                self.labels.append(int(cls))

    def __len__(self):
        return len(self.labels)

    def _label(self, index: int) -> int:
        return self.labels[index]

    def _load_raw(self, index: int) -> np.ndarray:
        return _open_rgb(os.path.join(self.dataset_path, self.mode, self.image_paths[index]))


class ImageFolderDataset(ImageDataset):
    """Folder-per-class images, ``{root}/{train|test}/{class}/{image}``.
    Labels index the sorted union of the class folders of both splits."""

    def __init__(self, mode: Mode = "train", transform: TransformMode | None = None,
                 root: str | None = None, out_size: int | None = None, **kw):
        super().__init__(mode, transform, **kw)
        if root is None:
            raise ValueError("ImageFolderDataset requires root= (the directory holding train/ "
                             "and test/ class folders)")
        self.dataset_path = root
        folder = os.path.join(root, mode)
        if not os.path.isdir(folder):
            raise FileNotFoundError(f"image-folder dataset: {folder} not found (expected layout "
                                    "{root}/{train|test}/{class}/{image})")
        names = set()
        for split in ("train", "test"):
            d = os.path.join(root, split)
            if os.path.isdir(d):
                names.update(c for c in os.listdir(d) if os.path.isdir(os.path.join(d, c)))
        self.class_names: list[str] = sorted(names)
        self.class_to_idx = {c: i for i, c in enumerate(self.class_names)}
        self.N_CLASSES = len(self.class_names)
        if out_size is None:
            out_size = int(os.environ.get("VISCOIN_IMAGEFOLDER_SIZE", 256))
        self.out_size = out_size
        self.image_paths: list[str] = []
        self.labels: list[int] = []
        for cls in self.class_names:
            sub = os.path.join(folder, cls)
            if not os.path.isdir(sub):
                continue
            for name in sorted(os.listdir(sub)):
                if name.lower().endswith(IMAGE_EXTS):
                    self.image_paths.append(os.path.join(cls, name))
                    self.labels.append(self.class_to_idx[cls])
        if not self.image_paths:
            raise FileNotFoundError(f"no images under {folder} (extensions: "
                                    f"{', '.join(IMAGE_EXTS)})")

    def __len__(self):
        return len(self.labels)

    def _label(self, index: int) -> int:
        return self.labels[index]

    def _load_raw(self, index: int) -> np.ndarray:
        return _open_rgb(os.path.join(self.dataset_path, self.mode, self.image_paths[index]))


class SyntheticDataset(ImageDataset):
    """Deterministic random images of slightly varying sizes, for tests and
    measurements where no dataset is on disk. ``VISCOIN_SYNTH_N`` and
    ``VISCOIN_SYNTH_SIZE`` set the defaults of ``n`` and ``image_size``."""

    def __init__(self, n: int | None = None, n_classes: int = 10, image_size: int | None = None,
                 mode: Mode = "train", transform: TransformMode | None = None, seed: int = 0):
        super().__init__(mode, transform, seed=seed)
        if n is None:
            n = int(os.environ.get("VISCOIN_SYNTH_N", 64))
        if image_size is None:
            image_size = int(os.environ.get("VISCOIN_SYNTH_SIZE", 256))
        self.n = n
        self.n_classes = self.N_CLASSES = n_classes
        self.image_size = self.out_size = image_size

    def __len__(self):
        return self.n

    def _label(self, index: int) -> int:
        return index % self.n_classes

    def _load_raw(self, index: int) -> np.ndarray:
        rng = np.random.default_rng(index + (0 if self.mode == "train" else 10_000))
        s = self.image_size
        return rng.integers(0, 256, (s + index % 7, s + index % 5, 3), dtype=np.uint8)
