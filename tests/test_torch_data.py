"""The port's host data path against the JAX package's, on the CPU: host
transforms and crop boxes, the native crop + resize library, the datasets,
the DataLoader's batch streams (3 epochs, skip_batches, pad_final, shard,
native and PIL paths), pad_batch and the dataset registry; all bit-equal.
And the DevicePrefetcher, whose close() joins its thread and whose next()
raises once it is closed or its producer failed."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from viscoin_tpu import native as jax_native
from viscoin_tpu.data import datasets as JD
from viscoin_tpu.data import loader as JL
from viscoin_tpu.data import transforms as JT
from viscoin_tpu.data import utils as JU
from viscoin_tpu_torch import native
from viscoin_tpu_torch.data import datasets as TD
from viscoin_tpu_torch.data import loader as TL
from viscoin_tpu_torch.data import transforms as TT
from viscoin_tpu_torch.data import utils as TU

SHAPES = [(37, 53), (64, 48), (300, 200), (31, 31), (9, 120)]


def _image(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_host_transforms_bit_equal(shape):
    """RandomResizedCrop parameters (including the fallback), the train,
    gan and test transforms: identical bytes for the same image and rng."""
    img = _image(*shape)
    for seed in range(5):
        want = JT.random_resized_crop_params(*shape, np.random.default_rng(seed))
        got = TT.random_resized_crop_params(*shape, np.random.default_rng(seed))
        assert got == want
    for size in (16, 32):
        np.testing.assert_array_equal(
            TT.host_train_transform(img, np.random.default_rng(1), size=size),
            JT.host_train_transform(img, np.random.default_rng(1), size=size))
        np.testing.assert_array_equal(TT.host_gan_transform(img, size=size),
                                      JT.host_gan_transform(img, size=size))
        np.testing.assert_array_equal(
            TT.host_test_transform(img, size=size, resize_to=int(size / 0.875)),
            JT.host_test_transform(img, size=size, resize_to=int(size / 0.875)))


def test_crop_params_fallback_bit_equal():
    """An extreme aspect ratio exhausts the 10 draws: the clamped center crop."""
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    assert TT.random_resized_crop_params(4, 400, rng_a, scale=(0.99, 1.0)) == \
        JT.random_resized_crop_params(4, 400, rng_b, scale=(0.99, 1.0))


@pytest.mark.parametrize("mode", ["train", "test", "gan"])
def test_crop_boxes_and_native_library_bit_equal(mode):
    """The port's own build of transform.cpp against the JAX package's: the
    same boxes and the same bytes, on one rng and on per-image rngs."""
    assert native.available() and jax_native.available()
    assert str(native.BUILD_DIR) in str(native._lib._name)
    imgs = [_image(h, w, i) for i, (h, w) in enumerate(SHAPES)]
    shapes = [im.shape[:2] for im in imgs]
    for rng in (lambda: np.random.default_rng(7),
                lambda: [np.random.default_rng((7, 1, i)) for i in range(len(imgs))]):
        boxes = native.crop_boxes(shapes, mode, 24, rng())
        np.testing.assert_array_equal(boxes, jax_native.crop_boxes(shapes, mode, 24, rng()))
        got = native.transform_batch(imgs, boxes, 24, n_threads=3)
        np.testing.assert_array_equal(got, jax_native.transform_batch(imgs, boxes, 24,
                                                                      n_threads=3))
    with pytest.raises(ValueError, match="inside"):
        native.transform_batch(imgs[:1], np.array([[0, 0, 99, 99]]), 8)


def test_native_build_lands_in_the_build_dir():
    """The library is built under csrc/build/ (ignored), never beside its source."""
    assert native.available()
    assert not [f for f in os.listdir(os.path.dirname(native.__file__)) if f.endswith(".so")]
    built = [f for f in os.listdir(native.BUILD_DIR) if f.startswith("libvctransform-")]
    assert len([f for f in built if f.endswith(".so")]) == 1


def _folder_dataset(root, n_per_class=(3, 2), sizes=((20, 30), (17, 17))):
    from PIL import Image

    for split in ("train", "test"):
        for c, n in enumerate(n_per_class):
            d = os.path.join(root, split, f"class{c}")
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                h, w = sizes[(i + c) % len(sizes)]
                Image.fromarray(_image(h, w, 10 * c + i)).save(os.path.join(d, f"{i}.png"))


def _cub_layout(root, n=6):
    from PIL import Image

    os.makedirs(os.path.join(root, "images", "001.a"), exist_ok=True)
    lines = {"images.txt": [], "image_class_labels.txt": [], "train_test_split.txt": [],
             "bounding_boxes.txt": []}
    for i in range(1, n + 1):
        Image.fromarray(_image(20 + i, 25, i)).save(os.path.join(root, "images", "001.a",
                                                                 f"{i}.jpg"))
        lines["images.txt"].append(f"{i} 001.a/{i}.jpg")
        lines["image_class_labels.txt"].append(f"{i} {1 + i % 3}")
        lines["train_test_split.txt"].append(f"{i} {i % 2}")
        lines["bounding_boxes.txt"].append(f"{i} 2.0 3.0 10.0 12.0")
    for name, rows in lines.items():
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(rows) + "\n")


def _same_items(tds, jds, seeds=(1, 2)):
    assert len(tds) == len(jds)
    np.testing.assert_array_equal(tds.labels_array, jds.labels_array)
    for epoch in seeds:
        tds.set_epoch(epoch)
        jds.set_epoch(epoch)
        for i in range(len(tds)):
            (ti, tl), (ji, jl) = tds[i], jds[i]
            np.testing.assert_array_equal(ti, ji)
            assert tl == jl


def test_datasets_bit_equal(tmp_path):
    """Synthetic, image-folder and CUB (tiny layouts written here), in every
    transform mode, item by item, over two epochs of crops."""
    for mode in ("train", "test"):
        for tf in (None, "gan"):
            _same_items(TD.SyntheticDataset(n=5, n_classes=3, image_size=16, mode=mode,
                                            transform=tf, seed=4),
                        JD.SyntheticDataset(n=5, n_classes=3, image_size=16, mode=mode,
                                            transform=tf, seed=4))
    _folder_dataset(str(tmp_path / "folder"))
    for mode in ("train", "test"):
        t = TD.ImageFolderDataset(mode=mode, root=str(tmp_path / "folder"), out_size=16)
        j = JD.ImageFolderDataset(mode=mode, root=str(tmp_path / "folder"), out_size=16)
        assert t.class_names == j.class_names and t.N_CLASSES == j.N_CLASSES
        _same_items(t, j)
    _cub_layout(str(tmp_path / "cub"))
    for mode in ("train", "test"):
        for bbox in (False, True):
            _same_items(TD.CUB_200_2011(mode=mode, bbox_only=bbox, root=str(tmp_path / "cub")),
                        JD.CUB_200_2011(mode=mode, bbox_only=bbox, root=str(tmp_path / "cub")))
    with pytest.raises(FileNotFoundError):
        TD.CUB_200_2011(root=str(tmp_path / "missing"))


LOADERS = [
    dict(batch_size=3),
    dict(batch_size=3, shuffle=False),
    dict(batch_size=3, drop_last=True),
    dict(batch_size=4, pad_final=True),
    dict(batch_size=4, shard=(1, 2)),
    dict(batch_size=4, shard=(0, 2), pad_final=True),
]


@pytest.mark.parametrize("native_path", [True, False], ids=["native", "pil"])
@pytest.mark.parametrize("kw", LOADERS, ids=lambda kw: ",".join(f"{k}={v}" for k, v in
                                                                  kw.items()))
def test_loader_streams_bit_equal(kw, native_path):
    """3 epochs of batches, then a loader fast-forwarded by skip_batches to
    the middle of epoch 2 and another to the start of epoch 3: identical
    images and labels batch for batch; threads do not change the stream."""
    def make(mod, ds_mod, threads):
        ds = ds_mod.SyntheticDataset(n=10, n_classes=3, image_size=12, seed=5)
        return mod.DataLoader(ds, seed=9, num_threads=threads, use_native=native_path, **kw)

    def stream(loader, epochs):
        return [b for _ in range(epochs) for b in loader]

    want = stream(make(JL, JD, 0), 3)
    for threads in (0, 2):
        got = stream(make(TL, TD, threads), 3)
        assert len(got) == len(want) == 3 * len(make(TL, TD, 0))
        for (gi, gl), (wi, wl) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
    per_epoch = len(make(TL, TD, 0))
    for skip in (per_epoch + 1, 2 * per_epoch):
        t, j = make(TL, TD, 2), make(JL, JD, 0)
        t.skip_batches(skip)
        j.skip_batches(skip)
        for (gi, gl), (wi, wl) in zip(stream(t, 1), stream(j, 1)):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)


def test_loader_producer_error_reaches_the_consumer_and_stops():
    class Broken(TD.SyntheticDataset):
        def __getitem__(self, i):
            if i == 3:
                raise OSError("corrupt image")
            return super().__getitem__(i)

    loader = TL.DataLoader(Broken(n=8, image_size=8), batch_size=2, shuffle=False,
                           num_threads=2, use_native=False)
    before = threading.active_count()
    with pytest.raises(OSError, match="corrupt"):
        list(loader)
    time.sleep(0.2)
    assert threading.active_count() <= before


def test_pad_batch_matches_jax():
    imgs = np.arange(3 * 2 * 2 * 3, dtype=np.uint8).reshape(3, 2, 2, 3)
    for labels in (None, np.array([2, -1, 1])):
        got, want = TL.pad_batch(5, imgs, labels), JL.pad_batch(5, imgs, labels)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_registry_matches_jax(tmp_path, monkeypatch):
    for name in ("cub", "synthetic", str(tmp_path / "my_folder"), "x/celeba.zip"):
        assert TU.dataset_key(name) == JU.dataset_key(name)
        assert TU.default_checkpoints(name) == JU.default_checkpoints(name)
    zip_path = tmp_path / "data.zip"
    zip_path.write_bytes(b"")
    for get_datasets in (TU.get_datasets, JU.get_datasets):  # a zip is train-only in both
        with pytest.raises(ValueError, match="no test split"):
            get_datasets(str(zip_path))
    # FunnyBirds is registered (tests/test_torch_analysis.py holds it to JAX's
    # class): without its files, both packages name where they looked.
    monkeypatch.setenv("VISCOIN_DATA_DIR", str(tmp_path))
    for get_datasets in (TU.get_datasets, JU.get_datasets):
        with pytest.raises(FileNotFoundError, match="FunnyBirds not found"):
            get_datasets("funnybirds")
    with pytest.raises(ValueError, match="unknown dataset"):
        TU.get_datasets("imagenet")
    train, test = TU.get_dataloaders("synthetic", 4, n=6, image_size=8)
    assert len(train.dataset) == len(test.dataset) == 6 and train.batch_size == 4


# ------------------------------ DevicePrefetcher ----------------------------- #


def test_prefetcher_keeps_order_and_close_joins_the_thread():
    counter = iter(range(10**6))
    pf = TL.DevicePrefetcher(lambda: next(counter), depth=3)
    assert [pf.next() for _ in range(20)] == list(range(20))
    time.sleep(0.05)  # the producer is blocked on a full queue
    pf.close()
    assert not pf._thread.is_alive()
    pf.close()  # idempotent
    with pytest.raises(TL.PrefetcherClosed):
        pf.next()


def test_prefetcher_forwards_the_error_once_then_raises():
    state = {"n": 0}

    def produce():
        state["n"] += 1
        if state["n"] == 3:
            raise KeyError("boom")
        return state["n"]

    pf = TL.DevicePrefetcher(produce, depth=1)
    assert pf.next() == 1 and pf.next() == 2
    with pytest.raises(KeyError, match="boom"):
        pf.next()
    t0 = time.perf_counter()
    with pytest.raises(TL.PrefetcherClosed):
        pf.next()  # the JAX package's blocks here forever
    assert time.perf_counter() - t0 < 5
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_close_while_the_producer_is_busy():
    """close() waits for the running produce_fn, drops its result and joins."""
    started = threading.Event()

    def produce():
        started.set()
        time.sleep(0.3)
        return 1

    pf = TL.DevicePrefetcher(produce, depth=1)
    started.wait(5)
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(TL.PrefetcherClosed):
        pf.next()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_channel_constants_equal_the_per_call_values_and_are_made_once(dtype, monkeypatch):
    """The ImageNet mean and std (``_stats``) and LPIPS's shift and scale are
    the values the per-call ``torch.tensor(values, dtype=)`` made, in fp32
    and bf16, made once per (values, device, dtype); one first made in
    inference mode can enter autograd; while exporting each is made afresh."""
    from viscoin_tpu_torch.data import transforms as tr
    from viscoin_tpu_torch.models import lpips as lp

    x = torch.zeros(2, 3, 4, 4, dtype=dtype)
    mean, std = tr._stats(x)
    assert torch.equal(mean, torch.tensor(tr.IMAGENET_MEAN, dtype=dtype)[:, None, None])
    assert torch.equal(std, torch.tensor(tr.IMAGENET_STD, dtype=dtype)[:, None, None])
    for values in (tr.IMAGENET_MEAN, tr.IMAGENET_STD, lp.SHIFT, lp.SCALE):
        c = tr.channel_constant(values, x)
        assert c.dtype == dtype and c.shape == (3, 1, 1)
        assert torch.equal(c, torch.tensor(values, dtype=dtype)[:, None, None])
        assert tr.channel_constant(values, x) is c
    assert tr._stats(x)[0] is mean
    with torch.inference_mode():
        fresh = tr.channel_constant((0.25, 0.5, 0.125), x)
    assert not fresh.is_inference()
    y = torch.ones(1, 3, 1, 1, dtype=dtype, requires_grad=True)
    (y * fresh).sum().backward()
    assert torch.equal(y.grad, fresh.expand(3, 1, 1)[None])
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    assert tr.channel_constant(lp.SHIFT, x) is not tr.channel_constant(lp.SHIFT, x)
