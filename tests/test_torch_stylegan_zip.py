"""StyleGAN training zips in the port (``viscoin_tpu_torch/data/stylegan_zip.py``
and ``python -m viscoin_tpu_torch dataset-tool``) against the JAX package's
``viscoin_tpu/data/stylegan_zip.py``: the same archive from the same source
(member names, ``dataset.json``, uint8 pixels equal), each side reading the
other's archive, the ``get_datasets`` dispatch, the refusals, the command,
and ``train gan`` on a packed archive. No JAX computation: numpy and PIL
only."""

import json
import os
import threading
import zipfile

import numpy as np
import pytest
from PIL import Image

from test_dataset_tool import _write_img, class_tree  # noqa: F401 - a fixture
from test_torch_gan_cli import BASE, toy_cli  # noqa: F401 - a fixture
from torch_port_helpers import one_torch_thread  # noqa: F401 - an autouse fixture
from viscoin_tpu.data import stylegan_zip as JZ
from viscoin_tpu.data.utils import get_datasets as jax_get_datasets
from viscoin_tpu_torch.__main__ import main
from viscoin_tpu_torch.data import stylegan_zip as TZ
from viscoin_tpu_torch.data.loader import DataLoader
from viscoin_tpu_torch.data.transforms import host_gan_transform
from viscoin_tpu_torch.data.utils import get_datasets


def _members(path) -> tuple[list[str], dict, dict[str, np.ndarray]]:
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        meta = json.loads(zf.read("dataset.json"))
        pixels = {n: np.asarray(Image.open(zf.open(n)).convert("RGB")) for n in names
                  if n.endswith(".png")}
    return names, meta, pixels


@pytest.mark.parametrize("source", ["class_tree", "flat", "zip", "synthetic"])
def test_pack_matches_jax(source, class_tree, tmp_path, monkeypatch):
    """The port and JAX pack the same source into the same archive: member
    names in order, dataset.json (labels or null), uint8 pixels equal; the
    returned (count, resolution) agree."""
    root, _ = class_tree
    kw = dict(resolution=32)
    if source == "flat":
        root = str(tmp_path / "flat")
        for i in range(3):
            _write_img(os.path.join(root, f"{i}.png"), 20 + i, 30, 10 + i)
        kw = dict(resolution=16, max_images=2)
    elif source == "zip":
        src = str(tmp_path / "src.zip")
        JZ.pack_stylegan_zip(root, src, resolution=32)
        root, kw = src, dict(resolution=24)  # a re-pack to another resolution
    elif source == "synthetic":
        monkeypatch.setenv("VISCOIN_SYNTH_N", "5")
        monkeypatch.setenv("VISCOIN_SYNTH_SIZE", "16")
        root, kw = "synthetic", {}  # stored sizes vary: refused without --resolution
        for pack in (TZ.pack_stylegan_zip, JZ.pack_stylegan_zip):
            with pytest.raises(ValueError, match="non-square|--resolution"):
                pack(root, str(tmp_path / "x.zip"))
        kw = dict(resolution=16)
    got = TZ.pack_stylegan_zip(root, str(tmp_path / "port.zip"), **kw)
    want = JZ.pack_stylegan_zip(root, str(tmp_path / "jax.zip"), **kw)
    assert got == want
    names, meta, pixels = _members(tmp_path / "port.zip")
    jnames, jmeta, jpixels = _members(tmp_path / "jax.zip")
    assert names == jnames and meta == jmeta
    assert (meta["labels"] is None) == (source == "flat")
    for n in names[:-1]:
        np.testing.assert_array_equal(pixels[n], jpixels[n])


def test_pixels_are_the_gan_transform(class_tree, tmp_path):
    root, imgs = class_tree
    TZ.pack_stylegan_zip(root, str(tmp_path / "a.zip"), resolution=32)
    _, meta, pixels = _members(tmp_path / "a.zip")
    assert meta["labels"] == [[f"00000/img0000000{i}.png", c] for i, c in enumerate((0, 0, 1))]
    for i, key in enumerate(sorted(imgs)):
        np.testing.assert_array_equal(pixels[f"00000/img0000000{i}.png"],
                                      host_gan_transform(imgs[key], size=32))


def test_each_side_reads_the_others_archive(class_tree, tmp_path):
    """The port's dataset on a JAX-packed archive and JAX's on a port-packed
    one: the same labels, sizes and items (at the stored size and
    re-decoded at 16)."""
    root, _ = class_tree
    TZ.pack_stylegan_zip(root, str(tmp_path / "port.zip"), resolution=32)
    JZ.pack_stylegan_zip(root, str(tmp_path / "jax.zip"), resolution=32)
    for path in ("port.zip", "jax.zip"):
        path = str(tmp_path / path)
        for kw in ({}, {"out_size": 16}):
            t = TZ.StyleGANZipDataset(path, transform="gan", **kw)
            j = JZ.StyleGANZipDataset(path, transform="gan", **kw)
            assert (len(t), t.out_size, t.N_CLASSES, t.labels) == (
                len(j), j.out_size, j.N_CLASSES, j.labels)
            for i in range(len(t)):
                np.testing.assert_array_equal(t[i][0], j[i][0])
                assert t[i][1] == j[i][1]


def test_get_datasets_dispatches_a_zip(class_tree, tmp_path):
    root, _ = class_tree
    dest = str(tmp_path / "ds.zip")
    TZ.pack_stylegan_zip(root, dest, resolution=32)
    train, test = get_datasets(dest, "gan", train_only=True)
    assert isinstance(train, TZ.StyleGANZipDataset) and test is None
    assert train.out_size == 32 and train.transform_mode == "gan"
    train16, _ = get_datasets(dest, "gan", train_only=True, out_size=16)
    assert train16[0][0].shape == (16, 16, 3)
    for dispatch in (get_datasets, jax_get_datasets):
        with pytest.raises(ValueError, match="train-only"):
            dispatch(dest)


def test_partial_labels_are_refused(class_tree, tmp_path):
    """A dataset.json labelling part of the images: both readers refuse it
    (a corrupted archive); a re-pack warns and drops the labels in both."""
    root, _ = class_tree
    dest = str(tmp_path / "part.zip")
    TZ.pack_stylegan_zip(root, dest, resolution=32)
    with zipfile.ZipFile(dest) as zf:
        recs = json.loads(zf.read("dataset.json"))["labels"]
        members = {n: zf.read(n) for n in zf.namelist() if n != "dataset.json"}
    with zipfile.ZipFile(dest, "w") as zf:
        for n, data in members.items():
            zf.writestr(n, data)
        zf.writestr("dataset.json", json.dumps({"labels": recs[:-1]}))
    for reader in (TZ.StyleGANZipDataset, JZ.StyleGANZipDataset):
        with pytest.raises(ValueError, match="corrupted labeled archive"):
            reader(dest)
    for pack, out in ((TZ.pack_stylegan_zip, "t.zip"), (JZ.pack_stylegan_zip, "j.zip")):
        with pytest.warns(UserWarning, match="only part"):
            pack(dest, str(tmp_path / out), resolution=32)
    assert _members(tmp_path / "t.zip")[1] == _members(tmp_path / "j.zip")[1] == {"labels": None}


def test_pack_refusals(class_tree, tmp_path):
    root, _ = class_tree
    cases = (({}, "resolution"), (dict(resolution=32, transform="none"), "center-crop"),
             (dict(resolution=32, max_images=0), "no images"), (dict(resolution=2), ">= 4"),
             (dict(transform="flip"), "unknown transform"))
    for kw, match in cases:
        for pack in (TZ.pack_stylegan_zip, JZ.pack_stylegan_zip):
            with pytest.raises(ValueError, match=match):
                pack(root, str(tmp_path / "x.zip"), **kw)
    with pytest.raises(ValueError, match="unknown source"):
        TZ.pack_stylegan_zip(str(tmp_path / "missing"), str(tmp_path / "z.zip"))


def test_a_zip_handle_per_thread(class_tree, tmp_path):
    """Each reading thread opens its own ZipFile; the loader's pool reads
    the archive's items as the dataset does on one thread."""
    root, _ = class_tree
    dest = str(tmp_path / "t.zip")
    TZ.pack_stylegan_zip(root, dest, resolution=32)
    ds = TZ.StyleGANZipDataset(dest, transform="gan")
    handles = []
    t = threading.Thread(target=lambda: handles.append(ds._zip()))
    t.start()
    t.join()
    assert handles[0] is not ds._zip()
    images, labels = next(iter(DataLoader(ds, 3, shuffle=False)))
    for i in range(3):
        np.testing.assert_array_equal(images[i], ds[i][0])
    assert list(labels) == [0, 0, 1]


def test_dataset_tool_command(class_tree, tmp_path, capsys):
    """In-process: the JAX command's options, its refusals as usage errors
    (exit 2), and its non-power-of-two warning."""
    root, _ = class_tree
    dest = str(tmp_path / "cli.zip")
    assert main(["dataset-tool", "--source", root, "--dest", dest, "--resolution", "32"]) == 0
    assert "packed 3 images at 32x32" in capsys.readouterr().out
    assert _members(dest)[0] == [f"00000/img0000000{i}.png" for i in range(3)] + ["dataset.json"]
    assert main(["dataset-tool", "--source", root, "--dest", str(tmp_path / "odd.zip"),
                 "--resolution", "24", "--max-images", "2"]) == 0
    out = capsys.readouterr().out
    assert "power of two" in out and "packed 2 images at 24x24" in out
    with pytest.raises(SystemExit) as done:
        main(["dataset-tool", "--source", root, "--dest", str(tmp_path / "bad.zip")])
    assert done.value.code == 2 and "resolution" in capsys.readouterr().err


def test_train_gan_on_a_packed_zip(toy_cli, monkeypatch):  # noqa: F811
    """`train gan --dataset x.zip` (toy widths): packed by dataset-tool from
    a folder at 16², trained on for 2 iterations, the export written."""
    monkeypatch.chdir(toy_cli)
    for i in range(8):
        _write_img(str(toy_cli / f"imgs/cls/{i}.png"), 20, 24, i)
    assert main(["dataset-tool", "--source", "imgs", "--dest", "train.zip",
                 "--resolution", "16"]) == 0
    args = [a if a != "synthetic" else "train.zip" for a in BASE]
    assert main([*args, "--epochs", "2", "--checkpoint-every", "0", "--output-weights",
                 "gan"]) == 0
    assert os.path.isdir("gan") and os.path.exists("gan_2.jsonl")
