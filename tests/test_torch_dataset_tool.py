"""tgi_torch's ``dataset_tool`` against tgi's, on the CPU, and what it
writes read back by the port's ``ImageFolderDataset``; also
``utils/summary.py``.

Each source (an image folder with labels, a zip, a CIFAR-10 tarball and
an MNIST idx pair, built here in the reference's layouts) and each
transform goes through both packages' ``convert``: the same archive
names, the same ``dataset.json`` and the same PNG bytes. A zip's own
bytes carry the time of writing, so its members are compared, not the
file.
"""

import gzip
import io
import json
import os
import pickle
import tarfile
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from tgi.apps import dataset_tool as jdt
from tgi.utils.summary import module_summary as j_module_summary
from tgi_torch.apps import dataset_tool as dt
from tgi_torch.train.dataset import ImageFolderDataset
from tgi_torch.utils.summary import module_summary, print_module_summary


def _members(dest):
    """{archive name: bytes} of a zip or a folder."""
    if dest.endswith(".zip"):
        with zipfile.ZipFile(dest) as z:
            return {n: z.read(n) for n in z.namelist()}
    out = {}
    for root, _, files in os.walk(dest):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, dest).replace(os.sep, "/")] = fh.read()
    return out


def _both(tmp_path, source, name, **kw):
    """Both packages' conversion of ``source``: (members, count)."""
    got = str(tmp_path / f"port_{name}")
    want = str(tmp_path / f"tgi_{name}")
    n = dt.convert(source, got, **kw)
    assert n == jdt.convert(source, want, **kw)
    a, b = _members(got), _members(want)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k] == b[k], k
    return got, a, n


def _write_images(d, n=3, size=32, nested=False, seed=0):
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    names = []
    for i in range(n):
        sub = os.path.join(d, f"{i:02d}") if nested else d
        os.makedirs(sub, exist_ok=True)
        name = os.path.join(sub, f"im{i}.png")
        Image.fromarray(rng.randint(0, 255, (size, size, 3),
                                    dtype=np.uint8)).save(name)
        names.append(os.path.relpath(name, d).replace("\\", "/"))
    return names


def test_folder_to_zip_with_labels_reads_back(tmp_path):
    """A nested folder with 25-float camera labels -> zip, equal to tgi's;
    ``ImageFolderDataset`` reads the zip: each image equals the PNG it
    stores, with its label."""
    src = str(tmp_path / "src")
    names = _write_images(src, n=3, nested=True)
    labels = np.random.RandomState(1).randn(3, 25).round(3).tolist()
    with open(os.path.join(src, "dataset.json"), "w") as f:
        json.dump({"labels": [[n, lab] for n, lab in zip(names, labels)]},
                  f)
    dest, members, n = _both(tmp_path, src, "a.zip")
    assert n == 3 and "00000/img00000000.png" in members
    meta = json.loads(members["dataset.json"])
    assert [m[0] for m in meta["labels"]] == [
        f"00000/img0000000{i}.png" for i in range(3)]
    ds = ImageFolderDataset(dest)
    assert len(ds) == 3 and ds.label_dim == 25
    for i in range(3):
        img, label = ds[i]
        png = np.asarray(Image.open(io.BytesIO(
            members[f"00000/img0000000{i}.png"])), np.float32)
        np.testing.assert_array_equal(img, png.transpose(2, 0, 1) / 127.5
                                      - 1)
        np.testing.assert_array_equal(label, np.float32(labels[i]))
    ds.close()


def test_zip_to_folder_and_unlabelled_read_back(tmp_path):
    """Folder -> zip -> folder, each equal to tgi's. A set without labels
    gets ``{"labels": null}``, which ``ImageFolderDataset`` reads as no
    labels (tgi's reader fails on it)."""
    src = str(tmp_path / "src")
    _write_images(src, n=2, seed=2)
    z1, members, _ = _both(tmp_path, src, "a.zip")
    assert json.loads(members["dataset.json"]) == {"labels": None}
    out, unpacked, n = _both(tmp_path, z1, "unpacked")
    assert n == 2 and unpacked == members
    for path in (z1, out):
        ds = ImageFolderDataset(path, xflip=True)
        assert len(ds) == 4 and ds.label_dim == 0
        img, label = ds[3]
        np.testing.assert_array_equal(img, ds[1][0][:, :, ::-1])
        assert not label.any()
        ds.close()


def test_cifar10_source(tmp_path):
    """The cifar-10-python.tar.gz layout (dataset_tool.py:156-177), 20
    images with their class labels."""
    rng = np.random.RandomState(1)
    tar_path = str(tmp_path / "cifar-10-python.tar.gz")
    with tarfile.open(tar_path, "w:gz") as tar:
        for b in range(1, 6):
            data = {"data": rng.randint(0, 256, (10000, 3072),
                                        dtype=np.int64).astype(np.uint8),
                    "labels": list(rng.randint(0, 10, 10000))}
            blob = pickle.dumps(data)
            info = tarfile.TarInfo(f"cifar-10-batches-py/data_batch_{b}")
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))
    _, members, n = _both(tmp_path, tar_path, "cifar.zip", max_images=20)
    meta = json.loads(members["dataset.json"])
    assert n == 20 and len(meta["labels"]) == 20
    img = np.asarray(Image.open(io.BytesIO(
        members["00000/img00000000.png"])))
    assert img.shape == (32, 32, 3)


def test_mnist_source(tmp_path):
    """The idx-ubyte pair (dataset_tool.py:184-206): 28² padded to 32²,
    grayscale PNGs."""
    rng = np.random.RandomState(2)
    imgs = rng.randint(0, 256, (60000, 28, 28), dtype=np.int64
                       ).astype(np.uint8)
    lbls = rng.randint(0, 10, 60000).astype(np.uint8)
    img_gz = str(tmp_path / "train-images-idx3-ubyte.gz")
    with gzip.open(img_gz, "wb") as f:
        f.write(b"\x00" * 16 + imgs.tobytes())
    with gzip.open(str(tmp_path / "train-labels-idx1-ubyte.gz"), "wb") as f:
        f.write(b"\x00" * 8 + lbls.tobytes())
    _, members, n = _both(tmp_path, img_gz, "mnist.zip", max_images=15)
    img = np.asarray(Image.open(io.BytesIO(
        members["00000/img00000003.png"])))
    assert n == 15 and img.shape == (32, 32)
    np.testing.assert_array_equal(img[2:-2, 2:-2], imgs[3])


@pytest.mark.parametrize("transform,resolution,count", [
    ("center-crop", "32x32", 2), ("center-crop-wide", "64x48", 1),
    (None, "32", 2)])
def test_transforms(tmp_path, transform, resolution, count):
    """center-crop of a wide and a small image; center-crop-wide's
    letterbox, which drops the image narrower than the output; a plain
    resize to 32²."""
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.RandomState(3)
    Image.fromarray(rng.randint(0, 255, (300, 400, 3), dtype=np.uint8)
                    ).save(src / "a.png")
    Image.fromarray(rng.randint(0, 255, (20, 30, 3), dtype=np.uint8)
                    ).save(src / "b.png")
    _, members, n = _both(tmp_path, str(src), "t.zip", transform=transform,
                          resolution=resolution)
    assert n == count
    img = np.asarray(Image.open(io.BytesIO(
        members["00000/img00000000.png"])))
    side = int(resolution.split("x")[0])
    assert img.shape == (side, side, 3)
    if transform == "center-crop-wide":
        assert img[:8].max() == 0 and img[-8:].max() == 0
        assert img[32].max() > 0


def test_validation_errors(tmp_path):
    """The same errors as tgi's: a width that is not a power of two,
    images of two sizes, a transform without --resolution, a non-empty
    folder destination, an unknown archive, a missing source."""
    import click
    src = tmp_path / "src"
    src.mkdir()
    Image.fromarray(np.zeros((40, 40, 3), np.uint8)).save(src / "a.png")
    src2 = tmp_path / "src2"
    src2.mkdir()
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(src2 / "a.png")
    Image.fromarray(np.zeros((64, 64, 3), np.uint8)).save(src2 / "b.png")
    (tmp_path / "x.tar").write_bytes(b"")
    cases = [((str(src), str(tmp_path / "x.zip")), {}, "power of two"),
             ((str(src2), str(tmp_path / "y.zip")), {}, "attributes"),
             ((str(src2), str(tmp_path / "z.zip")),
              {"transform": "center-crop"}, "--resolution"),
             ((str(src2), str(src)), {}, "must be empty"),
             ((str(tmp_path / "x.tar"), str(tmp_path / "w")), {},
              "unknown archive"),
             ((str(tmp_path / "none"), str(tmp_path / "v")), {}, "missing")]
    for args, kw, match in cases:
        for convert in (dt.convert, jdt.convert):
            with pytest.raises(click.ClickException, match=match):
                convert(*args, **kw)


def test_cli_writes_what_convert_writes(tmp_path):
    src = str(tmp_path / "src")
    _write_images(src, n=2, seed=4)
    with pytest.raises(SystemExit) as e:
        dt.main(["--source", src, "--dest", str(tmp_path / "cli.zip"),
                 "--transform", "center-crop", "--resolution", "16"])
    assert e.value.code == 0
    jdt.convert(src, str(tmp_path / "lib.zip"), transform="center-crop",
                resolution="16")
    a, b = _members(str(tmp_path / "cli.zip")), _members(
        str(tmp_path / "lib.zip"))
    assert a == b and len(a) == 3


def test_module_summary_equals_tgi():
    """The same table for a dict of tensors as tgi's for the same numpy
    tree, at depth 1, 2 and full depth."""
    g = torch.Generator().manual_seed(0)
    tree = {"mapping": {"fc0": {"weight": torch.randn(8, 4, generator=g),
                                "bias": torch.zeros(8)},
                        "w_avg": torch.zeros(8)},
            "backbone": {"b4": {"const": torch.zeros(16, 4, 4),
                                "conv1": {"weight": torch.zeros(16, 16, 3,
                                                                3)}}},
            "scale": torch.zeros(())}
    jtree = _numpy(tree)
    for depth in (1, 2, None):
        assert module_summary(tree, depth) == j_module_summary(jtree, depth)
    assert "Total" in print_module_summary(tree)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()
