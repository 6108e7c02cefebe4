"""Dataset preparation CLI: images from many sources -> training archive
(twin of ``tgi/apps/dataset_tool.py``; click and Pillow are imported
inside the functions that use them).

Behavioral parity target: dataset_tool.py (reference root). Input format
is guessed from --source exactly as upstream (dataset_tool.py:268-284):

  *_lmdb/                      LSUN lmdb directory
  cifar-10-python.tar.gz       CIFAR-10 tarball
  train-images-idx3-ubyte.gz   MNIST idx archive
  <dir>/                       recursive image folder
  *.zip                        image zip (with optional dataset.json)

Output (--dest) is a folder or an uncompressed zip of ``compress_level=0``
PNGs named ``00000/img00000000.png`` with a ``dataset.json`` label table
(dataset_tool.py:405-460), enforcing uniform square power-of-two
dimensions across the dataset. Transforms: scale to WxH, center-crop,
center-crop-wide (with the black-canvas letterbox for non-square
resolutions, dataset_tool.py:237-259). What it writes is what
``tgi_torch.train.dataset.ImageFolderDataset`` reads.
"""

from __future__ import annotations

import functools
import gzip
import io
import json
import os
import pickle
import tarfile
import zipfile

import numpy as np

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def _is_image(fname):
    return os.path.splitext(fname)[1].lower() in IMAGE_EXTS


def _maybe_min(a, b):
    return min(a, b) if b is not None else a


def _fail(msg):
    """Stop with ``msg`` as the command line's error."""
    import click
    raise click.ClickException(msg)


# -- input sources (dataset_tool.py:70-215) --------------------------------


def open_image_folder(source_dir, max_images=None):
    from PIL import Image

    files = []
    for root, _dirs, names in os.walk(source_dir):
        for n in sorted(names):
            if _is_image(n):
                files.append(os.path.join(root, n))
    files.sort()
    labels = {}
    meta = os.path.join(source_dir, "dataset.json")
    if os.path.isfile(meta):
        with open(meta) as f:
            table = json.load(f)["labels"]
        if table is not None:
            labels = {x[0]: x[1] for x in table}

    max_idx = _maybe_min(len(files), max_images)

    def it():
        for idx, fname in enumerate(files[:max_idx]):
            arch = os.path.relpath(fname, source_dir).replace("\\", "/")
            yield dict(img=np.array(Image.open(fname)),
                       label=labels.get(arch))

    return max_idx, it()


def open_image_zip(source, max_images=None):
    from PIL import Image

    with zipfile.ZipFile(source) as z:
        names = [f for f in sorted(z.namelist()) if _is_image(f)]
        labels = {}
        if "dataset.json" in z.namelist():
            with z.open("dataset.json") as f:
                table = json.load(f)["labels"]
            if table is not None:
                labels = {x[0]: x[1] for x in table}

    max_idx = _maybe_min(len(names), max_images)

    def it():
        with zipfile.ZipFile(source) as z:
            for fname in names[:max_idx]:
                with z.open(fname) as f:
                    img = np.array(Image.open(f))
                yield dict(img=img, label=labels.get(fname))

    return max_idx, it()


def open_lmdb(lmdb_dir, max_images=None):
    from PIL import Image
    try:
        import lmdb
    except ImportError as e:
        raise ImportError(
            "LSUN ingestion needs the 'lmdb' package (pip install lmdb), "
            "which is not installed") from e

    with lmdb.open(lmdb_dir, readonly=True, lock=False).begin(
            write=False) as txn:
        max_idx = _maybe_min(txn.stat()["entries"], max_images)

    def it():
        with lmdb.open(lmdb_dir, readonly=True, lock=False).begin(
                write=False) as txn:
            idx = 0
            for _key, value in txn.cursor():
                try:
                    img = np.array(Image.open(io.BytesIO(value)))
                except Exception as e:  # corrupt entries are skipped
                    print(f"skipping lmdb entry: {e}")
                    continue
                yield dict(img=img, label=None)
                idx += 1
                if idx >= max_idx:
                    break

    return max_idx, it()


def open_cifar10(tarball, max_images=None):
    images, labels = [], []
    with tarfile.open(tarball, "r:gz") as tar:
        for batch in range(1, 6):
            member = tar.getmember(f"cifar-10-batches-py/data_batch_{batch}")
            with tar.extractfile(member) as f:
                data = pickle.load(f, encoding="latin1")
            images.append(np.asarray(data["data"],
                                     np.uint8).reshape(-1, 3, 32, 32))
            labels.append(data["labels"])
    images = np.concatenate(images).transpose(0, 2, 3, 1)   # NHWC
    labels = np.concatenate(labels)
    assert images.shape == (50000, 32, 32, 3)
    assert labels.shape == (50000,)

    max_idx = _maybe_min(len(images), max_images)

    def it():
        for idx in range(max_idx):
            yield dict(img=images[idx], label=int(labels[idx]))

    return max_idx, it()


def open_mnist(images_gz, max_images=None):
    labels_gz = images_gz.replace("-images-idx3-ubyte.gz",
                                  "-labels-idx1-ubyte.gz")
    assert labels_gz != images_gz
    with gzip.open(images_gz, "rb") as f:
        images = np.frombuffer(f.read(), np.uint8, offset=16)
    with gzip.open(labels_gz, "rb") as f:
        labels = np.frombuffer(f.read(), np.uint8, offset=8)
    images = images.reshape(-1, 28, 28)
    # Pad 28x28 -> 32x32 (dataset_tool.py:199)
    images = np.pad(images, [(0, 0), (2, 2), (2, 2)], "constant")
    assert images.shape[1:] == (32, 32)

    max_idx = _maybe_min(len(images), max_images)

    def it():
        for idx in range(max_idx):
            yield dict(img=images[idx], label=int(labels[idx]))

    return max_idx, it()


def open_dataset(source, max_images=None):
    if os.path.isdir(source):
        if source.rstrip("/").endswith("_lmdb"):
            return open_lmdb(source, max_images)
        return open_image_folder(source, max_images)
    if os.path.isfile(source):
        base = os.path.basename(source)
        if base == "cifar-10-python.tar.gz":
            return open_cifar10(source, max_images)
        if base == "train-images-idx3-ubyte.gz":
            return open_mnist(source, max_images)
        if source.lower().endswith(".zip"):
            return open_image_zip(source, max_images)
        _fail(f"unknown archive type: {source}")
    _fail(f"missing input file or directory: {source}")


# -- transforms (dataset_tool.py:218-263) ----------------------------------


def make_transform(transform, output_width, output_height):
    from PIL import Image

    def scale(width, height, img):
        h, w = img.shape[:2]
        if width == w and height == h:
            return img
        ww = width if width is not None else w
        hh = height if height is not None else h
        return np.array(Image.fromarray(img).resize((ww, hh),
                                                    Image.LANCZOS))

    def center_crop(width, height, img):
        crop = np.min(img.shape[:2])
        img = img[(img.shape[0] - crop) // 2:(img.shape[0] + crop) // 2,
                  (img.shape[1] - crop) // 2:(img.shape[1] + crop) // 2]
        img = Image.fromarray(img, "RGB")
        return np.array(img.resize((width, height), Image.LANCZOS))

    def center_crop_wide(width, height, img):
        ch = int(np.round(width * img.shape[0] / img.shape[1]))
        if img.shape[1] < width or ch < height:
            return None      # transform may drop images
        img = img[(img.shape[0] - ch) // 2:(img.shape[0] + ch) // 2]
        img = Image.fromarray(img, "RGB")
        img = np.array(img.resize((width, height), Image.LANCZOS))
        canvas = np.zeros([width, width, 3], dtype=np.uint8)
        canvas[(width - height) // 2:(width + height) // 2, :] = img
        return canvas

    if transform is None:
        return functools.partial(scale, output_width, output_height)
    if output_width is None or output_height is None:
        _fail(f"must specify --resolution=WxH when using {transform}")
    return functools.partial(
        {"center-crop": center_crop,
         "center-crop-wide": center_crop_wide}[transform],
        output_width, output_height)


# -- output (dataset_tool.py:288-316) --------------------------------------


def open_dest(dest):
    if dest.lower().endswith(".zip"):
        if os.path.dirname(dest):
            os.makedirs(os.path.dirname(dest), exist_ok=True)
        zf = zipfile.ZipFile(dest, "w", zipfile.ZIP_STORED)
        return "", zf.writestr, zf.close
    if os.path.isdir(dest) and os.listdir(dest):
        _fail("--dest folder must be empty")
    os.makedirs(dest, exist_ok=True)

    def write_bytes(fname, data):
        os.makedirs(os.path.dirname(fname), exist_ok=True)
        with open(fname, "wb") as f:
            f.write(data.encode("utf8") if isinstance(data, str) else data)

    return dest, write_bytes, lambda: None


def _parse_resolution(value):
    if value is None:
        return None, None
    if "x" in value:
        w, h = value.split("x")
        return int(w), int(h)
    r = int(value)
    return r, r


def convert(source, dest, *, max_images=None, transform=None,
            resolution=None):
    """Library entry: run the full conversion; returns image count."""
    from PIL import Image

    num_files, input_iter = open_dataset(source, max_images)
    root, save_bytes, close_dest = open_dest(dest)
    out_w, out_h = _parse_resolution(resolution)
    transform_image = make_transform(transform, out_w, out_h)

    dataset_attrs = None
    labels = []
    count = 0
    for idx, image in enumerate(input_iter):
        idx_str = f"{idx:08d}"
        archive_fname = f"{idx_str[:5]}/img{idx_str}.png"

        img = transform_image(image["img"])
        if img is None:
            continue

        channels = img.shape[2] if img.ndim == 3 else 1
        cur = {"width": img.shape[1], "height": img.shape[0],
               "channels": channels}
        if dataset_attrs is None:
            dataset_attrs = cur
            w, h = cur["width"], cur["height"]
            if w != h:
                _fail(f"images must be square after scale/crop, got {w}x{h}")
            if channels not in (1, 3, 4):
                _fail("images must be RGB(A) or grayscale")
            if w != 2 ** int(np.floor(np.log2(w))):
                _fail(f"width/height must be a power of two, got {w}")
        elif dataset_attrs != cur:
            _fail(f"image {archive_fname} attributes {cur} differ from the "
                  f"dataset's {dataset_attrs}")

        pil = Image.fromarray(img, {1: "L", 3: "RGB", 4: "RGBA"}[channels])
        if channels == 4:
            pil = pil.convert("RGB")
        bits = io.BytesIO()
        pil.save(bits, format="png", compress_level=0, optimize=False)
        save_bytes(os.path.join(root, archive_fname), bits.getvalue())
        labels.append([archive_fname, image["label"]]
                      if image["label"] is not None else None)
        count += 1

    metadata = {"labels":
                labels if all(x is not None for x in labels) else None}
    save_bytes(os.path.join(root, "dataset.json"), json.dumps(metadata))
    close_dest()
    return count


def main(argv=None):
    """Command line: ``--source PATH --dest PATH`` (``--max-images``,
    ``--transform``, ``--resolution``)."""
    import click

    @click.command()
    @click.option("--source", required=True,
                  help="folder / *.zip / *_lmdb / cifar-10-python.tar.gz / "
                       "train-images-idx3-ubyte.gz")
    @click.option("--dest", required=True, help="output folder or .zip")
    @click.option("--max-images", type=int, default=None)
    @click.option("--transform", default=None,
                  type=click.Choice(["center-crop", "center-crop-wide"]))
    @click.option("--resolution", default=None,
                  help="output resolution, e.g. 512x512 (WxH) or 512")
    def cli(source, dest, max_images, transform, resolution):
        n = convert(source, dest, max_images=max_images, transform=transform,
                    resolution=resolution)
        click.echo(f"wrote {n} images -> {dest}")

    cli.main(args=argv, standalone_mode=True)


if __name__ == "__main__":
    main()
