"""Training datasets: image folders / zips with optional camera labels
(twin of ``tgi/train/dataset.py``).

Behavioral parity target: training/dataset.py:28-244 (ImageFolderDataset:
dir-or-zip of images + dataset.json labels, xflip augmentation doubling)
and misc.InfiniteSampler's rank-sharded infinite iteration
(misc.py:113-148). numpy only: the batches are numpy arrays, moved to
the card by the training loop.

Beside ``tgi``'s PNG and JPEG images, a folder or zip may hold ``.npy``
images (float ``[3, H, W]`` in [-1, 1], as ``run_pti`` reads them), so a
dataset loads where Pillow is absent; Pillow is imported only to decode
an image file.
"""

from __future__ import annotations

import io
import json
import os
import zipfile

import numpy as np

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".npy")


class ImageFolderDataset:
    """Images from a directory or .zip, with optional dataset.json labels
    of the form {"labels": [[fname, [floats...]], ...]}."""

    def __init__(self, path: str, resolution: int | None = None,
                 use_labels: bool = True, xflip: bool = False,
                 max_size: int | None = None):
        self.path = path
        self.resolution = resolution
        self.xflip = xflip
        self._zip = None
        if path.endswith(".zip"):
            self._zip = zipfile.ZipFile(path)
            names = [n for n in self._zip.namelist()
                     if n.lower().endswith(IMAGE_EXTS)]
        else:
            names = [os.path.join(dp, f)[len(path) + 1:]
                     for dp, _, files in os.walk(path) for f in files
                     if f.lower().endswith(IMAGE_EXTS)]
        self._names = sorted(names)
        if max_size is not None:
            self._names = self._names[:max_size]

        self._labels = None
        if use_labels:
            raw = self._read("dataset.json")
            labels = json.loads(raw)["labels"] if raw is not None else None
            # dataset_tool writes {"labels": null} for an unlabelled set.
            if labels is not None:
                table = {fname.replace("\\", "/"): np.asarray(label,
                                                              np.float32)
                         for fname, label in labels}
                self._labels = [table.get(n.replace("\\", "/"))
                                for n in self._names]

        self._base_len = len(self._names)

    def _read(self, name):
        try:
            if self._zip is not None:
                return self._zip.read(name)
            with open(os.path.join(self.path, name), "rb") as f:
                return f.read()
        except (KeyError, FileNotFoundError):
            return None

    def close(self):
        if self._zip is not None:
            self._zip.close()

    def __len__(self):
        return self._base_len * (2 if self.xflip else 1)

    @property
    def label_dim(self):
        if self._labels is None or self._labels[0] is None:
            return 0
        return len(self._labels[0])

    def _image(self, name):
        """[3, R, R] float32 in [-1, 1]."""
        data = self._read(name)
        if name.lower().endswith(".npy"):
            arr = np.load(io.BytesIO(data)).astype(np.float32)
            arr = arr.reshape(arr.shape[-3:])
            if self.resolution and arr.shape[-1] != self.resolution:
                from tgi_torch.utils.image import _resize
                arr = _resize(arr[None], self.resolution)[0]
            return arr
        from PIL import Image
        img = Image.open(io.BytesIO(data)).convert("RGB")
        if self.resolution and img.size[0] != self.resolution:
            img = img.resize((self.resolution, self.resolution),
                             Image.LANCZOS)
        return np.asarray(img, np.float32).transpose(2, 0, 1) / 127.5 - 1

    def __getitem__(self, idx):
        flip = self.xflip and idx >= self._base_len
        base = idx % self._base_len
        arr = self._image(self._names[base])
        if flip:
            arr = arr[:, :, ::-1].copy()
        label = np.zeros(25, np.float32)
        if self._labels is not None and self._labels[base] is not None:
            label = self._labels[base].copy()
            if flip and len(label) == 25:
                # Mirror the camera pose: negate the x-axis terms
                # (dataset.py xflip label handling for EG3D poses).
                ext = label[:16].reshape(4, 4)
                flip_mat = np.diag([-1, 1, 1, 1]).astype(np.float32)
                ext = flip_mat @ ext
                ext[:, 0] *= -1
                label[:16] = ext.reshape(-1)
        return arr, label


def infinite_batches(dataset, batch_size: int, *, seed=0, host_id=0,
                     num_hosts=1, shuffle=True):
    """Deterministic host-sharded infinite batch iterator
    (misc.py:113-148 InfiniteSampler equivalent)."""
    rng = np.random.RandomState(seed)
    order = np.arange(len(dataset))
    while True:
        if shuffle:
            rng.shuffle(order)
        shard = order[host_id::num_hosts]
        for i in range(0, len(shard) - batch_size + 1, batch_size):
            idx = shard[i:i + batch_size]
            imgs, labels = zip(*(dataset[j] for j in idx))
            yield np.stack(imgs), np.stack(labels)
