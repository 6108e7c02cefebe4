"""Image IO helpers (twin of ``tgi/utils/image.py``; replaces the
reference's scattered PIL.Image.fromarray call sites, e.g.
single_id_coach.py:57-62).

PIL is imported inside the functions that read or write files, so the
module imports where Pillow is absent.
"""

from __future__ import annotations

import numpy as np
import torch


def _numpy(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        return img.detach().float().cpu().numpy()
    return np.asarray(img)


def to_uint8(img, input_range=(-1, 1)) -> np.ndarray:
    """[C, H, W] or [N, C, H, W] float -> [H, W, C] uint8 (first item)."""
    arr = _numpy(img)
    if arr.ndim == 4:
        arr = arr[0]
    lo, hi = input_range
    arr = (arr - lo) / (hi - lo) * 255.0
    arr = np.clip(np.rint(arr), 0, 255).astype(np.uint8)
    return np.transpose(arr, (1, 2, 0))


def save_image(path, img, input_range=(-1, 1)):
    from PIL import Image
    Image.fromarray(to_uint8(img, input_range), "RGB").save(path)


def save_image_grid(path, imgs, cols=None, input_range=(-1, 1)):
    """imgs: [N, C, H, W] -> single grid png."""
    from PIL import Image
    arr = _numpy(imgs)
    n = arr.shape[0]
    cols = cols or n
    rows = (n + cols - 1) // cols
    tiles = [to_uint8(arr[i], input_range) for i in range(n)]
    h, w, c = tiles[0].shape
    grid = np.zeros((rows * h, cols * w, c), np.uint8)
    for i, t in enumerate(tiles):
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = t
    Image.fromarray(grid, "RGB").save(path)


def load_image(path, size=None, to_range=(-1, 1)) -> np.ndarray:
    """Load RGB image -> [1, 3, H, W] float32 numpy in ``to_range``.

    A ``.npy`` file holds the image itself, a float [3, H, W] or
    [1, 3, H, W] array in [-1, 1] (what :func:`save_image` takes), so
    images load where Pillow is absent; it is resized by an area shrink
    when its side is a multiple of ``size``, else by the antialiased
    bilinear resize, rather than Pillow's Lanczos filter."""
    if str(path).endswith(".npy"):
        arr = np.load(path).astype(np.float32)
        arr = arr.reshape((1,) + arr.shape[-3:])
        if size is not None:
            arr = _resize(arr, size)
        lo, hi = to_range
        return arr if (lo, hi) == (-1, 1) else (arr + 1) / 2 * (hi - lo) + lo
    from PIL import Image
    img = Image.open(path).convert("RGB")
    if size is not None:
        img = img.resize((size, size), Image.LANCZOS)
    arr = np.asarray(img, np.float32) / 255.0
    lo, hi = to_range
    arr = arr * (hi - lo) + lo
    return np.transpose(arr, (2, 0, 1))[None]


def _resize(arr, size) -> np.ndarray:
    """[1, 3, H, W] float32 -> [1, 3, size, size]."""
    from tgi_torch.losses.warp import area_downsample, bilinear_resize_nchw
    if arr.shape[-1] == size and arr.shape[-2] == size:
        return arr
    x = torch.from_numpy(np.ascontiguousarray(arr))
    if arr.shape[-1] == arr.shape[-2] and arr.shape[-1] % size == 0:
        return area_downsample(x, size).numpy()
    return bilinear_resize_nchw(x, size).numpy()
