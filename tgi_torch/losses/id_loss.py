"""ArcFace identity loss (twin of ``tgi/losses/id_loss.py``).

Behavioral parity target: criteria/id_loss.py:7-30: crop the face box
[35:223, 32:220], pool to 112², embed with the IR-SE50 backbone, return
1 - cosine similarity.
"""

from __future__ import annotations

import torch

from tgi_torch.losses.warp import area_downsample, bilinear_resize_nchw


def extract_face_crop(img):
    """[N, 3, 256, 256] -> ArcFace 112² input (id_loss.py:15-22).

    ``tgi`` shrinks the 188² crop with ``jax.image.resize(..., "linear")``,
    which antialiases; :func:`bilinear_resize_nchw` is that resize."""
    return bilinear_resize_nchw(img[:, :, 35:223, 32:220], 112)


def _to_256(x):
    if x.shape[-1] > 256:
        return area_downsample(x, 256)
    if x.shape[-1] < 256:
        # Small test generators render below 256²; enlarge (no reference
        # counterpart: the reference's images are 512²).
        return bilinear_resize_nchw(x, 256)
    return x


def id_loss(embed_fn, y_hat, y):
    """1 - cos(embed(y_hat), embed(y)); images in [-1, 1] at 256² or a
    multiple of it (smaller ones are enlarged).

    ``embed_fn``: images -> [N, 512] embeddings
    (``tgi_torch.models.arcface``)."""
    y, y_hat = _to_256(y), _to_256(y_hat)
    f1 = embed_fn(extract_face_crop(y))
    f2 = embed_fn(extract_face_crop(y_hat))
    f1 = f1 / torch.linalg.norm(f1, dim=-1, keepdim=True)
    f2 = f2 / torch.linalg.norm(f2, dim=-1, keepdim=True)
    return 1.0 - torch.sum(f1 * f2, dim=-1).mean()
