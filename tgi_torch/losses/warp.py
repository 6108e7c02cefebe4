"""Image resizing for the losses (twin of the resize helpers of
``tgi/losses/warp.py``).

``calc_warping_loss``, the depth-warping loss of stage 1, comes with the
projector (ROADMAP Queue A item 7).
"""

from __future__ import annotations

import torch.nn.functional as F


def area_downsample(x, out_size):
    """torch F.interpolate(mode='area') for integer shrink factors."""
    n, c, h, w = x.shape
    f = h // out_size
    if f * out_size != h or w != h:
        raise ValueError(f"area_downsample needs a square image whose side "
                         f"is a multiple of {out_size}, got {h}x{w}")
    return x.reshape(n, c, out_size, f, out_size, f).mean(dim=(3, 5))


def bilinear_resize_nchw(x, out_size):
    """``jax.image.resize(method="linear")`` to ``out_size`` square, for
    enlargement only.

    When enlarging, jax's triangle kernel with half-pixel centres and
    edge renormalisation gives the same values as bilinear interpolation
    with ``align_corners=False`` and an edge clamp. When shrinking, jax
    widens the kernel (antialiasing) and torch's bilinear does not, so a
    shrink raises instead of differing.
    """
    _, _, h, w = x.shape
    if out_size < h or out_size < w:
        raise NotImplementedError(
            f"bilinear_resize_nchw shrinks {h}x{w} to {out_size}: jax's "
            f"antialiased shrink is not ported")
    return F.interpolate(x, size=(out_size, out_size), mode="bilinear",
                         align_corners=False)
