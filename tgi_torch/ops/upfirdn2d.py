"""Pad / upsample / FIR-filter / downsample for batches of 2D images
(twin of ``tgi/ops/upfirdn2d.py``).

The JAX package wrote this as one dilated depthwise XLA convolution, not
as a Pallas kernel, so the port is plain PyTorch: zero insertion by
reshape and pad, pad or crop, a depthwise ``F.conv2d`` with
``groups=C`` (:class:`_FIR`), then decimation by striding. Layout is
NCHW.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tgi_torch.ops.filters import filter_size, parse_padding, parse_scaling


class _FIR(torch.autograd.Function):
    """Correlation of every channel of ``x`` ``[N, C, H, W]`` with one
    filter ``k`` ``[kh, kw]`` (valid padding), as a depthwise convolution.

    Its gradient is the same correlation of the zero-padded gradient with
    the flipped filter, through this Function again, so it differentiates
    any number of times with depthwise convolutions. Autograd's own double
    backward of a grouped convolution runs one convolution per group:
    R1's double backward through the discriminator's and the augment
    pipe's filters took ~29 s a step on an H100 that way."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.save_for_backward(k)
        return F.conv2d(x, k[None, None].expand(x.shape[1], 1, -1, -1),
                        groups=x.shape[1])

    @staticmethod
    def backward(ctx, gy):
        k, = ctx.saved_tensors
        kh, kw = k.shape
        gy = F.pad(gy, [kw - 1, kw - 1, kh - 1, kh - 1])
        return _FIR.apply(gy, k.flip([0, 1])), None


def upfirdn2d(x: torch.Tensor, f, up=1, down=1, padding=0,
              flip_filter: bool = False, gain: float = 1.0) -> torch.Tensor:
    """Upsample by zero insertion, pad/crop, FIR filter, downsample.

    Args:
        x: ``[N, C, H, W]`` input.
        f: prepared float32 filter (:func:`tgi_torch.ops.filters.setup_filter`):
           ``[fh, fw]``, separable ``[taps]`` or ``None`` (identity).
        up / down: int or (x, y) integer resampling factors.
        padding: int, ``[x, y]`` or ``[x0, x1, y0, y1]`` w.r.t. the
            upsampled image; negative values crop.
        flip_filter: False = convolution, True = correlation.
        gain: overall magnitude scaling.
    """
    assert x.ndim == 4
    if f is None:
        f = np.ones((1, 1), dtype=np.float32)
    f = np.asarray(f, dtype=np.float32)
    assert f.ndim in (1, 2)
    upx, upy = parse_scaling(up)
    downx, downy = parse_scaling(down)
    padx0, padx1, pady0, pady1 = parse_padding(padding)

    N, C, in_h, in_w = x.shape
    up_w = in_w * upx + padx0 + padx1
    up_h = in_h * upy + pady0 + pady1
    assert up_w >= f.shape[-1] and up_h >= f.shape[0], (
        f"upsampled buffer {up_h}x{up_w} smaller than filter {f.shape}")

    # Zero insertion: up-1 zeros after each sample.
    x = x.reshape(N, C, in_h, 1, in_w, 1)
    x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
    x = x.reshape(N, C, in_h * upy, in_w * upx)
    # Pad, then crop the negative paddings.
    x = F.pad(x, [max(padx0, 0), max(padx1, 0), max(pady0, 0), max(pady1, 0)])
    x = x[:, :, max(-pady0, 0):x.shape[2] - max(-pady1, 0),
          max(-padx0, 0):x.shape[3] - max(-padx1, 0)]

    f = f * (gain ** (f.ndim / 2))
    if not flip_filter:
        # F.conv2d correlates; flipping the taps makes it a convolution.
        f = f[::-1] if f.ndim == 1 else f[::-1, ::-1]
    k = torch.as_tensor(f.copy(), dtype=x.dtype, device=x.device)
    if k.ndim == 2:
        x = _FIR.apply(x, k)
    else:
        # Separable: the 1-D taps along W, then along H.
        x = _FIR.apply(x, k[None, :])
        x = _FIR.apply(x, k[:, None])
    return x[:, :, ::downy, ::downx]


def filter2d(x, f, padding=0, flip_filter=False, gain=1.0):
    """FIR-filter with implicit 'same' padding (reference filter2d)."""
    padx0, padx1, pady0, pady1 = parse_padding(padding)
    fw, fh = filter_size(f)
    p = [padx0 + fw // 2, padx1 + (fw - 1) // 2,
         pady0 + fh // 2, pady1 + (fh - 1) // 2]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1.0):
    """FIR-interpolated upsampling (reference upsample2d)."""
    upx, upy = parse_scaling(up)
    padx0, padx1, pady0, pady1 = parse_padding(padding)
    fw, fh = filter_size(f)
    p = [padx0 + (fw + upx - 1) // 2, padx1 + (fw - upx) // 2,
         pady0 + (fh + upy - 1) // 2, pady1 + (fh - upy) // 2]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter,
                     gain=gain * upx * upy)


def downsample2d(x, f, down=2, padding=0, flip_filter=False, gain=1.0):
    """FIR-antialiased downsampling (reference downsample2d)."""
    downx, downy = parse_scaling(down)
    padx0, padx1, pady0, pady1 = parse_padding(padding)
    fw, fh = filter_size(f)
    p = [padx0 + (fw - downx + 1) // 2, padx1 + (fw - downx) // 2,
         pady0 + (fh - downy + 1) // 2, pady1 + (fh - downy) // 2]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter,
                     gain=gain)
