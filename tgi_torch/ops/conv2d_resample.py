"""2D convolution with optional FIR up/downsampling (twin of
``tgi/ops/conv2d_resample.py``).

Behavioral parity target: torch_utils/ops/conv2d_resample.py:48-143. The
routing fast paths are kept because they pick which convolution runs
(strided, transposed or plain); the reference's gradfix machinery is not
needed.
"""

from __future__ import annotations

import torch.nn.functional as F

from tgi_torch.ops.filters import filter_size, parse_padding
from tgi_torch.ops.upfirdn2d import upfirdn2d


def _conv2d_wrapper(x, w, stride=1, padding=0, groups=1, transpose=False,
                    flip_weight=True):
    """Flip-aware conv dispatcher (reference conv2d_resample.py:31-43)."""
    kh, kw = w.shape[2], w.shape[3]
    if not flip_weight and (kw > 1 or kh > 1):
        w = w.flip([2, 3])
    op = F.conv_transpose2d if transpose else F.conv2d
    return op(x, w, stride=stride, padding=padding, groups=groups)


def conv2d_resample(x, w, f=None, up=1, down=1, padding=0, groups=1,
                    flip_weight=True, flip_filter=False):
    """Conv2d with optional up/downsampling; padding applied once up front.

    Args:
        x: ``[N, C_in, H, W]`` input.
        w: ``[C_out, C_in // groups, kh, kw]`` weights.
        f: prepared FIR filter for the resampling (or None).
        up / down: integer resampling factors.
        padding: w.r.t. the upsampled image; int / [x,y] / [x0,x1,y0,y1].
        groups: channel groups.
        flip_weight: False = convolution, True = correlation.
        flip_filter: same for the FIR filter.
    """
    assert x.ndim == 4 and w.ndim == 4
    assert isinstance(up, int) and up >= 1
    assert isinstance(down, int) and down >= 1
    out_channels, in_channels_per_group, kh, kw = w.shape
    fw, fh = filter_size(f)
    px0, px1, py0, py1 = parse_padding(padding)

    # Adjust padding to account for up/downsampling.
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    # 1x1 kernel + downsampling only: downsample first, then convolve.
    if kw == 1 and kh == 1 and down > 1 and up == 1:
        x = upfirdn2d(x, f, down=down, padding=[px0, px1, py0, py1],
                      flip_filter=flip_filter)
        return _conv2d_wrapper(x, w, groups=groups, flip_weight=flip_weight)

    # 1x1 kernel + upsampling only: convolve first, then upsample.
    if kw == 1 and kh == 1 and up > 1 and down == 1:
        x = _conv2d_wrapper(x, w, groups=groups, flip_weight=flip_weight)
        return upfirdn2d(x, f, up=up, padding=[px0, px1, py0, py1],
                         gain=up ** 2, flip_filter=flip_filter)

    # Downsampling only: strided convolution.
    if down > 1 and up == 1:
        x = upfirdn2d(x, f, padding=[px0, px1, py0, py1],
                      flip_filter=flip_filter)
        return _conv2d_wrapper(x, w, stride=down, groups=groups,
                               flip_weight=flip_weight)

    # Upsampling: transposed strided convolution.
    if up > 1:
        if groups == 1:
            w = w.transpose(0, 1)
        else:
            w = w.reshape(groups, out_channels // groups,
                          in_channels_per_group, kh, kw)
            w = w.transpose(1, 2)
            w = w.reshape(groups * in_channels_per_group,
                          out_channels // groups, kh, kw)
        px0 -= kw - 1
        px1 -= kw - up
        py0 -= kh - 1
        py1 -= kh - up
        pxt = max(min(-px0, -px1), 0)
        pyt = max(min(-py0, -py1), 0)
        x = _conv2d_wrapper(x, w, stride=up, padding=[pyt, pxt],
                            groups=groups, transpose=True,
                            flip_weight=(not flip_weight))
        x = upfirdn2d(x, f, padding=[px0 + pxt, px1 + pxt, py0 + pyt,
                                     py1 + pyt],
                      gain=up ** 2, flip_filter=flip_filter)
        if down > 1:
            x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
        return x

    # Plain convolution with symmetric padding.
    if up == 1 and down == 1:
        if px0 == px1 and py0 == py1 and px0 >= 0 and py0 >= 0:
            return _conv2d_wrapper(x, w, padding=[py0, px0], groups=groups,
                                   flip_weight=flip_weight)

    # Generic fallback.
    x = upfirdn2d(x, (f if up > 1 else None), up=up,
                  padding=[px0, px1, py0, py1], gain=up ** 2,
                  flip_filter=flip_filter)
    x = _conv2d_wrapper(x, w, groups=groups, flip_weight=flip_weight)
    if down > 1:
        x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
    return x
