"""Filtered leaky ReLU, StyleGAN3's antialiased nonlinearity (twin of
``tgi/ops/filtered_lrelu.py``).

The reference fuses the chain into one CUDA kernel
(torch_utils/ops/filtered_lrelu.py:58-150 + filtered_lrelu.cu); ``tgi``
wrote it as plain JAX (bias_act + upfirdn2d, no Pallas kernel), so the
port composes the same stages in plain PyTorch: bias -> zero-insert
upsample + FIR -> lrelu(gain, clamp) -> FIR + downsample.
"""

from __future__ import annotations

import math

import torch

from tgi_torch.ops.bias_act import bias_act
from tgi_torch.ops.filters import parse_padding
from tgi_torch.ops.upfirdn2d import upfirdn2d


def filtered_lrelu(x: torch.Tensor, fu=None, fd=None, b=None, up: int = 1,
                   down: int = 1, padding=0, gain: float = math.sqrt(2),
                   slope: float = 0.2, clamp: float | None = None,
                   flip_filter: bool = False) -> torch.Tensor:
    """bias -> zero-insert upsample -> FIR -> lrelu(gain, clamp) -> FIR ->
    down. ``fu`` / ``fd``: numpy filters (1-D separable or 2-D) or None;
    ``padding`` is w.r.t. the upsampled image."""
    assert x.ndim == 4
    assert isinstance(up, int) and up >= 1
    assert isinstance(down, int) and down >= 1
    px0, px1, py0, py1 = parse_padding(padding)
    x = bias_act(x, b)
    x = upfirdn2d(x, fu, up=up, padding=[px0, px1, py0, py1], gain=up ** 2,
                  flip_filter=flip_filter)
    x = bias_act(x, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    x = upfirdn2d(x, fd, down=down, flip_filter=flip_filter)
    return x
