"""SSIM / MS-SSIM (twin of ``tgi/metrics/msssim.py``).

Replaces the pytorch_msssim dependency used for per-image evaluation
(single_id_coach.py:87-106). Standard Wang et al. formulation: 11-tap
Gaussian window (sigma 1.5), five-scale MS-SSIM with the canonical
weights.

The variance terms are small differences of O(1) moments, so ``tgi``
forces exact fp32 convolutions (``Precision.HIGHEST``): the TPU's
default bf16 passes pushed the bounded-by-1 ratios past 1. Here the
separable window is applied as eleven shifted multiply-adds per axis,
plain fp32 arithmetic on every device whatever the caller's TF32
setting (a convolution would follow ``torch.backends.cudnn.allow_tf32``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_window(size=11, sigma=1.5):
    x = np.arange(size, dtype=np.float32) - (size - 1) / 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _filter2d_sep(x, w):
    """'VALID' separable filtering of [N, C, H, W] by the 1-D window
    ``w``, along W then H."""
    k = len(w)
    w = [float(v) for v in w]
    W = x.shape[3] - k + 1
    x = sum(w[i] * x[:, :, :, i:i + W] for i in range(k))
    H = x.shape[2] - k + 1
    return sum(w[i] * x[:, :, i:i + H, :] for i in range(k))


def _ssim_components(a, b, data_range=1.0, win_size=11, sigma=1.5):
    w = _gaussian_window(win_size, sigma)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _filter2d_sep(a, w)
    mu_b = _filter2d_sep(b, w)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sa = _filter2d_sep(a * a, w) - mu_aa
    sb = _filter2d_sep(b * b, w) - mu_bb
    sab = _filter2d_sep(a * b, w) - mu_ab
    cs = (2 * sab + c2) / (sa + sb + c2)
    ssim_map = ((2 * mu_ab + c1) / (mu_aa + mu_bb + c1)) * cs
    return ssim_map.mean(dim=(1, 2, 3)), cs.mean(dim=(1, 2, 3))


def ssim(a, b, data_range=1.0):
    """Per-item SSIM for [N, C, H, W] images."""
    s, _ = _ssim_components(a.float(), b.float(), data_range)
    return s


def ms_ssim(a, b, data_range=1.0, weights=MSSSIM_WEIGHTS):
    """Multi-scale SSIM for [N, C, H, W].

    The canonical 5 scales need H, W >= 176 (11-tap window at scale 16);
    smaller inputs drop the coarsest scales (renormalized weights)
    instead of producing NaN."""
    a, b = a.float(), b.float()
    max_levels = 1
    side = min(a.shape[2], a.shape[3])
    while max_levels < len(weights) and side // (2 ** max_levels) >= 11:
        max_levels += 1
    if max_levels < len(weights):
        w = np.asarray(weights[:max_levels])
        weights = tuple(w / w.sum())
    levels = len(weights)
    vals = []
    for i in range(levels):
        s, cs = _ssim_components(a, b, data_range)
        vals.append(s if i == levels - 1 else cs)
        if i < levels - 1:
            a, b = F.avg_pool2d(a, 2), F.avg_pool2d(b, 2)
    vals = torch.stack(vals)                      # [L, N]
    w = torch.tensor(weights, dtype=torch.float32,
                     device=vals.device)[:, None]
    return torch.prod(torch.clamp(vals, min=1e-6) ** w, dim=0)
