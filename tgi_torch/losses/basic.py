"""Elementary losses and regularizers (twin of ``tgi/losses/basic.py``).

Parity targets: criteria/l2_loss.py:6, base_coach.py:294-305 (depth TV),
w_projector.py:220-239 (multi-scale noise regularization).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l2_loss(a, b):
    return torch.mean(torch.square(a - b))


def depth_tv_loss(depth):
    """Total variation on the rendered depth map [N, 1, H, W]
    (base_coach.py:294-305)."""
    dh = (depth[..., 1:, :] - depth[..., :-1, :]).abs().mean()
    dw = (depth[..., :, 1:] - depth[..., :, :-1]).abs().mean()
    return dh + dw


def _noise_reg_single(noise):
    """Multi-scale autocorrelation penalty for one [H, W] noise map
    (w_projector.py:222-239): sum over pyramid levels of squared mean
    correlation with the 1-pixel-shifted map, halving via 2x2 avg pool."""
    x = noise[None, None]
    reg = 0.0
    while True:
        reg = reg + torch.mean(x * torch.roll(x, 1, dims=3)) ** 2
        reg = reg + torch.mean(x * torch.roll(x, 1, dims=2)) ** 2
        if x.shape[2] <= 8:
            break
        x = F.avg_pool2d(x, 2)
    return reg


def noise_regularization(noise_maps):
    """Sum the multi-scale penalty over a list/dict of [H, W] noise maps."""
    if isinstance(noise_maps, dict):
        noise_maps = list(noise_maps.values())
    total = 0.0
    for n in noise_maps:
        total = total + _noise_reg_single(n)
    return total


def normalize_noise(noise_map):
    """Re-project a noise map to zero mean / unit variance
    (w_projector.py:263-270)."""
    n = noise_map - noise_map.mean()
    return n * torch.rsqrt(torch.mean(torch.square(n)) + 1e-12)
