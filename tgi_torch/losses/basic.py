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


def noise_regularization(noise_maps):
    """Sum the multi-scale penalty over a list/dict of [H, W] noise maps."""
    if isinstance(noise_maps, dict):
        noise_maps = list(noise_maps.values())
    return noise_regularization_per_image([n[None] for n in noise_maps])[0]


def normalize_noise(noise_map):
    """Re-project a noise map to zero mean / unit variance
    (w_projector.py:263-270)."""
    return normalize_noise_per_image(noise_map[None])[0]


def noise_regularization_per_image(noise_maps):
    """Multi-scale autocorrelation penalty (w_projector.py:222-239) of
    each image of stacked ``[B, H, W]`` maps (a list or dict of them),
    summed over the maps -> [B]: per pyramid level the squared mean
    correlation with the 1-pixel-shifted map, halving by 2x2 average
    pooling down to 8²."""
    if isinstance(noise_maps, dict):
        noise_maps = list(noise_maps.values())
    total = 0.0
    for n in noise_maps:
        x = n[:, None]
        while True:
            total = total + torch.mean(x * torch.roll(x, 1, dims=3),
                                       dim=(1, 2, 3)) ** 2
            total = total + torch.mean(x * torch.roll(x, 1, dims=2),
                                       dim=(1, 2, 3)) ** 2
            if x.shape[2] <= 8:
                break
            x = F.avg_pool2d(x, 2)
    return total


def normalize_noise_per_image(noise_maps):
    """:func:`normalize_noise` of each map of a ``[B, H, W]`` stack on its
    own: one mean and spread per image, never across images."""
    n = noise_maps - noise_maps.mean(dim=(1, 2), keepdim=True)
    return n * torch.rsqrt(torch.mean(torch.square(n), dim=(1, 2),
                                      keepdim=True) + 1e-12)
