"""Mip-style volume rendering over sample midpoints (twin of
``tgi/render/march.py``; parity target
training/volumetric_rendering/ray_marcher.py:20-63)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def composite_depth(weights, depths_mid, all_depths):
    """Weighted mean depth, nan-safe, clipped to the depth range of the
    whole batch (ray_marcher.py:51-53)."""
    depth = (weights * depths_mid).sum(dim=-2) / weights.sum(dim=2)
    depth = torch.nan_to_num(depth, nan=math.inf, posinf=math.inf)
    return torch.clamp(depth, all_depths.min(), all_depths.max())


def transmittance_weights(densities_mid, deltas):
    """alpha * cumulative transmittance along the sample axis (-2)."""
    alpha = 1 - torch.exp(-densities_mid * deltas)
    alpha_shifted = torch.cat(
        [torch.ones_like(alpha[:, :, :1]), 1 - alpha + 1e-10], dim=-2)
    return alpha * torch.cumprod(alpha_shifted, dim=-2)[:, :, :-1]


def mip_ray_marcher(colors, densities, depths, *, clamp_mode="softplus",
                    white_back=False):
    """colors [N,R,S,C], densities [N,R,S,1], depths [N,R,S,1].

    Returns (composite_rgb [N,R,C], composite_depth [N,R,1],
    weights [N,R,S-1,1]).
    """
    assert clamp_mode == "softplus", "only softplus density supported"
    deltas = depths[:, :, 1:] - depths[:, :, :-1]
    colors_mid = (colors[:, :, :-1] + colors[:, :, 1:]) / 2
    densities_mid = (densities[:, :, :-1] + densities[:, :, 1:]) / 2
    depths_mid = (depths[:, :, :-1] + depths[:, :, 1:]) / 2

    # The -1 bias makes the density init well-behaved (ray_marcher.py:33).
    weights = transmittance_weights(F.softplus(densities_mid - 1), deltas)
    composite_rgb = (weights * colors_mid).sum(dim=-2)
    depth = composite_depth(weights, depths_mid, depths)
    if white_back:
        composite_rgb = composite_rgb + 1 - weights.sum(dim=2)
    return composite_rgb * 2 - 1, depth, weights
