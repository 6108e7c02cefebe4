"""Ray/box math for the volumetric renderer (twin of ``tgi/render/maths.py``;
parity target training/volumetric_rendering/math_utils.py)."""

from __future__ import annotations

import torch


def normalize_vecs(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def get_ray_limits_box(rays_o, rays_d, box_side_length):
    """Slab-method intersection of rays with the centered cube.

    rays_o, rays_d: [..., 3]. Returns (t_min, t_max) each [..., 1];
    non-intersecting rays get (-1, -2), matching math_utils.py:46-98.
    """
    half = box_side_length / 2
    invdir = 1.0 / rays_d
    t_lo = (-half - rays_o) * invdir
    t_hi = (half - rays_o) * invdir
    t_near = torch.minimum(t_lo, t_hi)
    t_far = torch.maximum(t_lo, t_hi)

    tmin_xy = torch.maximum(t_near[..., 0], t_near[..., 1])
    tmax_xy = torch.minimum(t_far[..., 0], t_far[..., 1])
    is_valid = ~(t_near[..., 0] > t_far[..., 1]) & ~(t_near[..., 1] > t_far[..., 0])

    tmin = torch.maximum(tmin_xy, t_near[..., 2])
    tmax = torch.minimum(tmax_xy, t_far[..., 2])
    is_valid &= ~(tmin_xy > t_far[..., 2]) & ~(t_near[..., 2] > tmax_xy)

    tmin = torch.where(is_valid, tmin, torch.full_like(tmin, -1.0))
    tmax = torch.where(is_valid, tmax, torch.full_like(tmax, -2.0))
    return tmin[..., None], tmax[..., None]


def linspace_batch(start, stop, num):
    """[num, *start.shape] evenly spaced start..stop inclusive
    (math_utils.py:101-118)."""
    steps = torch.arange(num, dtype=torch.float32,
                         device=start.device) / (num - 1)
    steps = steps.reshape((num,) + (1,) * start.ndim)
    return start[None] + steps * (stop - start)[None]
