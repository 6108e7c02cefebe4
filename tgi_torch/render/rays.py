"""Camera rays from cam2world + intrinsics, OpenCV conventions (twin of
``tgi/render/rays.py``; parity target
training/volumetric_rendering/ray_sampler.py)."""

from __future__ import annotations

import torch

from tgi_torch.render.maths import normalize_vecs


def ray_sampler(cam2world, intrinsics, resolution: int):
    """Lift pixel centers to world-space rays.

    Args:
        cam2world: [N, 4, 4].
        intrinsics: [N, 3, 3] normalized (fx, fy, cx, cy in [0, 1] units).
        resolution: image side; M = resolution**2 rays.

    Returns:
        (ray_origins [N, M, 3], ray_dirs [N, M, 3]).
    """
    N = cam2world.shape[0]
    M = resolution * resolution
    dev = cam2world.device
    cam_locs_world = cam2world[:, :3, 3]
    fx = intrinsics[:, 0, 0][:, None]
    fy = intrinsics[:, 1, 1][:, None]
    cx = intrinsics[:, 0, 2][:, None]
    cy = intrinsics[:, 1, 2][:, None]
    sk = intrinsics[:, 0, 1][:, None]

    # Pixel-center uv grid in [0,1]: an ij meshgrid flipped to (x, y), as
    # the reference builds it (ray_sampler.py:46-48).
    r = torch.arange(resolution, dtype=torch.float32, device=dev)
    ii, jj = torch.meshgrid(r, r, indexing="ij")
    uv = torch.stack([jj, ii], dim=0) * (1.0 / resolution) + (0.5 / resolution)
    uv = uv.reshape(2, -1).T[None].repeat(N, 1, 1)             # [N, M, 2]

    x_cam = uv[:, :, 0]
    y_cam = uv[:, :, 1]
    z_cam = torch.ones((N, M), dtype=torch.float32, device=dev)

    x_lift = (x_cam - cx + cy * sk / fy - sk * y_cam / fy) / fx * z_cam
    y_lift = (y_cam - cy) / fy * z_cam

    cam_rel_points = torch.stack(
        [x_lift, y_lift, z_cam, torch.ones_like(z_cam)], dim=-1)  # [N, M, 4]

    world_rel = torch.einsum("nij,nmj->nmi", cam2world,
                             cam_rel_points)[..., :3]
    ray_dirs = normalize_vecs(world_rel - cam_locs_world[:, None, :])
    ray_origins = cam_locs_world[:, None, :].repeat(1, M, 1)
    return ray_origins, ray_dirs


def depth_to_world(ray_origins, ray_dirs, depth):
    """Back-project a depth map to homogeneous world points.

    ray_origins/ray_dirs: [1, res*res, 3]; depth: [1, res, res] (or
    [res, res], or [1, 1, res, res]). Returns [4, res*res]
    (ray_sampler.py:75-93).
    """
    res = depth.shape[-1]
    o = ray_origins.reshape(res * res, 3)
    d = ray_dirs.reshape(res * res, 3)
    z = depth.reshape(res * res, 1)
    xyz = o + d * z
    ones = torch.ones((res * res, 1), dtype=xyz.dtype, device=xyz.device)
    return torch.cat([xyz, ones], dim=-1).T
