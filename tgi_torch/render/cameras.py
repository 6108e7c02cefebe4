"""Look-at camera poses and intrinsics (twin of the pose and intrinsics
part of ``tgi/render/cameras.py``; parity target utils/camera_utils.py).

Computed in float32 on ``device``, as the JAX package does.
"""

from __future__ import annotations

import math

import torch

from tgi_torch.render.maths import normalize_vecs


def create_cam2world_matrix(forward_vector, origin):
    """OpenCV-convention cam2world from a forward direction + origin
    (camera_utils.py:137-155)."""
    forward_vector = normalize_vecs(forward_vector)
    up_vector = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32,
                             device=forward_vector.device
                             ).expand_as(forward_vector)
    right_vector = -normalize_vecs(
        torch.linalg.cross(up_vector, forward_vector, dim=-1))
    up_vector = normalize_vecs(
        torch.linalg.cross(forward_vector, right_vector, dim=-1))

    rotation = torch.stack([right_vector, up_vector, forward_vector], dim=-1)
    batch = forward_vector.shape[:-1]
    cam2world = torch.zeros(batch + (4, 4), dtype=torch.float32,
                            device=forward_vector.device)
    cam2world[..., :3, :3] = rotation
    cam2world[..., :3, 3] = origin
    cam2world[..., 3, 3] = 1.0
    return cam2world


def look_at_pose(h, v, lookat_position, radius=1.0, device="cuda"):
    """LookAtPoseSampler.sample with explicit angles (camera_utils.py:77-105).

    h, v: float or [N] camera yaw/pitch (radians, v in [0, pi]).
    lookat_position: [..., 3]. Returns [..., 4, 4] cam2world.
    """
    f32 = dict(dtype=torch.float32, device=device)
    theta = torch.as_tensor(h, **f32)
    phi = torch.clamp(torch.as_tensor(v, **f32), 1e-5, math.pi - 1e-5)
    x = radius * torch.sin(phi) * torch.cos(math.pi - theta)
    z = radius * torch.sin(phi) * torch.sin(math.pi - theta)
    y = radius * torch.cos(phi)
    origin = torch.stack([x, y, z], dim=-1)
    forward = normalize_vecs(torch.as_tensor(lookat_position, **f32) - origin)
    return create_cam2world_matrix(forward, origin)


def fov_to_intrinsics(fov_degrees, device="cuda"):
    """Normalized intrinsics from a field of view (camera_utils.py:190-198)."""
    fov = torch.as_tensor(fov_degrees, dtype=torch.float32)
    focal = float(1 / (2 * torch.tan(torch.deg2rad(fov) / 2) + 1e-9))
    return torch.tensor([[focal, 0., 0.5], [0., focal, 0.5], [0., 0., 1.]],
                        dtype=torch.float32, device=device)


def pack_camera(cam2world, intrinsics):
    """25-dim conditioning vector: flat cam2world (16) + intrinsics (9)."""
    n = cam2world.shape[0]
    return torch.cat([cam2world.reshape(n, 16),
                      intrinsics.reshape(-1, 9).expand(n, 9)], dim=-1)
