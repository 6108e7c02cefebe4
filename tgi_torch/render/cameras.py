"""Look-at camera poses, intrinsics and the rotation parameterizations of
the pose estimator (twin of ``tgi/render/cameras.py``; parity target
utils/camera_utils.py).

Computed in float32 on ``device``, as the JAX package does. The random
pose samplers (``gaussian_camera_pose``, ``uniform_camera_pose``) draw
from a ``torch.Generator`` or a draw source (``utils/draws.py``) split as
``tgi`` splits its key, so a test can hand them ``tgi``'s draws.
"""

from __future__ import annotations

import math

import torch

from tgi_torch.render.maths import normalize_vecs
from tgi_torch.utils.draws import as_draws


def _cam_origin(h_mean, v_mean, radius, h=None, v=None, device="cuda"):
    """Spherical camera location; (h, v) optional offsets from the means
    (tensors, whose device wins over ``device``)."""
    f32 = dict(dtype=torch.float32, device=device)
    theta = torch.as_tensor(h_mean if h is None else h, **f32)
    phi = torch.as_tensor(v_mean if v is None else v, **f32)
    phi = torch.clamp(phi, 1e-5, math.pi - 1e-5)
    x = radius * torch.sin(phi) * torch.cos(math.pi - theta)
    z = radius * torch.sin(phi) * torch.sin(math.pi - theta)
    y = radius * torch.cos(phi)
    return torch.stack([x, y, z], dim=-1)


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
    origin = _cam_origin(h, v, radius, device=device)
    forward = normalize_vecs(torch.as_tensor(
        lookat_position, dtype=torch.float32, device=device) - origin)
    return create_cam2world_matrix(forward, origin)


def gaussian_camera_pose(rng, h_mean, v_mean, h_stddev=0., v_stddev=0.,
                         radius=1.0, batch_size=1, device="cuda"):
    """GaussianCameraPoseSampler.sample (camera_utils.py:23-55):
    [batch_size, 4, 4] cam2world looking at the origin, yaw and pitch
    normal about their means. ``rng``: a ``torch.Generator`` (its draws
    placed on ``device``) or a draw source."""
    kh, kv = as_draws(rng, device).split(2)
    h = kh.normal((batch_size, 1)) * h_stddev + h_mean
    v = kv.normal((batch_size, 1)) * v_stddev + v_mean
    origin = _cam_origin(None, None, radius, h=h[:, 0], v=v[:, 0],
                         device=device)
    return create_cam2world_matrix(normalize_vecs(-origin), origin)


def uniform_camera_pose(rng, h_mean, v_mean, h_stddev=0., v_stddev=0.,
                        radius=1.0, batch_size=1, device="cuda"):
    """UniformCameraPoseSampler.sample (camera_utils.py:107-134): yaw and
    pitch uniform in ``mean ± stddev``; ``rng`` as for
    :func:`gaussian_camera_pose`."""
    kh, kv = as_draws(rng, device).split(2)
    h = (kh.uniform((batch_size, 1)) * 2 - 1) * h_stddev + h_mean
    v = (kv.uniform((batch_size, 1)) * 2 - 1) * v_stddev + v_mean
    origin = _cam_origin(None, None, radius, h=h[:, 0], v=v[:, 0],
                         device=device)
    return create_cam2world_matrix(normalize_vecs(-origin), origin)


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


# ---------------------------------------------------------------------------
# Rotation parameterizations for the pose estimator (camera_utils.py:201-283)


def quaternion_to_rotmat(quat):
    """[N, 4] (w, x, y, z) -> [N, 3, 3]; normalizes input
    (camera_utils.py:201-228)."""
    quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w, x, y, z = quat[:, 0], quat[:, 1], quat[:, 2], quat[:, 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    mat = torch.stack([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ], dim=-1)
    return mat.reshape(quat.shape[0], 3, 3)


def rotmat_to_quat(R):
    """[N, 3, 3] -> [N, 4] unit quaternion (w, x, y, z); inverse of
    :func:`quaternion_to_rotmat` up to sign (w >= 0 chosen).

    Branchless Shepperd: the four squared-component candidates
    ``1+tr``, ``1+m00-m11-m22``, ... sum to 4, so the largest is at
    least 1 and its square root is numerically safe.
    """
    m00, m01, m02 = R[:, 0, 0], R[:, 0, 1], R[:, 0, 2]
    m10, m11, m12 = R[:, 1, 0], R[:, 1, 1], R[:, 1, 2]
    m20, m21, m22 = R[:, 2, 0], R[:, 2, 1], R[:, 2, 2]
    cand = torch.stack([1.0 + m00 + m11 + m22,       # 4w^2
                        1.0 + m00 - m11 - m22,       # 4x^2
                        1.0 - m00 + m11 - m22,       # 4y^2
                        1.0 - m00 - m11 + m22],      # 4z^2
                       dim=-1)
    s = 2.0 * torch.sqrt(torch.clamp(cand, min=1e-12))  # [N, 4] = 4|q_i|
    q_w = torch.stack([s[:, 0] / 4, (m21 - m12) / s[:, 0],
                       (m02 - m20) / s[:, 0], (m10 - m01) / s[:, 0]], -1)
    q_x = torch.stack([(m21 - m12) / s[:, 1], s[:, 1] / 4,
                       (m01 + m10) / s[:, 1], (m02 + m20) / s[:, 1]], -1)
    q_y = torch.stack([(m02 - m20) / s[:, 2], (m01 + m10) / s[:, 2],
                       s[:, 2] / 4, (m12 + m21) / s[:, 2]], -1)
    q_z = torch.stack([(m10 - m01) / s[:, 3], (m02 + m20) / s[:, 3],
                       (m12 + m21) / s[:, 3], s[:, 3] / 4], -1)
    qs = torch.stack([q_w, q_x, q_y, q_z], dim=1)    # [N, 4, 4]
    idx = torch.argmax(cand, dim=-1)
    q = qs[torch.arange(qs.shape[0], device=qs.device), idx]
    q = q * torch.where(q[:, :1] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def axis_angle_rotmat(axis, angle):
    """Rodrigues: unit ``axis`` [3], ``angle`` rad -> [3, 3]."""
    axis = torch.as_tensor(axis, dtype=torch.float32)
    axis = axis / torch.linalg.norm(axis)
    kx, ky, kz = axis.unbind()
    zero = torch.zeros((), dtype=torch.float32, device=axis.device)
    K = torch.stack([torch.stack([zero, -kz, ky]),
                     torch.stack([kz, zero, -kx]),
                     torch.stack([-ky, kx, zero])])
    angle = torch.as_tensor(angle, dtype=torch.float32, device=axis.device)
    return (torch.eye(3, device=axis.device) + torch.sin(angle) * K
            + (1.0 - torch.cos(angle)) * (K @ K))


def euler_to_rotmat(theta, phi, radius=2.7):
    """Camera-on-sphere rotation from (yaw, pitch), as the reference's
    euler2rot builds it (camera_utils.py:241-257): place the camera at the
    spherical position, look at the origin; return the cam2world rotation.
    """
    theta = torch.atleast_1d(torch.as_tensor(theta, dtype=torch.float32))
    phi = torch.atleast_1d(torch.as_tensor(phi, dtype=torch.float32))
    origins = torch.stack([
        radius * torch.sin(phi) * torch.cos(math.pi - theta),
        radius * torch.cos(phi),
        radius * torch.sin(phi) * torch.sin(math.pi - theta)], dim=-1)
    forward = normalize_vecs(-origins)
    return create_cam2world_matrix(forward, origins)[:, :3, :3]


def rot6d_to_rotmat(x):
    """Zhou et al. 6D -> rotation matrix (camera_utils.py:259-273);
    keeps the reference's +1e-4 degeneracy guard."""
    x = x + 1e-4
    a1 = x[:, 0:3]
    a2 = x[:, 3:6]
    b1 = normalize_vecs(a1)
    b2 = normalize_vecs(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rotmat_to_rot6d(R):
    """Inverse map: first two columns flattened (camera_utils.py:275-283)."""
    return R[..., :2].transpose(-1, -2).reshape(R.shape[:-2] + (6,))
