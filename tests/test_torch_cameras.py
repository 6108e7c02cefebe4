"""tgi_torch's rotation parameterizations, stage 1's camera assembly and
``depth_to_world`` against tgi's, on the CPU: values, and gradients
against ``jax.vjp`` for a random cotangent (stage 1 differentiates
through the rotation into the pose net). Tolerance 1e-5 relative to the
largest magnitude (fp32, the same formulas)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tgi.invert import projector as jproj
from tgi.render import cameras as jcam
from tgi.render import rays as jrays
from tgi_torch.invert import projector as proj
from tgi_torch.render import cameras as cam
from tgi_torch.render import rays

from torch_helpers import TOL, close


def _vjp_pair(tfn, jfn, *inputs, seed=0):
    """(port output, port grads, tgi output, tgi grads) for one numpy
    input tuple and a random cotangent."""
    xs = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    out = tfn(*xs)
    ct = np.random.RandomState(seed).randn(*out.shape).astype(np.float32)
    out.backward(torch.from_numpy(ct))
    want, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in inputs))
    return out, [x.grad for x in xs], want, vjp(jnp.asarray(ct))


def _check(tfn, jfn, *inputs):
    out, grads, want, want_grads = _vjp_pair(tfn, jfn, *inputs)
    close(out, want, TOL)
    for g, w in zip(grads, want_grads):
        close(g, w, TOL)


def test_quaternion_to_rotmat():
    q = np.random.RandomState(1).randn(5, 4).astype(np.float32)
    _check(cam.quaternion_to_rotmat, jcam.quaternion_to_rotmat, q)


def test_rot6d_round_trip_and_grads():
    x = np.random.RandomState(2).randn(4, 6).astype(np.float32)
    _check(cam.rot6d_to_rotmat, jcam.rot6d_to_rotmat, x)
    R = cam.rot6d_to_rotmat(torch.from_numpy(x))
    close(cam.rotmat_to_rot6d(R), jcam.rotmat_to_rot6d(jnp.asarray(
        R.numpy())), TOL)
    # The +1e-4 guard moves a round trip by ~1e-4 in both packages.
    close(cam.rot6d_to_rotmat(cam.rotmat_to_rot6d(R)),
          jcam.rot6d_to_rotmat(jcam.rotmat_to_rot6d(jnp.asarray(R.numpy()))),
          TOL)


def test_euler_to_rotmat():
    rng = np.random.RandomState(3)
    theta = (np.pi / 2 + 0.4 * rng.randn(3)).astype(np.float32)
    phi = (np.pi / 2 + 0.3 * rng.randn(3)).astype(np.float32)
    _check(cam.euler_to_rotmat, jcam.euler_to_rotmat, theta, phi)


def test_rotmat_to_quat_every_branch():
    """Rotations whose largest Shepperd candidate is each of w, x, y, z
    (angles near 0 and near pi about each axis)."""
    rots = [np.array(jcam.axis_angle_rotmat(axis, angle))
            for axis, angle in (([0.3, 0.5, 0.8], 0.2),
                                ([1.0, 0.1, 0.0], 3.0),
                                ([0.1, 1.0, 0.2], 3.0),
                                ([0.0, 0.2, 1.0], 3.1))]
    R = np.stack(rots).astype(np.float32)
    got = cam.rotmat_to_quat(torch.from_numpy(R))
    close(got, jcam.rotmat_to_quat(jnp.asarray(R)), TOL)
    assert sorted(np.argmax(np.abs(got.numpy()), axis=1)) == [0, 1, 2, 3]
    close(cam.quaternion_to_rotmat(got), R, 1e-5)


@pytest.mark.parametrize("axis,angle", [([0.3, -0.5, 0.8], 0.7),
                                        ([1.0, 0.0, 0.0], -2.5)])
def test_axis_angle_rotmat(axis, angle):
    close(cam.axis_angle_rotmat(axis, angle),
          jcam.axis_angle_rotmat(axis, angle), TOL)


@pytest.mark.parametrize("mode,dims", [("quat", 4), ("6d", 6), ("2d", 2)])
def test_assemble_camera(mode, dims):
    """Stage 1's camera from the pose head's output and the translation,
    in all three camera modes: the extrinsics, the packed camera and
    their gradients to both inputs."""
    rng = np.random.RandomState(4)
    pose_out = np.tanh(rng.randn(1, dims)).astype(np.float32)
    if mode == "quat":
        pose_out[0, 0] += 1.5      # near the identity, as a trained head
    translation = (0.05 * rng.randn(1, 3)).astype(np.float32)
    intr = np.asarray(jproj.DEFAULT_INTRINSIC).reshape(9)

    def tfn(p, t):
        ext, c = proj.assemble_camera(p, t, mode, 2.7, torch.from_numpy(intr))
        return torch.cat([ext.reshape(1, 16), c], dim=1)

    def jfn(p, t):
        ext, c = jproj.assemble_camera(p, t, mode, 2.7, jnp.asarray(intr))
        return jnp.concatenate([ext.reshape(1, 16), c], axis=1)

    _check(tfn, jfn, pose_out, translation)


def test_depth_to_world():
    rng = np.random.RandomState(5)
    res = 8
    o = rng.randn(1, res * res, 3).astype(np.float32)
    d = rng.randn(1, res * res, 3).astype(np.float32)
    depth = (2.5 + 0.3 * rng.rand(1, res, res)).astype(np.float32)
    _check(rays.depth_to_world, jrays.depth_to_world, o, d, depth)
