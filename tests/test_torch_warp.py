"""Stage 1's warping loss and its parts against tgi's, on the CPU:
``grid_sample_2d`` (values, and the gradients to the image and to the
grid against ``jax.vjp``), the antialiased shrink of
``bilinear_resize_nchw`` against ``jax.image.resize``, and
``calc_warping_loss`` with an identity and a 128 -> 64 resize of its uv
grid, with a small VGG (``width_mult`` 1/8).

Tolerances: 1e-5 per op, relative to the largest magnitude (max(1, .)
as ``close`` takes it); the loss and its gradients 1e-4 relative to the
largest value (a VGG, a warp and a mean summed in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tgi.invert import projector as jproj
from tgi.losses import warp as jwarp
from tgi.models import vgg as jvgg
from tgi.ops import grid_sample as jgs
from tgi.render import cameras as jcam
from tgi_torch.losses import warp
from tgi_torch.models import vgg
from tgi_torch.ops import grid_sample as gs

from torch_helpers import TOL, close, jit_ref


def _rel(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err


def _grid(rng, N, Hg, Wg):
    """Grid points inside, on the border of, and outside [-1, 1]."""
    g = (rng.rand(N, Hg, Wg, 2) * 2.4 - 1.2).astype(np.float32)
    g[:, 0, :4] = [[-1.0, -1.0], [1.0, 1.0], [-1.02, 0.3], [0.999, -0.999]]
    return g


@pytest.mark.parametrize("N,C,H,W,Hg,Wg", [(1, 3, 16, 16, 9, 11),
                                           (2, 24, 8, 12, 8, 8),
                                           (1, 256, 8, 8, 8, 8)])
def test_grid_sample_2d_values_and_grads(N, C, H, W, Hg, Wg):
    rng = np.random.RandomState(C)
    img = rng.randn(N, C, H, W).astype(np.float32)
    grid = _grid(rng, N, Hg, Wg)
    ct = rng.randn(N, C, Hg, Wg).astype(np.float32)
    ti = torch.from_numpy(img).requires_grad_(True)
    tg = torch.from_numpy(grid).requires_grad_(True)
    out = gs.grid_sample_2d(ti, tg)
    out.backward(torch.from_numpy(ct))
    want, vjp = jax.vjp(jgs.grid_sample_2d, jnp.asarray(img),
                        jnp.asarray(grid))
    d_img, d_grid = vjp(jnp.asarray(ct))
    close(out, want, TOL)
    close(ti.grad, d_img, TOL)
    close(tg.grad, d_grid, TOL)
    # torch's own grid_sample computes the same function.
    close(out, torch.nn.functional.grid_sample(
        torch.from_numpy(img), torch.from_numpy(grid), mode="bilinear",
        padding_mode="zeros", align_corners=False).numpy(), TOL)


@pytest.mark.parametrize("h,w,out", [(128, 128, 64), (64, 64, 16),
                                     (48, 48, 20), (30, 30, 12),
                                     (48, 32, 16), (16, 16, 64),
                                     (20, 20, 20)])
def test_bilinear_resize_matches_jax(h, w, out):
    """Shrinks by 2, by 4, by factors that are not integers and by a
    different factor per axis, an enlargement and the identity, with the
    gradient."""
    rng = np.random.RandomState(h + w + out)
    x = rng.randn(2, 3, h, w).astype(np.float32)
    ct = rng.randn(2, 3, out, out).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = warp.bilinear_resize_nchw(tx, out)
    got.backward(torch.from_numpy(ct))
    want, vjp = jax.vjp(lambda a: jwarp.bilinear_resize_nchw(a, out),
                        jnp.asarray(x))
    close(got, want, 1e-6)
    close(tx.grad, vjp(jnp.asarray(ct))[0], TOL)


def test_line_plane_collision():
    rng = np.random.RandomState(7)
    args = [rng.randn(10, 3).astype(np.float32) for _ in range(4)]
    close(warp.line_plane_collision(*map(torch.from_numpy, args)),
          jwarp.line_plane_collision(*map(jnp.asarray, args)), 1e-4)


@pytest.fixture(scope="module")
def vgg_weights():
    gen = torch.Generator().manual_seed(11)
    params = vgg.vgg16_init(gen, "cpu", width_mult=0.125)
    return params, jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)


def _warp_inputs(seed, canon_res, depth_res, target_res):
    """A canonical image as smooth as a render (random 16² detail,
    enlarged): on white noise the image's slope, up to ~1.5 per pixel,
    magnifies the 1-ulp differences of the two packages' ray directions
    to ~1e-4 of the warped image."""
    rng = np.random.RandomState(seed)
    coarse = torch.from_numpy(np.tanh(rng.randn(1, 3, 16, 16)).astype(
        np.float32))
    canon = warp.bilinear_resize_nchw(coarse, canon_res).numpy()
    target = np.tanh(rng.randn(1, 3, target_res, target_res)).astype(
        np.float32)
    yy, xx = np.mgrid[:depth_res, :depth_res] / depth_res - 0.5
    depth = (2.6 + 0.3 * (xx ** 2 + yy ** 2)
             + 0.02 * rng.randn(depth_res, depth_res)).astype(np.float32)
    pose = jcam.look_at_pose(np.pi / 2 + 0.2, np.pi / 2 - 0.1,
                             jnp.zeros(3), radius=2.7)
    return (canon, np.asarray(pose)[None].astype(np.float32),
            depth[None, None], target)


@pytest.mark.parametrize("canon_res,depth_res,target_res", [
    (64, 16, 64),       # uv grid 16 -> features 16: the identity
    (256, 128, 256),    # 128 -> 64: the projector without target_full
    (512, 32, 64),      # canonical image area-shrunk to 256; 32 -> 16
])
def test_calc_warping_loss(vgg_weights, canon_res, depth_res, target_res):
    """The loss, the warped image and the gradients to the canonical
    image, the predicted extrinsics and the depth."""
    tp, jp = vgg_weights
    canon, ext, depth, target = _warp_inputs(canon_res, canon_res,
                                             depth_res, target_res)
    init_ext = np.asarray(jproj.CANONICAL_EXTRINSIC)[None]
    intr = np.asarray(jproj.DEFAULT_INTRINSIC)[None]

    def jfn(c, e, d):
        return jwarp.calc_warping_loss(
            c, lambda x: jvgg.warping_features(jp, x), e,
            jnp.asarray(init_ext), jnp.asarray(intr), d, jnp.asarray(target))

    def value_and_grads(c, e, d):
        (loss, img), vjp = jax.vjp(jfn, c, e, d)
        return loss, img, vjp((jnp.ones(()), jnp.zeros_like(img)))

    want, want_img, want_grads = jit_ref(value_and_grads)(
        jnp.asarray(canon), jnp.asarray(ext), jnp.asarray(depth))

    xs = [torch.from_numpy(a).requires_grad_(True) for a in (canon, ext,
                                                             depth)]
    loss, img = warp.calc_warping_loss(
        xs[0], lambda x: vgg.warping_features(tp, x), xs[1],
        torch.from_numpy(init_ext), torch.from_numpy(intr), xs[2],
        torch.from_numpy(target))
    loss.backward()
    _rel(loss, want, 1e-4)
    # The warped image ends a chain (rays, surface points, the plane
    # intersection, the projection) whose 1-ulp differences the image's
    # slope magnifies: it is held like the loss.
    _rel(img, want_img, 1e-4)
    for x, w in zip(xs, want_grads):
        assert np.abs(np.asarray(w)).max() > 0
        _rel(x.grad, w, 1e-4)
