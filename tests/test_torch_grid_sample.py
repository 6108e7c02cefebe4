"""tgi_torch tri-plane sampling against tgi's, on the CPU.

The port's plain version (what a CPU tensor takes, and what the CUDA
kernel is held against on the card) must give tgi's numbers: the same
fp32 formula, so the tolerance is 1e-5 abs. One case runs tgi's TPU
route itself, the Pallas ``gather_rows_vmem`` kernel in interpret mode.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tgi.ops import grid_sample as jgs
from tgi_torch.ops import grid_sample as gs

from torch_helpers import ray_coords

ATOL = 1e-5


def _border_coords(H, W, box_warp):
    """World points whose plane-0 (x, y) corners sit on the borders:
    x0 = -1, x0 = W-1, y0 = H-1, y0 = -1, and points outside the box."""
    def world(ix, iy):  # pixel coords -> world coords with z = 0
        u = (ix + 0.5) * 2.0 / W - 1.0
        v = (iy + 0.5) * 2.0 / H - 1.0
        return [u * box_warp / 2, v * box_warp / 2, 0.0]
    pts = [world(-0.3, 3.2), world(W - 1 + 0.4, 5.7), world(4.1, H - 1 + 0.6),
           world(2.5, -0.8), world(-0.5, -0.5), world(W - 0.5, H - 0.5),
           world(W + 3.0, 2.0), [2.0 * box_warp, -1.5 * box_warp, 0.7]]
    return np.asarray(pts, np.float32)


def _inputs(seed, N, C, H, W, M, box_warp):
    """An int M: points spanning beyond the box (zeros outside), plus
    border cases. M = (Ry, Rx, S): a ray-ordered frustum march."""
    rng = np.random.RandomState(seed)
    planes = rng.randn(N, 3, C, H, W).astype(np.float32)
    if isinstance(M, tuple):
        return planes, ray_coords(N, M, box_warp)
    coords = ((rng.rand(N, M, 3) * 1.4 - 0.7) * box_warp).astype(np.float32)
    b = _border_coords(H, W, box_warp)
    coords[:, :len(b)] = b
    return planes, coords


@pytest.mark.parametrize("N,C,H,W,M,box_warp", [
    (1, 8, 32, 32, 300, 1.0),
    (2, 4, 9, 7, 77, 2.0),
    (1, 16, 16, 24, 1037, 1.0),
    (1, 32, 32, 32, 515, 0.9),
    # C = 6: the kernel's scalar path on the card.
    (1, 6, 16, 24, 1037, 1.0),
    # Ray order, as the renderer gives the points: runs of samples that
    # share a cell (the splat kernel sums them before its atomics) and
    # rays that leave the box.
    pytest.param(2, 32, 32, 32, (8, 8, 16), 1.0, id="rays-2-32-32-32-8x8x16"),
])
def test_sample_triplanes_matches_tgi(N, C, H, W, M, box_warp):
    planes, coords = _inputs(0, N, C, H, W, M, box_warp)
    want = np.asarray(jgs.sample_triplanes(jnp.asarray(planes),
                                           jnp.asarray(coords), box_warp))
    got = gs.sample_triplanes(torch.from_numpy(planes),
                              torch.from_numpy(coords), box_warp)
    assert got.shape == (N, 3, coords.shape[1], C)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_border_points_hit_every_case():
    """The border inputs really produce x0=-1, x0=W-1, y0=H-1 and points
    outside the plane, so the parity cases above cover them."""
    H, W = 32, 32
    b = torch.from_numpy(_border_coords(H, W, 1.0))
    proj = gs.project_onto_planes(2.0 * b[None])[0, 0]
    x0, y0, _, _ = gs._point_indices(proj, H, W)
    assert {-1, W - 1} <= set(x0.tolist())
    assert {-1, H - 1} <= set(y0.tolist())
    assert (x0 > W).any()


def test_matches_tgi_tpu_route_interpret():
    """tgi's TPU route — footprint expansion, the Pallas gather_rows_vmem
    kernel (interpret mode), border slot remap, lerp — against the port's
    plain version, at C = 32 with a ragged point count (not a multiple of
    the kernel's 512-point block)."""
    N, C, H, W, M, box_warp = 1, 32, 32, 32, 1037, 1.0
    planes, coords = _inputs(1, N, C, H, W, M, box_warp)
    proj = jgs.project_onto_planes((2.0 / box_warp) * jnp.asarray(coords))
    with pltpu.force_tpu_interpret_mode():
        want = jgs._gsp_tpu_for(None)(
            jnp.asarray(planes).reshape(N * 3, C, H, W),
            proj.reshape(N * 3, M, 2))
    want = np.asarray(want).reshape(N, 3, M, C)
    got = gs.sample_triplanes_plain(torch.from_numpy(planes),
                                    torch.from_numpy(coords), box_warp)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_project_onto_planes_matches_tgi():
    rng = np.random.RandomState(2)
    coords = rng.randn(2, 11, 3).astype(np.float32)
    want = np.asarray(jgs.project_onto_planes(jnp.asarray(coords)))
    got = gs.project_onto_planes(torch.from_numpy(coords)).numpy()
    np.testing.assert_array_equal(got, want)


def test_grid_sample_points_matches_torch_grid_sample():
    rng = np.random.RandomState(3)
    img = torch.from_numpy(rng.randn(2, 5, 9, 7).astype(np.float32))
    pts = torch.from_numpy(rng.rand(2, 24, 2).astype(np.float32) * 2.6 - 1.3)
    want = torch.nn.functional.grid_sample(
        img, pts[:, None], mode="bilinear", padding_mode="zeros",
        align_corners=False)[:, :, 0].transpose(1, 2)
    got = gs.grid_sample_points(img, pts)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)


def test_channels_last_keeps_values_and_changes_layout():
    planes = torch.randn(1, 3, 4, 5, 6)
    cl = gs.channels_last(planes)
    assert torch.equal(cl, planes)
    assert cl.permute(0, 1, 3, 4, 2).is_contiguous()


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    planes, coords = _inputs(4, 1, 8, 16, 16, 50, 1.0)
    before = gs.LAUNCHES
    got = gs.sample_triplanes(torch.from_numpy(planes),
                              torch.from_numpy(coords), 1.0)
    want = gs.sample_triplanes_plain(torch.from_numpy(planes),
                                     torch.from_numpy(coords), 1.0)
    assert torch.equal(got, want)
    assert gs.LAUNCHES == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never runs the plain version in its place."""
    planes, coords = _inputs(5, 1, 8, 16, 16, 50, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        gs.sample_triplanes_cuda(torch.from_numpy(planes),
                                 torch.from_numpy(coords), 1.0)


def test_unsupported_device_raises():
    planes = torch.zeros(1, 3, 2, 4, 4, device="meta")
    coords = torch.zeros(1, 5, 3, device="meta")
    with pytest.raises(ValueError, match="no tri-plane sampler"):
        gs.sample_triplanes(planes, coords, 1.0)


def test_kernel_build_raises_without_nvcc(tmp_path, monkeypatch):
    """No compiler: the build raises instead of leaving a library out."""
    from tgi_torch.ops import _native
    monkeypatch.setattr(_native.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _native.build_all()
    # Library names carry a hash of the source and flags.
    name = os.path.basename(_native._target("triplane_gather.cu"))
    assert name.startswith("libtriplane_gather-") and name.endswith(".so")
