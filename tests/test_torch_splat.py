"""The backward of tgi_torch's tri-plane sampling against tgi's, on the CPU.

``sample_triplanes`` is one ``torch.autograd.Function`` whose CPU
backward is ``triplane_splat_plain``, the plain version the CUDA splat
kernel is held against on the card. Its gradients (``d_planes`` and
``d_coords``) are compared with

* ``jax.vjp`` of ``tgi.ops.grid_sample.sample_triplanes`` on the CPU
  (autodiff of ``_grid_sample_points_impl``): the same fp32 formula, sums
  taken in another order;
* tgi's TPU route ``_gsp_tpu_for`` with its Pallas splat kernel
  ``plane_splat_pack`` in interpret mode, at C = 32 (bf16 payload, so
  2e-2 on ``d_planes``). ``plane_splat``, the route of other channel
  counts, is held in ``test_torch_splat_rmw.py``: its serial interpret
  loop takes ~40 s on one core.

Tolerances are relative to the largest magnitude of the reference:
``max|got - want| <= tol * max(1, max|want|)``. ``d_coords`` carries the
factor W/2 · 2/box_warp and a sum over C, so its values reach the
hundreds; ``d_planes`` sums a few points per cell and stays O(1).
"""

import pytest
import torch

import jax
import jax.numpy as jnp

from tgi.ops import grid_sample as jgs
from tgi_torch.ops import grid_sample as gs

from torch_helpers import (TOL, close, port_splat_grads, splat_inputs,
                           tpu_route_grads)

SHAPES = [
    (1, 32, 32, 32, 515, 0.9),
    (1, 16, 16, 24, 1037, 1.0),
    (2, 16, 9, 7, 77, 2.0),
    (1, 8, 32, 32, 300, 1.0),
    # C = 6: the kernel's scalar path on the card.
    (1, 6, 16, 16, 700, 1.0),
    # Ray order (M = rays x samples), as the renderer gives the points:
    # runs of samples that share a cell, which the kernel sums before its
    # atomics, and rays that leave the box.
    pytest.param(2, 32, 32, 32, (8, 8, 16), 1.0, id="rays-2-32-32-32-8x8x16"),
]


@pytest.mark.parametrize("N,C,H,W,M,box_warp", SHAPES)
def test_grads_match_jax_autodiff(N, C, H, W, M, box_warp):
    planes, coords, g = splat_inputs(0, N, C, H, W, M, box_warp)
    want_p, want_c = jax.jit(lambda p, c, g: jax.vjp(
        lambda p, c: jgs.sample_triplanes(p, c, box_warp), p, c)[1](g))(
            jnp.asarray(planes), jnp.asarray(coords), jnp.asarray(g))
    got_p, got_c = port_splat_grads(planes, coords, g, box_warp)
    close(got_p, want_p, TOL)
    close(got_c, want_c, TOL)


def test_grads_match_tgi_plane_splat_pack_interpret():
    """tgi's TPU route at C = 32 on 32x32 planes runs ``plane_splat_pack``
    (bf16 payload: 2e-2 on d_planes); the point count is ragged for its
    512-entry blocks."""
    got, want = tpu_route_grads(32, 1037)
    close(got[0], want[0], 2e-2)
    # d_coords comes from the fp32 corners in both routes.
    close(got[1], want[1], TOL)


@pytest.mark.parametrize("N,C,H,W,M,box_warp", SHAPES[1:3])
@pytest.mark.parametrize("need_coords", [True, False])
def test_splat_plain_matches_torch_autograd(N, C, H, W, M, box_warp,
                                            need_coords):
    """The explicit plain backward against torch's own autograd of the
    plain forward."""
    planes, coords, g = splat_inputs(2, N, C, H, W, M, box_warp)
    p = torch.from_numpy(planes).requires_grad_(True)
    c = torch.from_numpy(coords).requires_grad_(True)
    gs.sample_triplanes_plain(p, c, box_warp).backward(torch.from_numpy(g))
    planes_cl = torch.from_numpy(planes).permute(0, 1, 3, 4, 2).contiguous()
    d_planes, d_coords = gs.triplane_splat_plain(
        planes_cl, torch.from_numpy(coords), torch.from_numpy(g), box_warp,
        need_coords)
    close(d_planes.permute(0, 1, 4, 2, 3), p.grad.numpy(), TOL)
    if need_coords:
        close(d_coords, c.grad.numpy(), TOL)
    else:
        assert d_coords is None


def test_backward_skips_d_coords_when_not_needed(monkeypatch):
    """Points that need no gradient (the coach's case) ask the splat for
    d_planes only."""
    planes, coords, g = splat_inputs(3, 1, 8, 16, 16, 50, 1.0)
    asked = []
    real = gs.triplane_splat_plain

    def spy(*args):
        asked.append(args[-1])
        return real(*args)

    monkeypatch.setattr(gs, "triplane_splat_plain", spy)
    p = torch.from_numpy(planes).requires_grad_(True)
    gs.sample_triplanes(p, torch.from_numpy(coords), 1.0).backward(
        torch.from_numpy(g))
    assert asked == [False] and p.grad is not None


def test_cpu_backward_launches_nothing():
    planes, coords, g = splat_inputs(4, 1, 8, 16, 16, 50, 1.0)
    before = (gs.LAUNCHES, gs.SPLAT_LAUNCHES)
    port_splat_grads(planes, coords, g, 1.0)
    assert (gs.LAUNCHES, gs.SPLAT_LAUNCHES) == before


def test_output_has_grad_fn():
    """The fault this module's autograd Function repairs: the sampled
    features carry a gradient on every device path."""
    planes, coords, _ = splat_inputs(5, 1, 8, 16, 16, 50, 1.0)
    out = gs.sample_triplanes(torch.from_numpy(planes).requires_grad_(True),
                              torch.from_numpy(coords), 1.0)
    assert out.requires_grad
    assert type(out.grad_fn).__name__ == "TriplaneSampleBackward"


def test_splat_kernel_wrapper_raises_without_a_card():
    """The kernel wrapper never runs the plain version in its place."""
    planes, coords, g = splat_inputs(6, 1, 8, 16, 16, 50, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        gs.triplane_splat_cuda(
            torch.from_numpy(planes).permute(0, 1, 3, 4, 2),
            torch.from_numpy(coords), torch.from_numpy(g), 1.0, True)


def test_splat_rejects_bad_shapes():
    planes, coords, g = splat_inputs(7, 1, 8, 16, 16, 50, 1.0)
    planes_cl = torch.from_numpy(planes).permute(0, 1, 3, 4, 2)
    with pytest.raises(ValueError, match="g must be"):
        gs.triplane_splat_plain(planes_cl, torch.from_numpy(coords),
                                torch.from_numpy(g[:, :, :-1]), 1.0, True)


def test_both_kernel_sources_are_built():
    """Every kernel source is built and bound, the sorted splat's and the
    bench kernels' too."""
    from tgi_torch.ops import _native
    assert set(_native.SOURCES) == set(_native.ENTRY_POINTS) == {
        "triplane_gather.cu", "triplane_splat.cu", "triplane_splat_sorted.cu",
        "gather_rows.cu", "gather_tilewalk.cu", "splat_sched.cu"}
