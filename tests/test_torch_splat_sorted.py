"""The sorted, deterministic splat (tgi's ``TGI_SPLAT=mxu`` route) of
tgi_torch's tri-plane sampling, on the CPU.

``triplane_splat_sorted_plain`` is the plain version that the CUDA
kernels of ``csrc/triplane_splat_sorted.cu`` are held against on the
card. Here it is held against

* tgi's route with ``TGI_SPLAT=mxu``: ``_gsp_tpu_for`` with its Pallas
  kernel ``plane_splat_mxu`` in interpret mode at C = 32 (fp32 payload,
  so 1e-5 on both gradients);
* ``triplane_splat_plain``, the ``index_add_`` version of the same sum;
* itself: two runs give the same bits.

And the routing: ``TriplaneSample``'s backward reads ``TGI_SPLAT`` at
each call, ``"mxu"`` takes the sorted splat with ``d_coords`` from the
fused splat run without its ``d_planes``, another value raises, and the
kernel wrappers raise on CPU tensors. Tolerances as in
``test_torch_splat.py``: ``max|got - want| <= tol * max(1, max|want|)``.
"""

import numpy as np
import pytest
import torch

from tgi_torch.ops import grid_sample as gs

from torch_helpers import (TOL, border_coords, close, port_splat_grads,
                           splat_inputs, tpu_route_grads)

SHAPES = [
    (1, 32, 32, 32, 515, 0.9),
    (1, 16, 16, 24, 1037, 1.0),
    (2, 16, 9, 7, 77, 2.0),
    (1, 8, 32, 32, 2085, 1.0),
    (1, 40, 8, 8, 100, 1.0),     # C > 32: the kernel's channel loop
]


def _cl(planes):
    return torch.from_numpy(planes).permute(0, 1, 3, 4, 2).contiguous()


def test_mxu_route_matches_tgi_plane_splat_mxu_interpret(monkeypatch):
    """tgi's TGI_SPLAT=mxu route at C = 32 runs ``plane_splat_mxu``
    (sorted entries, one-hot MXU windows, fp32 payload) in interpret
    mode; the port's backward under the same variable takes the sorted
    plain splat. The point count is ragged for tgi's 512-entry blocks."""
    monkeypatch.setenv("TGI_SPLAT", "mxu")
    got, want = tpu_route_grads(32, 1037)
    close(got[0], want[0], TOL)
    close(got[1], want[1], TOL)


@pytest.mark.parametrize("N,C,H,W,M,box_warp", SHAPES)
def test_sorted_plain_matches_index_add_plain(N, C, H, W, M, box_warp):
    planes, coords, g = splat_inputs(40 + C, N, C, H, W, M, box_warp)
    want, _ = gs.triplane_splat_plain(_cl(planes), torch.from_numpy(coords),
                                      torch.from_numpy(g), box_warp, False)
    got = gs.triplane_splat_sorted_plain(torch.from_numpy(coords),
                                         torch.from_numpy(g), box_warp, H, W)
    close(got, want.numpy(), TOL)


def test_sorted_plain_is_bitwise_repeatable():
    _, coords, g = splat_inputs(50, 2, 16, 16, 16, 3000, 1.0)
    a, b = (gs.triplane_splat_sorted_plain(torch.from_numpy(coords),
                                           torch.from_numpy(g), 1.0, 16, 16)
            for _ in range(2))
    assert torch.equal(a, b)


def test_cells_and_segments():
    """Entry cells use the gather's corners, the sentinel H*W marks a
    corner outside the plane, and the segments cover every in-plane
    entry once, in cell order."""
    H, W = 12, 10
    coords = torch.from_numpy(border_coords(H, W, 1.0))[None]
    cells = gs.splat_cells_plain(coords, 1.0, H, W)
    assert cells.dtype == torch.int32 and cells.shape == (
        3, 4 * coords.shape[1])
    x0, y0, _, _ = gs._point_indices(
        gs.project_onto_planes(2.0 * coords).reshape(3, -1, 2), H, W)
    for k, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        yy, xx = y0 + dy, x0 + dx
        ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        want = torch.where(ok, yy * W + xx, H * W)
        assert torch.equal(cells[:, k::4].long(), want)
    assert (cells == H * W).any() and (cells < H * W).any()
    order, offsets = gs.splat_sort(cells, H, W)
    assert offsets.dtype == torch.int32 and offsets.shape == (3, H * W + 1)
    for p in range(3):
        sorted_cells = cells[p][order[p]]
        assert (sorted_cells.diff() >= 0).all()
        for c in range(H * W):
            seg = sorted_cells[offsets[p, c]:offsets[p, c + 1]]
            assert (seg == c).all()
        assert offsets[p, -1] == (cells[p] < H * W).sum()


@pytest.mark.parametrize("need_coords", [True, False])
def test_mxu_route_backward(monkeypatch, need_coords):
    """Under TGI_SPLAT=mxu the backward's d_planes is the sorted splat's
    and its d_coords the fused splat's, run without d_planes."""
    planes, coords, g = splat_inputs(60, 1, 16, 16, 16, 400, 1.0)
    calls = []
    for name in ("triplane_splat_plain", "triplane_splat_sorted_plain"):
        real = getattr(gs, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append((_name, kw.get("want_dplanes", True)))
            return _real(*args, **kw)

        monkeypatch.setattr(gs, name, spy)
    monkeypatch.setenv("TGI_SPLAT", "mxu")
    p = torch.from_numpy(planes).requires_grad_(True)
    c = torch.from_numpy(coords).requires_grad_(need_coords)
    gs.sample_triplanes(p, c, 1.0).backward(torch.from_numpy(g))
    want = [("triplane_splat_sorted_plain", True)]
    if need_coords:
        want.append(("triplane_splat_plain", False))
    assert calls == want
    monkeypatch.setenv("TGI_SPLAT", "pack")
    want_p, want_c = port_splat_grads(planes, coords, g, 1.0)
    close(p.grad, want_p.numpy(), TOL)
    if need_coords:
        assert torch.equal(c.grad, want_c)


def test_unknown_splat_route_raises(monkeypatch):
    planes, coords, g = splat_inputs(61, 1, 8, 8, 8, 20, 1.0)
    monkeypatch.setenv("TGI_SPLAT", "fast")
    with pytest.raises(ValueError, match="TGI_SPLAT"):
        port_splat_grads(planes, coords, g, 1.0)


def test_v1_route_is_the_fused_splat(monkeypatch):
    """tgi's serialized splat (``v1``) and its packed one are one kernel
    in the port."""
    planes, coords, g = splat_inputs(62, 1, 8, 8, 8, 50, 1.0)
    monkeypatch.setenv("TGI_SPLAT", "v1")
    got = port_splat_grads(planes, coords, g, 1.0)
    monkeypatch.setenv("TGI_SPLAT", "pack")
    want = port_splat_grads(planes, coords, g, 1.0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_plain_splat_without_d_planes():
    planes, coords, g = splat_inputs(63, 1, 8, 16, 16, 60, 1.0)
    args = (_cl(planes), torch.from_numpy(coords), torch.from_numpy(g), 1.0,
            True)
    d_planes, d_coords = gs.triplane_splat_plain(*args, want_dplanes=False)
    assert d_planes is None
    assert torch.equal(d_coords, gs.triplane_splat_plain(*args)[1])


def test_sorted_kernel_wrappers_raise_without_a_card(monkeypatch):
    """The kernel wrappers never run a plain version in their place, and
    a CPU backward under TGI_SPLAT=mxu launches nothing."""
    planes, coords, g = splat_inputs(64, 1, 8, 16, 16, 50, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        gs.triplane_splat_sorted_cuda(torch.from_numpy(coords),
                                      torch.from_numpy(g), 1.0, 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        gs.triplane_splat_cuda(_cl(planes), torch.from_numpy(coords),
                               torch.from_numpy(g), 1.0, True,
                               want_dplanes=False)
    monkeypatch.setenv("TGI_SPLAT", "mxu")
    before = (gs.LAUNCHES, gs.SPLAT_LAUNCHES, gs.SORTED_SPLAT_LAUNCHES,
              gs.SPLAT_CELLS_LAUNCHES)
    port_splat_grads(planes, coords, g, 1.0)
    assert (gs.LAUNCHES, gs.SPLAT_LAUNCHES, gs.SORTED_SPLAT_LAUNCHES,
            gs.SPLAT_CELLS_LAUNCHES) == before


def test_sorted_splat_rejects_bad_shapes():
    _, coords, g = splat_inputs(65, 1, 8, 16, 16, 50, 1.0)
    with pytest.raises(ValueError, match="g must be"):
        gs.triplane_splat_sorted_plain(torch.from_numpy(coords),
                                       torch.from_numpy(g[:, :, :-1]), 1.0,
                                       16, 16)
