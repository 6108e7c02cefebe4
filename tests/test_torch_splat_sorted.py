"""The sorted, deterministic splat (tgi's ``TGI_SPLAT=mxu`` route) of
tgi_torch's tri-plane sampling, on the CPU.

``triplane_splat_sorted_plain`` is the plain version that the CUDA
kernels of ``csrc/triplane_splat_sorted.cu`` are held against on the
card. Here it is held against

* tgi's route with ``TGI_SPLAT=mxu``: ``_gsp_tpu_for`` with its Pallas
  kernel ``plane_splat_mxu`` in interpret mode at C = 32 (fp32 payload,
  so 1e-5 on both gradients);
* ``triplane_splat_plain``, the ``index_add_`` version of the same sum;
* itself: two runs give the same bits;

and its prep (point keys on the grid of floor cells, the sentinel,
offsets, records) against a numpy count.

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
    (1, 40, 8, 8, 100, 1.0),     # C = 40: 10 float4 lanes in a group of 16
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


def _numpy_floor_cells(coords, box_warp, H, W):
    """(fx, fy, wx, wy) float32 ``[N*3*M]``: each (plane, point)'s floor
    cell and fractions, planes (x, y), (x, z), (z, x), in numpy."""
    p = coords.astype(np.float32) * np.float32(2.0 / box_warp)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    u = np.stack([x, x, z], 1).reshape(-1)
    v = np.stack([y, z, x], 1).reshape(-1)
    ix = (u + np.float32(1)) * np.float32(W / 2) - np.float32(0.5)
    iy = (v + np.float32(1)) * np.float32(H / 2) - np.float32(0.5)
    fx, fy = np.floor(ix), np.floor(iy)
    return fx, fy, ix - fx, iy - fy


@pytest.mark.parametrize("N,H,W,box_warp", [(1, 12, 10, 1.0),
                                            (2, 7, 9, 2.0),
                                            (1, 16, 5, 0.9)])
def test_prep_matches_a_numpy_count(N, H, W, box_warp):
    """One key per (plane, point): its floor cell on the (H+1) x (W+1)
    grid from -1, its plane's sentinel where the floor cell is off that
    grid; one stable order of all planes' keys; offsets equal to a
    numpy count's running sum; records (index, wx, wy, 0) in sorted
    order. The points include the border points (floor cells -1 and
    H-1, W-1) and points past the borders."""
    _, coords, _ = splat_inputs(70 + H, N, 4, H, W, 301, box_warp)
    c = torch.from_numpy(coords)
    keys = gs.splat_keys_plain(c, box_warp, H, W)
    order, offsets, records = gs.splat_prep_plain(c, box_warp, H, W)
    fx, fy, wx, wy = _numpy_floor_cells(coords, box_warp, H, W)
    on = (fx >= -1) & (fx <= W - 1) & (fy >= -1) & (fy <= H - 1)
    assert on.any() and not on.all()
    assert (on & (fx == -1)).any() and (on & (fy == -1)).any()
    assert (on & (fx == W - 1)).any() and (on & (fy == H - 1)).any()
    cells = (H + 1) * (W + 1)
    local = np.where(on, (fy + 1) * (W + 1) + fx + 1, cells).astype(np.int64)
    plane = np.arange(N * 3 * 301) // 301
    want = plane * (cells + 1) + local
    assert keys.dtype == torch.int32
    np.testing.assert_array_equal(keys.numpy(), want)
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(want, kind="stable"))
    count = np.bincount(want, minlength=N * 3 * (cells + 1))
    assert offsets.dtype == torch.int32
    assert offsets.shape == (N * 3, cells + 1)
    np.testing.assert_array_equal(offsets.numpy().reshape(-1),
                                  np.cumsum(count) - count)
    idx = order.numpy()
    assert records.dtype == torch.int32 and records.shape == (N * 3 * 301, 4)
    np.testing.assert_array_equal(records[:, 0].numpy(), idx)
    np.testing.assert_array_equal(records[:, 1].numpy().view(np.float32),
                                  wx[idx])
    np.testing.assert_array_equal(records[:, 2].numpy().view(np.float32),
                                  wy[idx])
    assert (records[:, 3] == 0).all()


def test_segments_plain_takes_each_corner_from_its_floor_cell():
    """With g = 1 and C = 1, output cell (y, x) sums the corner weights
    of the points whose floor cells are (y, x), (y, x-1), (y-1, x) and
    (y-1, x-1): checked point by point against numpy."""
    H, W = 6, 5
    _, coords, _ = splat_inputs(80, 1, 1, H, W, 200, 1.0)
    g = torch.ones(1, 3, 200, 1)
    got = gs.triplane_splat_sorted_plain(torch.from_numpy(coords), g, 1.0,
                                         H, W).numpy().reshape(3, H, W)
    fx, fy, wx, wy = _numpy_floor_cells(coords, 1.0, H, W)
    want = np.zeros((3, H, W))
    for i in range(3 * 200):
        for dy, dx, w in ((0, 0, (1 - wx[i]) * (1 - wy[i])),
                          (0, 1, wx[i] * (1 - wy[i])),
                          (1, 0, (1 - wx[i]) * wy[i]),
                          (1, 1, wx[i] * wy[i])):
            yy, xx = int(fy[i]) + dy, int(fx[i]) + dx
            if 0 <= yy < H and 0 <= xx < W:
                want[i // 200, yy, xx] += w
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


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
              gs.SPLAT_KEYS_LAUNCHES, gs.SPLAT_OFFSETS_LAUNCHES)
    port_splat_grads(planes, coords, g, 1.0)
    assert (gs.LAUNCHES, gs.SPLAT_LAUNCHES, gs.SORTED_SPLAT_LAUNCHES,
            gs.SPLAT_KEYS_LAUNCHES, gs.SPLAT_OFFSETS_LAUNCHES) == before


@pytest.mark.parametrize("wrapper", ["keys", "prep", "offsets", "segments"])
def test_sorted_prep_and_segment_wrappers_raise_without_a_card(wrapper):
    """Each kernel wrapper of the sorted splat raises on CPU tensors, and
    the offsets and segment wrappers check their inputs' shapes first."""
    _, coords, g = splat_inputs(66, 1, 8, 16, 16, 50, 1.0)
    c, g = torch.from_numpy(coords), torch.from_numpy(g)
    order, offsets, records = gs.splat_prep_plain(c, 1.0, 16, 16)
    keys_s = gs.splat_keys_plain(c, 1.0, 16, 16).sort(stable=True)[0]
    call, bad = {
        "keys": (lambda: gs.splat_keys_cuda(c, 1.0, 16, 16), None),
        "prep": (lambda: gs.splat_prep_cuda(c, 1.0, 16, 16), None),
        "offsets": (lambda o=order: gs.splat_offsets_cuda(
            c, keys_s, o, 1.0, 16, 16), lambda: order.int()),
        "segments": (lambda r=records: gs.splat_segments_cuda(
            g, r, offsets, 16, 16), lambda: records[:-1]),
    }[wrapper]
    before = (gs.SORTED_SPLAT_LAUNCHES, gs.SPLAT_KEYS_LAUNCHES,
              gs.SPLAT_OFFSETS_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        call()
    if bad is not None:
        with pytest.raises(ValueError, match="must be int"):
            call(bad())
    assert (gs.SORTED_SPLAT_LAUNCHES, gs.SPLAT_KEYS_LAUNCHES,
            gs.SPLAT_OFFSETS_LAUNCHES) == before


def test_sorted_splat_rejects_bad_shapes():
    _, coords, g = splat_inputs(65, 1, 8, 16, 16, 50, 1.0)
    with pytest.raises(ValueError, match="g must be"):
        gs.triplane_splat_sorted_plain(torch.from_numpy(coords),
                                       torch.from_numpy(g[:, :, :-1]), 1.0,
                                       16, 16)
