"""Tri-plane bilinear sampling — the render's hot spot (twin of
``tgi/ops/grid_sample.py``).

Forward: ``[N, 3, C, H, W]`` planes sampled at ``[N, M, 3]`` world points
into ``[N, 3, M, C]`` features, in two implementations:

* :func:`sample_triplanes_plain` — plain PyTorch: the 4-corner
  formulation of ``_grid_sample_points_impl`` (``align_corners=False``
  unnormalise, floor, zero padding, lerp order
  ``top = v00+(v01-v00)*wx; bot = v10+(v11-v10)*wx; out = top+(bot-top)*wy``).
* :func:`sample_triplanes_cuda` — the hand-written CUDA kernel
  ``csrc/triplane_gather.cu``, which replaces the TPU kernel
  ``tgi/ops/pallas/gather_vmem.py::gather_rows_vmem`` together with its
  caller's epilogue (``grid_sample.py:192-213``).

Backward (twin of ``_gsp_bwd``, ``grid_sample.py:236-301``): the plane
gradient is a scatter-add of the four corner weights times the feature
gradient, and the point gradient is ``_gsp_bwd``'s corner-difference
formula folded back through :func:`project_onto_planes` and the
``2/box_warp`` scale, again in two implementations:

* :func:`triplane_splat_plain` — plain PyTorch (``index_add_``).
* :func:`triplane_splat_cuda` — the hand-written CUDA kernel
  ``csrc/triplane_splat.cu``, which replaces the TPU kernels
  ``tgi/ops/pallas/splat_pack.py::plane_splat_pack`` and
  ``tgi/ops/pallas/splat.py::plane_splat`` and fuses the ``d_coords``
  formula.

``TGI_SPLAT=mxu``, read at each backward as ``tgi`` reads it
(``grid_sample.py:262``), takes the plane gradient from a sorted
segmented reduction instead, bitwise deterministic:

* :func:`triplane_splat_sorted_plain` — plain PyTorch: the same point
  keys and ``torch.sort``, offsets from an integer count, and segment
  sums per corner.
* :func:`triplane_splat_sorted_cuda` — the hand-written CUDA kernels
  ``csrc/triplane_splat_sorted.cu``, which replace the TPU kernel
  ``tgi/ops/pallas/splat_mxu.py::plane_splat_mxu``; ``d_coords`` then
  comes from ``triplane_splat.cu`` with its ``d_planes`` switched off.

:func:`sample_triplanes` is one ``torch.autograd.Function``,
:class:`TriplaneSample`, on both devices: a CPU tensor takes the plain
versions, a CUDA tensor the kernels. A CUDA tensor never takes a plain
version: the kernel launches or the call raises.
"""

from __future__ import annotations

import ctypes
import os

import torch

# Launches of the CUDA kernels since the counts were last set to 0.
LAUNCHES = 0                 # triplane_gather
SPLAT_LAUNCHES = 0           # triplane_splat
SORTED_SPLAT_LAUNCHES = 0    # triplane_splat_sorted's segment kernel
SPLAT_KEYS_LAUNCHES = 0      # triplane_splat_sorted's key kernel (prep)
SPLAT_OFFSETS_LAUNCHES = 0   # triplane_splat_sorted's offsets kernel (prep)


def _unnormalize(coord, size):
    """align_corners=False: map [-1, 1] to pixel centers [-0.5, size-0.5]."""
    return (coord + 1.0) * (size / 2.0) - 0.5


def _point_indices(coords, H, W):
    """(x0, y0 int64 floors, wx, wy fractions [..., None])."""
    g = coords.float()
    ix = _unnormalize(g[..., 0], W)
    iy = _unnormalize(g[..., 1], H)
    x0f = torch.floor(ix)
    y0f = torch.floor(iy)
    return (x0f.long(), y0f.long(),
            (ix - x0f)[..., None], (iy - y0f)[..., None])


def grid_sample_points(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Plain bilinear point sampling: img ``[G, C, H, W]``, coords
    ``[G, P, 2]`` (x, y in [-1, 1]) -> ``[G, P, C]``.

    ``torch.nn.functional.grid_sample`` semantics (bilinear,
    ``align_corners=False``, zero padding) in the 4-corner form of
    ``tgi.ops.grid_sample._grid_sample_points_impl``.
    """
    G, C, H, W = img.shape
    x0, y0, wx, wy = _point_indices(coords, H, W)
    flat = img.permute(0, 2, 3, 1).reshape(G, H * W, C)

    def corner(yy, xx):
        ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        cell = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
        v = torch.gather(flat, 1, cell[..., None].expand(-1, -1, C))
        return v * ok[..., None].to(img.dtype)

    v00, v01 = corner(y0, x0), corner(y0, x0 + 1)
    v10, v11 = corner(y0 + 1, x0), corner(y0 + 1, x0 + 1)
    wx = wx.to(img.dtype)
    wy = wy.to(img.dtype)
    top = v00 + (v01 - v00) * wx
    bot = v10 + (v11 - v10) * wx
    return top + (bot - top) * wy


def grid_sample_2d(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample ``img`` ``[N, C, H, W]`` at ``grid``
    ``[N, Hg, Wg, 2]`` (x, y in [-1, 1]) -> ``[N, C, Hg, Wg]``.

    ``torch.nn.functional.grid_sample`` semantics (bilinear,
    ``align_corners=False``, zero padding), through the plain 4-corner
    :func:`grid_sample_points` and autograd, so the gradient reaches both
    the image and the grid: the warping loss samples at a grid that the
    camera moves. ``tgi``'s ``_grid_sample_points_dense``
    (``tgi/ops/grid_sample.py:304``, taken at :359 only on a TPU, for
    H·W <= 4096 and C >= 64) is a one-hot matmul form of the same numbers,
    made for a chip without a fast gather; it has no route here.
    """
    N, C, H, W = img.shape
    _, Hg, Wg, _ = grid.shape
    out = grid_sample_points(img, grid.reshape(N, Hg * Wg, 2))
    return out.permute(0, 2, 1).reshape(N, C, Hg, Wg)


def project_onto_planes(coords: torch.Tensor) -> torch.Tensor:
    """World points ``[N, M, 3]`` -> per-plane 2D coords ``[N, 3, M, 2]``.

    The reference's axis convention, including its (z, x) third plane:
    the projections are (x, y), (x, z), (z, x).
    """
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    p0 = torch.stack([x, y], dim=-1)
    p1 = torch.stack([x, z], dim=-1)
    p2 = torch.stack([z, x], dim=-1)
    return torch.stack([p0, p1, p2], dim=1)


def sample_triplanes_plain(planes: torch.Tensor, coords: torch.Tensor,
                           box_warp: float) -> torch.Tensor:
    """Plain PyTorch tri-plane sampling (the kernel's reference)."""
    N, n_planes, C, H, W = planes.shape
    M = coords.shape[1]
    proj = project_onto_planes((2.0 / box_warp) * coords)   # [N, 3, M, 2]
    feats = grid_sample_points(planes.reshape(N * n_planes, C, H, W),
                               proj.reshape(N * n_planes, M, 2))
    return feats.reshape(N, n_planes, M, C)


def channels_last(planes: torch.Tensor) -> torch.Tensor:
    """The same logical ``[N, 3, C, H, W]`` planes stored as
    ``[N, 3, H, W, C]``, the layout the kernel reads (one copy).

    A renderer calls this once per render so that both sampling passes
    find the planes already in the kernel's layout."""
    return planes.permute(0, 1, 3, 4, 2).contiguous().permute(0, 1, 4, 2, 3)


def sample_triplanes_cuda(planes: torch.Tensor, coords: torch.Tensor,
                          box_warp: float) -> torch.Tensor:
    """Tri-plane sampling through the CUDA kernel.

    planes: ``[N, 3, C, H, W]`` float32 on a CUDA device; copied to the
    kernel's channels-last layout unless already stored that way
    (:func:`channels_last`). coords: ``[N, M, 3]`` float32, contiguous,
    on the same device. Returns ``[N, 3, M, C]`` float32.
    """
    global LAUNCHES
    from tgi_torch.ops import _native

    if planes.device.type != "cuda" or coords.device != planes.device:
        raise ValueError(f"planes on {planes.device}, coords on "
                         f"{coords.device}: both must be on one CUDA device")
    if planes.dtype != torch.float32 or coords.dtype != torch.float32:
        raise TypeError(f"float32 only, got {planes.dtype}, {coords.dtype}")
    if planes.ndim != 5 or planes.shape[1] != 3:
        raise ValueError(f"planes must be [N, 3, C, H, W], got "
                         f"{tuple(planes.shape)}")
    N, _, C, H, W = planes.shape
    if coords.ndim != 3 or coords.shape[0] != N or coords.shape[2] != 3:
        raise ValueError(f"coords must be [{N}, M, 3], got "
                         f"{tuple(coords.shape)}")
    if not coords.is_contiguous():
        raise ValueError("coords must be contiguous")
    M = coords.shape[1]
    if N * 3 > 65535 or M >= 2 ** 31:
        raise ValueError(f"shape out of the kernel's range: N={N}, M={M}")
    planes_cl = planes.permute(0, 1, 3, 4, 2).contiguous()  # no-op if CL
    out = torch.empty((N, 3, M, C), dtype=torch.float32, device=planes.device)
    lib = _native.library("triplane_gather.cu")
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    err = lib.tgi_triplane_gather_f32(
        ctypes.c_void_p(planes_cl.data_ptr()), ctypes.c_void_p(coords.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), N, H, W, C, M,
        ctypes.c_float(2.0 / box_warp), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"triplane_gather launch failed: "
                           f"{_native.error_string(err)} ({err})")
    LAUNCHES += 1
    return out


def _check_splat_args(planes_cl, coords, g):
    """Shapes of the splat's arguments -> (N, H, W, C, M)."""
    if planes_cl.ndim != 5 or planes_cl.shape[1] != 3:
        raise ValueError(f"planes_cl must be [N, 3, H, W, C], got "
                         f"{tuple(planes_cl.shape)}")
    N, _, H, W, C = planes_cl.shape
    if coords.ndim != 3 or coords.shape[0] != N or coords.shape[2] != 3:
        raise ValueError(f"coords must be [{N}, M, 3], got "
                         f"{tuple(coords.shape)}")
    M = coords.shape[1]
    if tuple(g.shape) != (N, 3, M, C):
        raise ValueError(f"g must be [{N}, 3, {M}, {C}], got "
                         f"{tuple(g.shape)}")
    return N, H, W, C, M


def triplane_splat_plain(planes_cl, coords, g, box_warp, need_coords,
                         want_dplanes=True):
    """Plain PyTorch backward of tri-plane sampling (the splat kernel's
    reference, and what a CPU tensor takes).

    planes_cl: ``[N, 3, H, W, C]`` planes (channels last; read only for
    the point gradient). coords: ``[N, M, 3]`` world points. g:
    ``[N, 3, M, C]`` gradient of the sampled features.

    Returns ``(d_planes [N, 3, H, W, C] or None without want_dplanes,
    d_coords [N, M, 3] or None)``.
    ``d_planes`` scatter-adds ``w4 = ((1-wx)(1-wy), wx(1-wy), (1-wx)wy,
    wx·wy)`` times ``g`` into the four corners, skipping corners outside
    the plane. ``d_coords`` is ``_gsp_bwd``'s formula
    (``grid_sample.py:255-260``) per plane, folded back through
    :func:`project_onto_planes` and the ``2/box_warp`` scale.
    """
    N, H, W, C, M = _check_splat_args(planes_cl, coords, g)
    G = N * 3
    s = 2.0 / box_warp
    proj = project_onto_planes(s * coords.float()).reshape(G, M, 2)
    x0, y0, wx, wy = _point_indices(proj, H, W)
    gg = g.reshape(G, M, C).float()
    flat = planes_cl.reshape(G * H * W, C) if need_coords else None
    base = (torch.arange(G, device=g.device) * (H * W))[:, None]
    d_flat = (torch.zeros((G * H * W, C), dtype=torch.float32,
                          device=g.device) if want_dplanes else None)
    corners = {}
    for (dy, dx), w in (((0, 0), (1 - wx) * (1 - wy)),
                        ((0, 1), wx * (1 - wy)),
                        ((1, 0), (1 - wx) * wy),
                        ((1, 1), wx * wy)):
        yy, xx = y0 + dy, x0 + dx
        ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        cell = base + yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
        if want_dplanes:
            d_flat.index_add_(0, cell[ok], (w * gg)[ok])
        if need_coords:
            corners[dy, dx] = flat[cell] * ok[..., None].to(flat.dtype)
    d_planes = d_flat.reshape(N, 3, H, W, C) if want_dplanes else None
    if not need_coords:
        return d_planes, None
    v00, v01 = corners[0, 0], corners[0, 1]
    v10, v11 = corners[1, 0], corners[1, 1]
    dix = (((v01 - v00) * (1 - wy) + (v11 - v10) * wy) * gg).sum(-1)
    diy = (((v10 - v00) * (1 - wx) + (v11 - v01) * wx) * gg).sum(-1)
    d_proj = torch.stack([dix * (W / 2.0), diy * (H / 2.0)],
                         dim=-1).reshape(N, 3, M, 2)
    # Planes project (x, y), (x, z), (z, x).
    d_coords = s * torch.stack([
        d_proj[:, 0, :, 0] + d_proj[:, 1, :, 0] + d_proj[:, 2, :, 1],
        d_proj[:, 0, :, 1],
        d_proj[:, 1, :, 1] + d_proj[:, 2, :, 0]], dim=-1)
    return d_planes, d_coords


def triplane_splat_cuda(planes_cl, coords, g, box_warp, need_coords,
                        want_dplanes=True):
    """:func:`triplane_splat_plain` through the CUDA kernel.

    All arguments float32 on one CUDA device; ``g`` (and ``planes_cl``,
    read only for ``d_coords``) are made contiguous, ``coords`` must be.
    The kernel accumulates with atomics, so the sums' order, and their
    last bits, change from run to run.
    """
    global SPLAT_LAUNCHES
    from tgi_torch.ops import _native

    dev = g.device
    if dev.type != "cuda" or coords.device != dev or planes_cl.device != dev:
        raise ValueError(f"planes on {planes_cl.device}, coords on "
                         f"{coords.device}, g on {dev}: all must be on one "
                         f"CUDA device")
    if {planes_cl.dtype, coords.dtype, g.dtype} != {torch.float32}:
        raise TypeError(f"float32 only, got {planes_cl.dtype}, "
                        f"{coords.dtype}, {g.dtype}")
    N, H, W, C, M = _check_splat_args(planes_cl, coords, g)
    if not coords.is_contiguous():
        raise ValueError("coords must be contiguous")
    if N * 3 > 65535 or M >= 2 ** 31:
        raise ValueError(f"shape out of the kernel's range: N={N}, M={M}")
    if not (want_dplanes or need_coords):
        raise ValueError("the splat was asked for neither output")
    if need_coords:
        planes_cl = planes_cl.contiguous()
    g = g.contiguous()
    d_planes = (torch.empty((N, 3, H, W, C), dtype=torch.float32, device=dev)
                if want_dplanes else None)
    d_coords = (torch.empty((N, M, 3), dtype=torch.float32, device=dev)
                if need_coords else None)
    lib = _native.library("triplane_splat.cu")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.tgi_triplane_splat_f32(
        ctypes.c_void_p(g.data_ptr()), ctypes.c_void_p(coords.data_ptr()),
        ctypes.c_void_p(planes_cl.data_ptr() if need_coords else None),
        ctypes.c_void_p(d_planes.data_ptr() if want_dplanes else None),
        ctypes.c_void_p(d_coords.data_ptr() if need_coords else None),
        N, H, W, C, M, ctypes.c_float(2.0 / box_warp), int(want_dplanes),
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"triplane_splat launch failed: "
                           f"{_native.error_string(err)} ({err})")
    SPLAT_LAUNCHES += 1
    return d_planes, d_coords


def _check_sorted_args(coords, g, H, W):
    """Shapes of the sorted splat's arguments -> (N, C, M)."""
    if coords.ndim != 3 or coords.shape[2] != 3:
        raise ValueError(f"coords must be [N, M, 3], got "
                         f"{tuple(coords.shape)}")
    N, M, _ = coords.shape
    if g.ndim != 4 or tuple(g.shape[:3]) != (N, 3, M):
        raise ValueError(f"g must be [{N}, 3, {M}, C], got {tuple(g.shape)}")
    if H <= 0 or W <= 0:
        raise ValueError(f"empty plane {H}x{W}")
    return N, g.shape[3], M


def _floor_cells(coords, box_warp, H, W):
    """Each (plane, point)'s floor cell and fractions, flat over
    ``gp * M + m``: ``(x0f, y0f, wx, wy)`` float32 ``[N*3*M]``, the
    gather's corners (:func:`_point_indices`)."""
    N, M, _ = coords.shape
    proj = project_onto_planes((2.0 / box_warp) * coords.float())
    g = proj.reshape(N * 3 * M, 2)
    ix = _unnormalize(g[:, 0], W)
    iy = _unnormalize(g[:, 1], H)
    x0f = torch.floor(ix)
    y0f = torch.floor(iy)
    return x0f, y0f, ix - x0f, iy - y0f


def splat_keys_plain(coords, box_warp, H, W):
    """Each (plane, point)'s sort key, int32 ``[N*3*M]`` flat over
    ``gp * M + m`` (``gp = 3 n + plane``): ``gp * K + (y0 + 1) * (W + 1)
    + x0 + 1`` for its floor cell ``(y0, x0)`` on the ``(H+1) x (W+1)``
    grid of floor cells from -1, ``K = (H+1)(W+1) + 1``; the plane's
    sentinel ``gp * K + K - 1`` where the floor cell is off that grid (no
    corner on the plane)."""
    N, M, _ = coords.shape
    x0f, y0f, _, _ = _floor_cells(coords, box_warp, H, W)
    cells = (H + 1) * (W + 1)
    on = (x0f >= -1) & (x0f <= W - 1) & (y0f >= -1) & (y0f <= H - 1)
    local = torch.where(on, (y0f.clamp(-1, H - 1).long() + 1) * (W + 1)
                        + x0f.clamp(-1, W - 1).long() + 1, cells)
    gp = torch.arange(N * 3, device=coords.device).repeat_interleave(M)
    return (gp * (cells + 1) + local).int()


def splat_prep_plain(coords, box_warp, H, W):
    """The sorted splat's prep: ``(order, offsets, records)``.

    ``order`` int64 ``[N*3*M]``: the (plane, point) pairs, flat
    ``gp * M + m``, sorted by :func:`splat_keys_plain` (one stable
    ``torch.sort`` of all planes' keys). ``offsets`` int32
    ``[N*3, (H+1)(W+1) + 1]``: each floor cell's first position in that
    order and, last, the start of the plane's sentinel run, from an
    integer count and its running sum. ``records`` int32 ``[N*3*M, 4]``:
    per sorted position the flat index, the bits of ``wx`` and ``wy``
    and 0."""
    N, M, _ = coords.shape
    keys = splat_keys_plain(coords, box_warp, H, W)
    order = torch.sort(keys, stable=True)[1]
    K = (H + 1) * (W + 1) + 1
    count = torch.bincount(keys.long(), minlength=N * 3 * K)
    offsets = (torch.cumsum(count, 0) - count).int().reshape(N * 3, K)
    _, _, wx, wy = _floor_cells(coords, box_warp, H, W)
    records = torch.stack([order.int(), wx[order].view(torch.int32),
                           wy[order].view(torch.int32),
                           torch.zeros_like(order, dtype=torch.int32)], -1)
    return order, offsets, records


def splat_segments_plain(g, records, offsets, H, W):
    """Plain PyTorch segment sums of the sorted splat: ``d_planes
    [N, 3, H, W, C]`` from :func:`splat_prep_plain`'s records and
    offsets. Each floor cell's segment is summed per corner, in sorted
    order, and output cell ``(y, x)`` adds corner 00 of floor cell
    ``(y, x)``, 01 of ``(y, x-1)``, 10 of ``(y-1, x)`` and 11 of
    ``(y-1, x-1)``, in that order."""
    NP, K = offsets.shape
    C = g.shape[-1]
    T = records.shape[0]
    wx = records[:, 1].view(torch.float32)[:, None]
    wy = records[:, 2].view(torch.float32)[:, None]
    w4 = torch.cat([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy,
                    wx * wy], dim=-1)
    g_s = g.reshape(-1, C).float()[records[:, 0].long()]
    lengths = torch.diff(offsets.reshape(-1).long(),
                         append=torch.full((1,), T, device=g.device))
    s = torch.segment_reduce((w4[:, :, None] * g_s[:, None]).reshape(
        T, 4 * C), "sum", lengths=lengths, axis=0, unsafe=True)
    s = s.reshape(NP, K, 4, C)[:, :-1].reshape(NP, H + 1, W + 1, 4, C)
    d = (s[:, 1:, 1:, 0] + s[:, 1:, :-1, 1] + s[:, :-1, 1:, 2]
         + s[:, :-1, :-1, 3])
    return d.reshape(NP // 3, 3, H, W, C)


def triplane_splat_sorted_plain(coords, g, box_warp, H, W):
    """Plain PyTorch plane gradient of tri-plane sampling as a sorted
    segmented reduction (the reference of the sorted splat kernels, and
    what a CPU tensor takes under ``TGI_SPLAT=mxu``).

    coords: ``[N, M, 3]`` world points; g: ``[N, 3, M, C]`` gradient of
    the sampled features. Returns ``d_planes [N, 3, H, W, C]``: the
    points sorted by floor cell (:func:`splat_prep_plain`), their corner
    weights times ``g`` summed per segment (:func:`splat_segments_plain`).
    """
    _check_sorted_args(coords, g, H, W)
    _, offsets, records = splat_prep_plain(coords, box_warp, H, W)
    return splat_segments_plain(g, records, offsets, H, W)


def _on_one_card(*tensors):
    """Raise unless every tensor lies on one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"tensors on {[str(t.device) for t in tensors]}: "
                         f"all must be on one CUDA device")


def _check_sorted_cuda(coords, H, W):
    """What the sorted splat's kernels need of ``coords`` (contiguous
    float32 ``[N, M, 3]`` on a card) and of the shape (int32 keys, flat
    indices and positions). Returns (N, M)."""
    if coords.ndim != 3 or coords.shape[2] != 3:
        raise ValueError(f"coords must be [N, M, 3], got "
                         f"{tuple(coords.shape)}")
    _on_one_card(coords)
    if coords.dtype != torch.float32 or not coords.is_contiguous():
        raise TypeError(f"coords must be contiguous float32, got "
                        f"{coords.dtype}")
    N, M, _ = coords.shape
    if (N * 3 > 65535 or 3 * N * M >= 2 ** 31
            or 3 * N * ((H + 1) * (W + 1) + 1) >= 2 ** 31):
        raise ValueError(f"shape out of the kernels' range: N={N}, M={M}, "
                         f"{H}x{W}")
    return N, M


def splat_keys_cuda(coords, box_warp, H, W):
    """:func:`splat_keys_plain` through the key kernel
    (``triplane_splat_sorted.cu``)."""
    global SPLAT_KEYS_LAUNCHES
    from tgi_torch.ops import _native
    N, M = _check_sorted_cuda(coords, H, W)
    keys = torch.empty(N * 3 * M, dtype=torch.int32, device=coords.device)
    lib = _native.library("triplane_splat_sorted.cu")
    err = lib.tgi_splat_keys_f32(
        ctypes.c_void_p(coords.data_ptr()), ctypes.c_void_p(keys.data_ptr()),
        N, H, W, M, ctypes.c_float(2.0 / box_warp),
        ctypes.c_void_p(torch.cuda.current_stream(coords.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"splat_keys launch failed: "
                           f"{_native.error_string(err)} ({err})")
    SPLAT_KEYS_LAUNCHES += 1
    return keys


def splat_offsets_cuda(coords, keys_sorted, order, box_warp, H, W):
    """The offsets-and-records kernel (``triplane_splat_sorted.cu``) on
    the sorted keys and their ``order``: :func:`splat_prep_plain`'s
    ``(offsets, records)``."""
    global SPLAT_OFFSETS_LAUNCHES
    from tgi_torch.ops import _native
    T = 3 * coords.shape[0] * coords.shape[1]
    if (tuple(keys_sorted.shape) != (T,) or order.shape != keys_sorted.shape
            or keys_sorted.dtype != torch.int32
            or order.dtype != torch.int64):
        raise ValueError(f"keys_sorted must be int32 and order int64, both "
                         f"[{T}]; got {keys_sorted.dtype} "
                         f"{tuple(keys_sorted.shape)} and {order.dtype} "
                         f"{tuple(order.shape)}")
    _on_one_card(coords, keys_sorted, order)
    N, M = _check_sorted_cuda(coords, H, W)
    dev = coords.device
    offsets = torch.empty((N * 3, (H + 1) * (W + 1) + 1), dtype=torch.int32,
                          device=dev)
    records = torch.empty((T, 4), dtype=torch.int32, device=dev)
    lib = _native.library("triplane_splat_sorted.cu")
    err = lib.tgi_splat_offsets_f32(
        ctypes.c_void_p(keys_sorted.data_ptr()),
        ctypes.c_void_p(order.data_ptr()), ctypes.c_void_p(coords.data_ptr()),
        ctypes.c_void_p(offsets.data_ptr()),
        ctypes.c_void_p(records.data_ptr()), N, H, W, M,
        ctypes.c_float(2.0 / box_warp),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"splat_offsets launch failed: "
                           f"{_native.error_string(err)} ({err})")
    SPLAT_OFFSETS_LAUNCHES += 1
    return offsets, records


def splat_prep_cuda(coords, box_warp, H, W):
    """:func:`splat_prep_plain` on the card: the key kernel, one stable
    ``torch.sort`` of all planes' keys, then the offsets-and-records
    kernel."""
    keys_sorted, order = torch.sort(splat_keys_cuda(coords, box_warp, H, W),
                                    stable=True)
    return (order, *splat_offsets_cuda(coords, keys_sorted, order, box_warp,
                                       H, W))


def splat_segments_cuda(g, records, offsets, H, W):
    """:func:`splat_segments_plain` through the segment kernel
    (``triplane_splat_sorted.cu``): ``d_planes [N, 3, H, W, C]``."""
    global SORTED_SPLAT_LAUNCHES
    from tgi_torch.ops import _native
    if g.ndim != 4 or g.shape[1] != 3:
        raise ValueError(f"g must be [N, 3, M, C], got {tuple(g.shape)}")
    N, _, M, C = g.shape
    K = (H + 1) * (W + 1) + 1
    if (tuple(records.shape) != (N * 3 * M, 4)
            or tuple(offsets.shape) != (N * 3, K)
            or records.dtype != torch.int32 or offsets.dtype != torch.int32
            or not (records.is_contiguous() and offsets.is_contiguous())):
        raise ValueError(f"records must be int32 [{N * 3 * M}, 4] and "
                         f"offsets int32 [{N * 3}, {K}], contiguous; got "
                         f"{tuple(records.shape)} and "
                         f"{tuple(offsets.shape)}")
    _on_one_card(g, records, offsets)
    if g.dtype != torch.float32:
        raise TypeError(f"float32 only, got {g.dtype}")
    d_planes = torch.empty((N, 3, H, W, C), dtype=torch.float32,
                           device=g.device)
    g = g.contiguous()
    lib = _native.library("triplane_splat_sorted.cu")
    err = lib.tgi_splat_segments_f32(
        ctypes.c_void_p(g.data_ptr()), ctypes.c_void_p(records.data_ptr()),
        ctypes.c_void_p(offsets.data_ptr()),
        ctypes.c_void_p(d_planes.data_ptr()), N, H, W, C, M,
        ctypes.c_void_p(torch.cuda.current_stream(g.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"splat_segments launch failed: "
                           f"{_native.error_string(err)} ({err})")
    SORTED_SPLAT_LAUNCHES += 1
    return d_planes


def triplane_splat_sorted_cuda(coords, g, box_warp, H, W):
    """:func:`triplane_splat_sorted_plain` through the CUDA kernels: no
    atomics, so ``d_planes`` is the same bits from run to run.

    coords (contiguous) and g float32 on one CUDA device."""
    _check_sorted_args(coords, g, H, W)
    _on_one_card(coords, g)
    _, offsets, records = splat_prep_cuda(coords, box_warp, H, W)
    return splat_segments_cuda(g, records, offsets, H, W)


class TriplaneSample(torch.autograd.Function):
    """Tri-plane sampling with its hand-written backward (twin of
    ``_gsp_tpu_for``'s ``custom_vjp``, ``grid_sample.py:156``).

    It saves only the planes (channels last) and the points; the
    backward re-reads the four corners from the planes where the point
    gradient is asked for. A CPU tensor takes the plain versions, a CUDA
    tensor the kernels.

    Reduced-precision planes are sampled as ``tgi``'s TPU route samples
    them (``grid_sample.py:198-213``, ``:236-300``): cast up to float32
    here, before the kernel or its plain version, which both take float32
    only; the features come back in the planes' dtype. The backward casts
    the feature gradient up to float32 and returns ``d_planes`` in the
    planes' dtype and ``d_coords`` in float32.
    """

    @staticmethod
    def forward(ctx, planes, coords, box_warp):
        dtype = planes.dtype
        planes = planes.float()          # keeps a channels-last layout
        planes_cl = planes.permute(0, 1, 3, 4, 2).contiguous()  # no-op if CL
        ctx.save_for_backward(planes_cl, coords)
        ctx.box_warp = box_warp
        ctx.dtype = dtype
        if planes.device.type == "cuda":
            out = sample_triplanes_cuda(planes, coords, box_warp)
        else:
            out = sample_triplanes_plain(planes, coords, box_warp)
        return out.to(dtype)

    @staticmethod
    def backward(ctx, g):
        planes_cl, coords = ctx.saved_tensors
        g = g.float()
        need_coords = ctx.needs_input_grad[1]
        cuda = g.device.type == "cuda"
        splat = triplane_splat_cuda if cuda else triplane_splat_plain
        mode = os.environ.get("TGI_SPLAT", "pack")
        if mode in ("pack", "v1"):
            # One kernel serves tgi's packed (#4) and serialized (#5)
            # splats.
            d_planes, d_coords = splat(planes_cl, coords, g, ctx.box_warp,
                                       need_coords)
        elif mode == "mxu":
            H, W = planes_cl.shape[2:4]
            sorted_splat = (triplane_splat_sorted_cuda if cuda
                            else triplane_splat_sorted_plain)
            d_planes = sorted_splat(coords, g, ctx.box_warp, H, W)
            d_coords = None
            if need_coords:
                _, d_coords = splat(planes_cl, coords, g, ctx.box_warp, True,
                                    want_dplanes=False)
        else:
            raise ValueError(f"TGI_SPLAT={mode!r}: expected 'pack', 'v1' "
                             f"or 'mxu'")
        return (d_planes.permute(0, 1, 4, 2, 3).to(ctx.dtype), d_coords,
                None)


def sample_triplanes(planes: torch.Tensor, coords: torch.Tensor,
                     box_warp: float) -> torch.Tensor:
    """Sample tri-plane features at 3D points, differentiably.

    ``tgi``'s ``point_layout`` hint orders the TPU splat and has no
    counterpart here.

    Args:
        planes: ``[N, 3, C, H, W]`` tri-plane features, float32 or
            bfloat16 (sampled in float32).
        coords: ``[N, M, 3]`` world coordinates, float32.
        box_warp: side length of the [-box/2, box/2] volume.

    Returns:
        ``[N, 3, M, C]`` per-plane bilinear features in the planes' dtype
        (zeros outside the box), through :class:`TriplaneSample`: CPU
        tensors take the plain versions, CUDA tensors the kernels.
    """
    if planes.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no tri-plane sampler for device {planes.device}")
    return TriplaneSample.apply(planes, coords, box_warp)
