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

:func:`sample_triplanes` is one ``torch.autograd.Function``,
:class:`TriplaneSample`, on both devices: a CPU tensor takes the plain
versions, a CUDA tensor the kernels. A CUDA tensor never takes a plain
version: the kernel launches or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

# Launches of the CUDA kernels since the counts were last set to 0.
LAUNCHES = 0          # triplane_gather
SPLAT_LAUNCHES = 0    # triplane_splat


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


def triplane_splat_plain(planes_cl, coords, g, box_warp, need_coords):
    """Plain PyTorch backward of tri-plane sampling (the splat kernel's
    reference, and what a CPU tensor takes).

    planes_cl: ``[N, 3, H, W, C]`` planes (channels last; read only for
    the point gradient). coords: ``[N, M, 3]`` world points. g:
    ``[N, 3, M, C]`` gradient of the sampled features.

    Returns ``(d_planes [N, 3, H, W, C], d_coords [N, M, 3] or None)``.
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
    d_flat = torch.zeros((G * H * W, C), dtype=torch.float32, device=g.device)
    corners = {}
    for (dy, dx), w in (((0, 0), (1 - wx) * (1 - wy)),
                        ((0, 1), wx * (1 - wy)),
                        ((1, 0), (1 - wx) * wy),
                        ((1, 1), wx * wy)):
        yy, xx = y0 + dy, x0 + dx
        ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        cell = base + yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
        d_flat.index_add_(0, cell[ok], (w * gg)[ok])
        if need_coords:
            corners[dy, dx] = flat[cell] * ok[..., None].to(flat.dtype)
    d_planes = d_flat.reshape(N, 3, H, W, C)
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


def triplane_splat_cuda(planes_cl, coords, g, box_warp, need_coords):
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
    if need_coords:
        planes_cl = planes_cl.contiguous()
    g = g.contiguous()
    d_planes = torch.empty((N, 3, H, W, C), dtype=torch.float32, device=dev)
    d_coords = (torch.empty((N, M, 3), dtype=torch.float32, device=dev)
                if need_coords else None)
    lib = _native.library("triplane_splat.cu")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.tgi_triplane_splat_f32(
        ctypes.c_void_p(g.data_ptr()), ctypes.c_void_p(coords.data_ptr()),
        ctypes.c_void_p(planes_cl.data_ptr() if need_coords else None),
        ctypes.c_void_p(d_planes.data_ptr()),
        ctypes.c_void_p(d_coords.data_ptr() if need_coords else None),
        N, H, W, C, M, ctypes.c_float(2.0 / box_warp),
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"triplane_splat launch failed: "
                           f"{_native.error_string(err)} ({err})")
    SPLAT_LAUNCHES += 1
    return d_planes, d_coords


class TriplaneSample(torch.autograd.Function):
    """Tri-plane sampling with its hand-written backward (twin of
    ``_gsp_tpu_for``'s ``custom_vjp``, ``grid_sample.py:156``).

    It saves only the planes (channels last) and the points; the
    backward re-reads the four corners from the planes where the point
    gradient is asked for. A CPU tensor takes the plain versions, a CUDA
    tensor the kernels.
    """

    @staticmethod
    def forward(ctx, planes, coords, box_warp):
        planes_cl = planes.permute(0, 1, 3, 4, 2).contiguous()  # no-op if CL
        ctx.save_for_backward(planes_cl, coords)
        ctx.box_warp = box_warp
        if planes.device.type == "cuda":
            return sample_triplanes_cuda(planes, coords, box_warp)
        return sample_triplanes_plain(planes, coords, box_warp)

    @staticmethod
    def backward(ctx, g):
        planes_cl, coords = ctx.saved_tensors
        need_coords = ctx.needs_input_grad[1]
        splat = (triplane_splat_cuda if g.device.type == "cuda"
                 else triplane_splat_plain)
        d_planes, d_coords = splat(planes_cl, coords, g, ctx.box_warp,
                                   need_coords)
        return d_planes.permute(0, 1, 4, 2, 3), d_coords, None


def sample_triplanes(planes: torch.Tensor, coords: torch.Tensor,
                     box_warp: float) -> torch.Tensor:
    """Sample tri-plane features at 3D points, differentiably.

    ``tgi``'s ``point_layout`` hint orders the TPU splat and has no
    counterpart here.

    Args:
        planes: ``[N, 3, C, H, W]`` tri-plane features.
        coords: ``[N, M, 3]`` world coordinates.
        box_warp: side length of the [-box/2, box/2] volume.

    Returns:
        ``[N, 3, M, C]`` per-plane bilinear features (zeros outside the
        box), through :class:`TriplaneSample`: CPU tensors take the plain
        versions, CUDA tensors the kernels.
    """
    if planes.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no tri-plane sampler for device {planes.device}")
    return TriplaneSample.apply(planes, coords, box_warp)
