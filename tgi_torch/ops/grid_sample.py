"""Tri-plane bilinear sampling — the render's hot spot (twin of
``tgi/ops/grid_sample.py``'s forward).

Two implementations of one function, ``[N, 3, C, H, W]`` planes sampled
at ``[N, M, 3]`` world points into ``[N, 3, M, C]`` features:

* :func:`sample_triplanes_plain` — plain PyTorch: the 4-corner
  formulation of ``_grid_sample_points_impl`` (``align_corners=False``
  unnormalise, floor, zero padding, lerp order
  ``top = v00+(v01-v00)*wx; bot = v10+(v11-v10)*wx; out = top+(bot-top)*wy``).
* :func:`sample_triplanes_cuda` — the hand-written CUDA kernel
  ``csrc/triplane_gather.cu``, which replaces the TPU kernel
  ``tgi/ops/pallas/gather_vmem.py::gather_rows_vmem`` together with its
  caller's epilogue (``grid_sample.py:192-213``).

:func:`sample_triplanes` picks by device: the plain version for a CPU
tensor, the kernel for a CUDA tensor. A CUDA tensor never takes the plain
version: the kernel launches or the call raises.

Forward only: the backward (the splat kernels) comes with inversion.
"""

from __future__ import annotations

import ctypes

import torch

# Launches of the CUDA kernel since the count was last set to 0.
LAUNCHES = 0


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
    lib = _native.library()
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


def sample_triplanes(planes: torch.Tensor, coords: torch.Tensor,
                     box_warp: float) -> torch.Tensor:
    """Sample tri-plane features at 3D points.

    ``tgi``'s ``point_layout`` hint orders the TPU splat and has no
    counterpart here.

    Args:
        planes: ``[N, 3, C, H, W]`` tri-plane features.
        coords: ``[N, M, 3]`` world coordinates.
        box_warp: side length of the [-box/2, box/2] volume.

    Returns:
        ``[N, 3, M, C]`` per-plane bilinear features (zeros outside the
        box). CPU tensors take the plain version, CUDA tensors the kernel.
    """
    if planes.device.type == "cuda":
        return sample_triplanes_cuda(planes, coords, box_warp)
    if planes.device.type == "cpu":
        return sample_triplanes_plain(planes, coords, box_warp)
    raise ValueError(f"no tri-plane sampler for device {planes.device}")
