"""Row fetches from a footprint-expanded tri-plane (twin of
``tgi/ops/pallas/gather_vmem.py``).

``out[g, p, :] = exp[g, cells[g, p], :]`` for ``exp [G, HW, L]`` in fp32
or bf16 and int32 ``cells [G, P]``, in two forms:

* :func:`gather_rows` — one row read per point. Replaces the TPU
  kernels ``gather_rows_vmem`` (``gather_vmem.py:62``, as its raw fp32
  fetch; the fused form with the bilinear lerp is
  ``csrc/triplane_gather.cu``) and ``gather_rows_vmem_bf16``
  (``gather_vmem.py:98``). Kernel: ``csrc/gather_rows.cu``.
* :func:`gather_rows_tilewalk` — the same fetch from a plane whose rows
  are numbered in 16x16 cell tiles (``pack.tiled_cell``), and the
  number of 256-row windows the TPU kernel's walk visits per 512-point
  block. Replaces ``gather_rows_mxu`` (``gather_vmem.py:160``). Kernel:
  ``csrc/gather_tilewalk.cu``, which reads only the rows a block
  touches. The result does not depend on the point order; the order
  sets the number of passes per block, which ``return_passes``
  reports.

A cell outside ``[0, HW)`` gives a zero row (the TPU kernels leave it
undefined). Each wrapper takes its plain version (advanced indexing) for
a CPU tensor and launches its kernel for a CUDA tensor, or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tgi_torch.ops.pack import ENTRY_BLOCK, WINDOW

# Launches of the CUDA kernels since the counts were last set to 0.
GATHER_ROWS_LAUNCHES = 0     # gather_rows.cu
TILEWALK_LAUNCHES = 0        # gather_tilewalk.cu


def _check(exp: torch.Tensor, cells: torch.Tensor):
    if exp.ndim != 3 or cells.ndim != 2 or cells.shape[0] != exp.shape[0]:
        raise ValueError(f"exp must be [G, HW, L] and cells [G, P], got "
                         f"{tuple(exp.shape)} and {tuple(cells.shape)}")
    if exp.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"exp must be float32 or bfloat16, got {exp.dtype}")
    if cells.dtype != torch.int32:
        raise TypeError(f"cells must be int32, got {cells.dtype}")
    if cells.device != exp.device:
        raise ValueError(f"exp on {exp.device}, cells on {cells.device}")


def _check_tiled(exp: torch.Tensor):
    HW = exp.shape[1]
    if HW < WINDOW or HW % WINDOW:
        raise ValueError(f"a tile-numbered plane has a multiple of "
                         f"{WINDOW} rows, got {HW}")


def gather_rows_plain(exp: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch row fetch (the kernels' reference): ``[G, P, L]``."""
    _check(exp, cells)
    G, HW, _ = exp.shape
    ok = (cells >= 0) & (cells < HW)
    idx = torch.where(ok, cells, 0).long()
    out = exp[torch.arange(G, device=exp.device)[:, None], idx]
    return out.masked_fill_(~ok[..., None], 0)


def tilewalk_passes_plain(cells: torch.Tensor, nrows: int) -> torch.Tensor:
    """Passes of the tile walk per 512-point block, int32 ``[G, nb]``:
    the number of distinct 256-row windows among the block's in-range
    cells (the walk visits each such window once, and no other)."""
    G, P = cells.shape
    nb = -(-P // ENTRY_BLOCK)
    win = torch.where((cells >= 0) & (cells < nrows),
                      cells.long() // WINDOW, -1)
    win = F.pad(win, (0, nb * ENTRY_BLOCK - P), value=-1)
    s = win.reshape(G, nb, ENTRY_BLOCK).sort(-1).values
    new = (s[..., 1:] != s[..., :-1]) & (s[..., 1:] >= 0)
    return (new.sum(-1) + (s[..., 0] >= 0)).int()


def _launch_check(err: int, what: str):
    from tgi_torch.ops import _native
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{_native.error_string(err)} ({err})")


def _cuda_args(exp: torch.Tensor, cells: torch.Tensor):
    """Checks of a kernel's arguments -> (G, HW, P, row bytes)."""
    if exp.device.type != "cuda":
        raise ValueError(f"exp on {exp.device}: the kernel needs a CUDA "
                         f"tensor")
    if not (exp.is_contiguous() and cells.is_contiguous()):
        raise ValueError("exp and cells must be contiguous")
    G, HW, L = exp.shape
    P = cells.shape[1]
    row_bytes = L * exp.element_size()
    if row_bytes % 16 or exp.data_ptr() % 16:
        raise ValueError(f"rows of {row_bytes} bytes at {exp.data_ptr():#x}: "
                         f"the kernel copies 16-byte aligned chunks")
    if G > 65535 or P == 0:
        raise ValueError(f"shape out of the kernel's range: G={G}, P={P}")
    return G, HW, P, row_bytes


def gather_rows_cuda(exp: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
    """:func:`gather_rows_plain` through ``csrc/gather_rows.cu``."""
    global GATHER_ROWS_LAUNCHES
    from tgi_torch.ops import _native

    _check(exp, cells)
    G, HW, P, row_bytes = _cuda_args(exp, cells)
    out = torch.empty((G, P, exp.shape[2]), dtype=exp.dtype,
                      device=exp.device)
    lib = _native.library("gather_rows.cu")
    stream = torch.cuda.current_stream(exp.device).cuda_stream
    _launch_check(lib.tgi_gather_rows(
        ctypes.c_void_p(exp.data_ptr()), ctypes.c_void_p(cells.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), G, HW, P, row_bytes,
        ctypes.c_void_p(stream)), "gather_rows")
    GATHER_ROWS_LAUNCHES += 1
    return out


def gather_rows_tilewalk_cuda(exp_tiled: torch.Tensor,
                              cells_tiled: torch.Tensor,
                              return_passes: bool = False):
    """:func:`gather_rows_tilewalk` through ``csrc/gather_tilewalk.cu``."""
    global TILEWALK_LAUNCHES
    from tgi_torch.ops import _native

    _check(exp_tiled, cells_tiled)
    _check_tiled(exp_tiled)
    G, HW, P, row_bytes = _cuda_args(exp_tiled, cells_tiled)
    dev = exp_tiled.device
    out = torch.empty((G, P, exp_tiled.shape[2]), dtype=exp_tiled.dtype,
                      device=dev)
    passes = (torch.empty((G, -(-P // ENTRY_BLOCK)), dtype=torch.int32,
                          device=dev) if return_passes else None)
    lib = _native.library("gather_tilewalk.cu")
    stream = torch.cuda.current_stream(dev).cuda_stream
    _launch_check(lib.tgi_gather_tilewalk(
        ctypes.c_void_p(exp_tiled.data_ptr()),
        ctypes.c_void_p(cells_tiled.data_ptr()),
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(passes.data_ptr() if return_passes else None),
        G, HW, P, row_bytes, ctypes.c_void_p(stream)), "gather_tilewalk")
    TILEWALK_LAUNCHES += 1
    return (out, passes) if return_passes else out


def gather_rows(exp: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
    """``out[g, p] = exp[g, cells[g, p]]``: ``exp [G, HW, L]`` fp32 or
    bf16, ``cells [G, P]`` int32 -> ``[G, P, L]`` in ``exp``'s type.

    Replaces ``tgi/ops/pallas/gather_vmem.py:98``
    (``gather_rows_vmem_bf16``) and the raw fp32 fetch of :62
    (``gather_rows_vmem``). A CPU tensor takes :func:`gather_rows_plain`;
    a CUDA tensor launches ``csrc/gather_rows.cu``."""
    if exp.device.type == "cpu":
        return gather_rows_plain(exp, cells)
    return gather_rows_cuda(exp, cells)


def gather_rows_tilewalk(exp_tiled: torch.Tensor, cells_tiled: torch.Tensor,
                         return_passes: bool = False):
    """The row fetch from a tile-numbered plane by the tile walk of
    ``tgi/ops/pallas/gather_vmem.py:160`` (``gather_rows_mxu``).

    ``exp_tiled [G, HW, L]`` (HW a multiple of 256) fp32 or bf16,
    ``cells_tiled [G, P]`` int32 tile-numbered rows, in any order ->
    ``[G, P, L]``, and with ``return_passes`` also the walk's passes per
    512-point block (int32 ``[G, ceil(P / 512)]``). A CPU tensor takes
    :func:`gather_rows_plain` and :func:`tilewalk_passes_plain`; a CUDA
    tensor launches ``csrc/gather_tilewalk.cu``."""
    if exp_tiled.device.type != "cpu":
        return gather_rows_tilewalk_cuda(exp_tiled, cells_tiled,
                                         return_passes)
    _check_tiled(exp_tiled)
    out = gather_rows_plain(exp_tiled, cells_tiled)
    if not return_passes:
        return out
    return out, tilewalk_passes_plain(cells_tiled, exp_tiled.shape[1])
