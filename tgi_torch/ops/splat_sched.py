"""Packed bilinear splat under a fixed window schedule (twin of
``scripts/bench_splat_sched.py``'s ``run_kernel``, the TPU kernel at
:118 with the bodies ``_kernel_static`` :36 and ``_kernel_nbhd`` :62,
and of ``tgi/ops/pallas/splat_pack.py``'s body ``_kernel`` :47).

``acc[g, rows[g, e]] += float(wg[g, e])`` for bf16 payloads
``wg [G, E, 128]`` (four corner slots x 32 channels, ``pack.
pack_footprint``'s weights times the feature gradient) and int32
tile-numbered ``rows [G, E]``, into a zeroed fp32 ``[G, H*W, 128]``, over
the entries that the schedule adds. Per 512-entry block:

* ``walk`` (bench variant A, the production kernel): every entry, window
  by window, each window found from the smallest row not yet done;
* ``static9`` (variant B): only the entries in the 9 consecutive windows
  from the block's first entry's window, clamped to ``H*W - 9*256`` —
  wrong by design, for timing the schedule;
* ``nbhd`` (variant C): every entry, through the 4x4 tile neighbourhood
  at the block's smallest window coordinates, then a walk over the rest.

Rows outside ``[0, H*W)`` are dropped. :func:`splat_sched` takes the
plain version (the schedule's mask, then ``index_add_``) for a CPU
tensor and launches ``csrc/splat_sched.cu`` for a CUDA tensor, or
raises. The kernel sums a warp's entries of one row in registers and
adds them with one float4 atomic per lane, so its last bits change from
run to run.
"""

from __future__ import annotations

import ctypes

import torch

from tgi_torch.ops.pack import ENTRY_BLOCK, TILE, WINDOW

SCHEDULES = ("walk", "static9", "nbhd")
LANES = 128

# Launches of the CUDA kernel since the count was last set to 0.
SPLAT_SCHED_LAUNCHES = 0


def _check(rows: torch.Tensor, wg: torch.Tensor, H: int, W: int,
           schedule: str):
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; one of "
                         f"{SCHEDULES}")
    if rows.ndim != 2 or tuple(wg.shape) != (*rows.shape, LANES):
        raise ValueError(f"rows must be [G, E] and wg [G, E, {LANES}], got "
                         f"{tuple(rows.shape)} and {tuple(wg.shape)}")
    if rows.dtype != torch.int32 or wg.dtype != torch.bfloat16:
        raise TypeError(f"rows int32 and wg bfloat16, got {rows.dtype} and "
                        f"{wg.dtype}")
    if rows.device != wg.device:
        raise ValueError(f"rows on {rows.device}, wg on {wg.device}")
    if H <= 0 or W <= 0 or H % TILE or W % TILE:
        raise ValueError(f"a tile-numbered plane has H and W multiples of "
                         f"{TILE}, got {H}x{W}")
    if schedule != "walk" and (H < 4 * TILE or W < 4 * TILE
                               or H * W < 9 * WINDOW):
        raise ValueError(f"{schedule} needs H, W >= {4 * TILE} and H*W >= "
                         f"{9 * WINDOW}, got {H}x{W}")


def schedule_mask(rows: torch.Tensor, H: int, W: int,
                  schedule: str) -> torch.Tensor:
    """bool ``[G, E]``: the entries that ``schedule`` adds."""
    HW = H * W
    valid = (rows >= 0) & (rows < HW)
    if schedule != "static9":
        return valid
    first = rows[:, ::ENTRY_BLOCK].long()
    first = (torch.div(first, WINDOW, rounding_mode="floor") * WINDOW
             ).clamp(max=HW - 9 * WINDOW)
    base = first.repeat_interleave(ENTRY_BLOCK, dim=1)[:, :rows.shape[1]]
    return valid & (rows >= base) & (rows < base + 9 * WINDOW)


def splat_sched_plain(rows: torch.Tensor, wg: torch.Tensor, H: int, W: int,
                      schedule: str) -> torch.Tensor:
    """Plain PyTorch splat (the kernel's reference): ``[G, H*W, 128]``
    fp32."""
    _check(rows, wg, H, W, schedule)
    G = rows.shape[0]
    HW = H * W
    mask = schedule_mask(rows, H, W, schedule)
    base = torch.arange(G, device=rows.device)[:, None] * HW
    acc = torch.zeros((G * HW, LANES), dtype=torch.float32,
                      device=rows.device)
    acc.index_add_(0, (base + rows)[mask], wg[mask].float())
    return acc.reshape(G, HW, LANES)


def splat_sched_cuda(rows: torch.Tensor, wg: torch.Tensor, H: int, W: int,
                     schedule: str) -> torch.Tensor:
    """:func:`splat_sched_plain` through ``csrc/splat_sched.cu``."""
    global SPLAT_SCHED_LAUNCHES
    from tgi_torch.ops import _native

    _check(rows, wg, H, W, schedule)
    if not (rows.is_contiguous() and wg.is_contiguous()):
        raise ValueError("rows and wg must be contiguous")
    if wg.data_ptr() % 8:
        raise ValueError("wg must start on an 8-byte boundary: each lane "
                         "loads four bf16 at once")
    dev = wg.device
    if dev.type != "cuda":
        raise ValueError(f"wg on {dev}: the kernel needs a CUDA tensor")
    G, E = rows.shape
    if G > 65535 or E == 0:
        raise ValueError(f"shape out of the kernel's range: G={G}, E={E}")
    acc = torch.zeros((G, H * W, LANES), dtype=torch.float32, device=dev)
    lib = _native.library("splat_sched.cu")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.tgi_splat_sched(
        ctypes.c_void_p(wg.data_ptr()), ctypes.c_void_p(rows.data_ptr()),
        ctypes.c_void_p(acc.data_ptr()), G, E, H, W,
        SCHEDULES.index(schedule), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"splat_sched launch failed: "
                           f"{_native.error_string(err)} ({err})")
    SPLAT_SCHED_LAUNCHES += 1
    return acc


def splat_sched(rows: torch.Tensor, wg: torch.Tensor, H: int, W: int,
                schedule: str) -> torch.Tensor:
    """The packed splat of ``rows``/``wg`` onto a tile-numbered
    ``[G, H*W, 128]`` fp32 accumulator under ``schedule`` (one of
    :data:`SCHEDULES`). A CPU tensor takes :func:`splat_sched_plain`; a
    CUDA tensor launches ``csrc/splat_sched.cu``."""
    if wg.device.type == "cpu":
        return splat_sched_plain(rows, wg, H, W, schedule)
    return splat_sched_cuda(rows, wg, H, W, schedule)
