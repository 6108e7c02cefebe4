"""Row-fetch bench: the forward tri-plane gather's formulations side by
side (twin of ``scripts/bench_gather_vmem.py``).

    python -m tgi_torch.scripts.bench_gather_vmem [--device cuda]
        [--rays 64 64] [--samples 48] [--res 256]

G = 3 planes of C = 32 channels at ``--res``² cells, footprint-expanded
to ``[G, res², 128]`` (``pack.expand_footprint``), fetched at the cells
of P = Ry·Rx·S frustum-march points (pinhole rays, not uniform random:
spatial locality sets the tile walk's pass count):

  A. torch indexing, fp32 (the library call; XLA's take_along_axis)
  B. torch indexing, bf16
  C. gather_rows, fp32 (csrc/gather_rows.cu)
  D. gather_rows, bf16
  E. gather_rows_tilewalk, bf16, block-local order + unperm
     (csrc/gather_tilewalk.cu)
  F. gather_rows_tilewalk, bf16, ray-major order
  G. E in fp32

beside the fused gather + lerp (``csrc/triplane_gather.cu``) on the same
points, and the tile walk's mean passes per 512-point block in both
orders. Correctness comes first: C, D, E and G against A's indexing
(each must print 0). Times are medians of ``scripts.ITERS`` calls after
``scripts.WARMUP``, on CUDA events; on the CPU every wrapper takes its
plain version and times are the host's.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tgi_torch.ops import grid_sample as gs
from tgi_torch.ops.gather_rows import gather_rows, gather_rows_tilewalk
from tgi_torch.ops.pack import (TILE, block_local_perm, expand_footprint,
                                reorder_perm_shape, tiled_cell)
from tgi_torch.scripts import (SEED, device_label, frustum_points,
                               median_ms)

G, C = 3, 32
BOX_WARP = 2.0   # world points are scaled by 2 / BOX_WARP = 1 onto the planes


def ray_points(Ry=64, Rx=64, S=48) -> np.ndarray:
    """Frustum-march world points ``[Ry*Rx*S, 3]`` (float32, ray-major),
    clipped to [-1.05, 1.05]: their plane projections are the TPU
    bench's coords."""
    return np.clip(frustum_points(Ry, Rx, S), -1.05, 1.05).astype(np.float32)


def ray_coords(Ry=64, Rx=64, S=48) -> torch.Tensor:
    """The points' projections onto the three planes, ``[3, P, 2]``:
    (x, y), (x, z), (z, x)."""
    pts = torch.from_numpy(ray_points(Ry, Rx, S))
    return gs.project_onto_planes(pts[None])[0]


def untile_plane(e: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Row-major ``[G, H*W, L]`` -> 16x16-tile row numbering (the name is
    the TPU bench's)."""
    n, L = e.shape[0], e.shape[-1]
    t = e.reshape(n, H // TILE, TILE, W // TILE, TILE, L)
    return t.permute(0, 1, 3, 2, 4, 5).reshape(n, H * W, L)


def unperm(out: torch.Tensor, layout) -> torch.Tensor:
    """Block-local point order back to ray-major (a static transpose)."""
    n, P, L = out.shape
    dims, axes = reorder_perm_shape(P, layout)
    r = out.reshape((n,) + tuple(dims[a] for a in axes) + (L,))
    inv = tuple(int(a) for a in np.argsort(axes))
    return r.permute((0,) + tuple(a + 1 for a in inv) + (6,)).reshape(n, P, L)


def make_inputs(device, Ry=64, Rx=64, S=48, res=256) -> dict:
    """The bench's tensors on ``device``: planes, their expanded and
    tile-numbered copies in fp32 and bf16, and the points' cells
    row-major, tile-numbered, and tile-numbered in block-local order."""
    device = torch.device(device)
    H = W = res
    layout = (Ry, Rx, S)
    gen = torch.Generator().manual_seed(SEED)
    planes = torch.randn(G, C, H, W, generator=gen)
    exp32 = expand_footprint(planes)
    x0, y0, _, _ = gs._point_indices(ray_coords(Ry, Rx, S), H, W)
    y0c = y0.clamp(0, H - 1)
    x0c = x0.clamp(0, W - 1)
    cells = (y0c * W + x0c).int()
    cells_tiled = tiled_cell(y0c, x0c, W).int()
    perm = block_local_perm(layout)
    t = {"planes_cl": planes[None],
         "points": torch.from_numpy(ray_points(Ry, Rx, S))[None],
         "exp32": exp32, "exp16": exp32.bfloat16(),
         "exp32_t": untile_plane(exp32, H, W),
         "cells": cells, "cells_tiled": cells_tiled,
         "cells_tiled_blocked": cells_tiled[:, perm].contiguous()}
    t["exp16_t"] = t["exp32_t"].bfloat16()
    t = {k: v.to(device) for k, v in t.items()}
    t["planes_cl"] = gs.channels_last(t["planes_cl"])   # [1, 3, C, H, W]
    t["cells_long"] = t["cells"].long()
    t["plane_idx"] = torch.arange(G, device=device)[:, None]
    t["layout"] = layout
    return t


def index_rows(t, exp):
    """The library call: torch advanced indexing (A, B)."""
    return exp[t["plane_idx"], t["cells_long"]]


def fused_gather(t):
    """The fused gather + lerp of ``csrc/triplane_gather.cu`` (its plain
    version on the CPU) at the same points."""
    if t["points"].device.type == "cuda":
        return gs.sample_triplanes_cuda(t["planes_cl"], t["points"], BOX_WARP)
    return gs.sample_triplanes_plain(t["planes_cl"], t["points"], BOX_WARP)


def max_abs(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


@torch.no_grad()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rays", type=int, nargs=2, default=(64, 64),
                    metavar=("RY", "RX"))
    ap.add_argument("--samples", type=int, default=48)
    ap.add_argument("--res", type=int, default=256)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    Ry, Rx = args.rays
    t = make_inputs(device, Ry, Rx, args.samples, args.res)
    layout = t["layout"]
    P = Ry * Rx * args.samples
    print(f"device: {device_label(device)}; G={G} C={C} {args.res}² planes, "
          f"P={P} points per plane (rays {Ry}x{Rx}, {args.samples} samples)",
          flush=True)

    ref = index_rows(t, t["exp32"])
    ref16 = index_rows(t, t["exp16"])
    err = {
        "C gather_rows fp32": max_abs(gather_rows(t["exp32"], t["cells"]),
                                      ref),
        "D gather_rows bf16": max_abs(gather_rows(t["exp16"], t["cells"]),
                                      ref16),
        "E tile walk bf16": max_abs(unperm(gather_rows_tilewalk(
            t["exp16_t"], t["cells_tiled_blocked"]), layout), ref16),
        "G tile walk fp32": max_abs(unperm(gather_rows_tilewalk(
            t["exp32_t"], t["cells_tiled_blocked"]), layout), ref),
    }
    for name, e in err.items():
        print(f"{name} max|d| vs indexing: {e}", flush=True)

    def tilewalk(exp, cells, back):
        out = gather_rows_tilewalk(exp, cells)
        return unperm(out, layout) if back else out

    variants = {
        "A torch indexing fp32": lambda: index_rows(t, t["exp32"]),
        "B torch indexing bf16": lambda: index_rows(t, t["exp16"]),
        "C gather_rows fp32": lambda: gather_rows(t["exp32"], t["cells"]),
        "D gather_rows bf16": lambda: gather_rows(t["exp16"], t["cells"]),
        "E tile walk bf16 blocked+unperm": lambda: tilewalk(
            t["exp16_t"], t["cells_tiled_blocked"], True),
        "F tile walk bf16 ray-major (no reorder)": lambda: tilewalk(
            t["exp16_t"], t["cells_tiled"], False),
        "G tile walk fp32 blocked+unperm": lambda: tilewalk(
            t["exp32_t"], t["cells_tiled_blocked"], True),
        "fused gather + lerp fp32 (triplane_gather)": lambda: fused_gather(t),
    }
    ms = {}
    for name, fn in variants.items():
        ms[name] = median_ms(fn, device)
        print(f"{name:56s} {ms[name]:9.4f} ms", flush=True)

    passes = {}
    for order, key in (("block-local", "cells_tiled_blocked"),
                       ("ray-major", "cells_tiled")):
        _, n = gather_rows_tilewalk(t["exp16_t"], t[key], return_passes=True)
        passes[order] = n.float().mean().item()
        print(f"tile walk passes per 512-point block, {order}: "
              f"{passes[order]:.3f}", flush=True)
    return {"device": str(device), "P": P, "max_abs": err, "ms": ms,
            "passes": passes}


if __name__ == "__main__":
    main()
