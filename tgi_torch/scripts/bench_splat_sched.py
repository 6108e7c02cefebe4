"""Splat-schedule bench: the packed splat's window schedules side by side
(twin of ``scripts/bench_splat_sched.py``).

    python -m tgi_torch.scripts.bench_splat_sched [--device cuda]
        [--rays 64 64] [--samples 48] [--res 256]

G = 3 planes at ``--res``² cells, P = Ry·Rx·S frustum-march points per
plane, each packed into one entry (``pack.pack_footprint``): a bf16
payload ``wg = w4s ⊗ g`` of 4 corner slots x C = 32 channels onto one
tile-numbered row, in block-local order (``pack.reorder_perm_shape``).
``csrc/splat_sched.cu`` adds them onto a zeroed fp32 ``[G, res², 128]``
under three schedules:

  A. walk: the production schedule (tgi's ``splat_pack._kernel``)
  B. static9: 9 consecutive windows per block, timing only (wrong by
     design: entries outside them are dropped)
  C. nbhd: the 4x4 tile neighbourhood + a walk over the rest (exact)

beside the library call (``index_add_`` of the upcast payload) and the
fused splat ``csrc/triplane_splat.cu`` on the same points, and C's and
A's distance from the ``index_add_`` sum (``C max|d| vs A``). Times are
medians of ``scripts.ITERS`` calls after ``scripts.WARMUP``, on CUDA
events; on the CPU every wrapper takes its plain version and times are
the host's.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tgi_torch.ops import grid_sample as gs
from tgi_torch.ops.pack import block_local_perm, pack_footprint
from tgi_torch.ops.splat_sched import splat_sched
from tgi_torch.scripts import (SEED, device_label, frustum_points,
                               median_ms)

G, C = 3, 32
BOX_WARP = 2.0   # world points are scaled by 2 / BOX_WARP = 1 onto the planes


def ray_cells(Ry=64, Rx=64, S=48, H=256, W=256):
    """The points' footprint anchors ``(y0, x0)``, int64 ``[3, P]``,
    on the planes (x, y), (x, z), (z, x), clipped to ``[0, H-2]`` and
    ``[0, W-2]``."""
    pts = frustum_points(Ry, Rx, S)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    proj = np.stack([np.stack([x, y], -1), np.stack([x, z], -1),
                     np.stack([z, x], -1)])
    ix = np.clip((proj[..., 0] + 1) * (W / 2) - 0.5, 0, W - 2)
    iy = np.clip((proj[..., 1] + 1) * (H / 2) - 0.5, 0, H - 2)
    return (torch.from_numpy(np.floor(iy)).long(),
            torch.from_numpy(np.floor(ix)).long())


def make_inputs(device, Ry=64, Rx=64, S=48, res=256) -> dict:
    """The bench's tensors on ``device``: the packed entries in
    block-local order (``rows`` int32 ``[G, P]``, ``wg`` bf16
    ``[G, P, 128]``), the flat int64 rows of the ``index_add_`` call, and
    the fused splat's inputs at the same points."""
    device = torch.device(device)
    H = W = res
    P = Ry * Rx * S
    y0, x0 = ray_cells(Ry, Rx, S, H, W)
    gen = torch.Generator().manual_seed(SEED)
    w4 = torch.rand(G, P, 4, generator=gen)
    grads = torch.randn(G, P, C, generator=gen)
    cell, w4s = pack_footprint(y0, x0, w4, H, W)
    wg = (w4s[..., :, None] * grads[..., None, :]).reshape(
        G, P, 4 * C).bfloat16()
    perm = block_local_perm((Ry, Rx, S))
    # The fused splat's world points: anchors inside [0, res-2] as above.
    lim = (-1 + 1.0 / W, 1 - 3.0 / W)
    pts = np.clip(frustum_points(Ry, Rx, S), *lim).astype(np.float32)
    t = {"rows": cell[:, perm].int().contiguous(),
         "wg": wg[:, perm].contiguous(),
         "points": torch.from_numpy(pts)[None],
         "g": grads[None].contiguous(),
         "planes_cl": torch.zeros(1, G, H, W, C)}   # not read without d_coords
    t = {k: v.to(device) for k, v in t.items()}
    t["flat_rows"] = (torch.arange(G, device=device)[:, None] * (H * W)
                      + t["rows"]).reshape(-1)
    t["H"] = t["W"] = res
    return t


def index_add(t):
    """The library call: ``index_add_`` of the upcast payload."""
    H, W = t["H"], t["W"]
    acc = torch.zeros((G * H * W, 4 * C), dtype=torch.float32,
                      device=t["wg"].device)
    acc.index_add_(0, t["flat_rows"], t["wg"].reshape(-1, 4 * C).float())
    return acc.reshape(G, H * W, 4 * C)


def fused_splat(t):
    """``csrc/triplane_splat.cu`` (its plain version on the CPU) at the
    same points, ``d_planes`` only."""
    fn = (gs.triplane_splat_cuda if t["g"].device.type == "cuda"
          else gs.triplane_splat_plain)
    return fn(t["planes_cl"], t["points"], t["g"], BOX_WARP, False)[0]


def max_abs(a, b) -> float:
    return (a - b).abs().max().item()


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
    H = W = args.res
    P = Ry * Rx * args.samples
    print(f"device: {device_label(device)}; G={G} {args.res}² planes, "
          f"P={P} entries per plane (rays {Ry}x{Rx}, {args.samples} "
          f"samples), bf16 payload of 128, block-local order", flush=True)

    def run(schedule):
        return lambda: splat_sched(t["rows"], t["wg"], H, W, schedule)

    variants = {"A walk (production)": run("walk"),
                "B static 9-pass (timing only)": run("static9"),
                "C 4x4 neighborhood + residual": run("nbhd"),
                "index_add_ of the upcast payload": lambda: index_add(t),
                "fused splat fp32 (triplane_splat)": lambda: fused_splat(t)}
    ms = {}
    for name, fn in variants.items():
        ms[name] = median_ms(fn, device)
        print(f"{name:56s} {ms[name]:9.4f} ms", flush=True)

    want = index_add(t)
    scale = max(1.0, want.abs().max().item())
    out_a = run("walk")()
    err = {"C max|d| vs A": max_abs(run("nbhd")(), out_a),
           "A max|d| vs index_add_": max_abs(out_a, want)}
    for name, e in err.items():
        print(f"{name}: {e} (max(1, max|index_add_|) = {scale:.4g})",
              flush=True)
    return {"device": str(device), "P": P, "max_abs": err, "scale": scale,
            "ms": ms}


if __name__ == "__main__":
    main()
