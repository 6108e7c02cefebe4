#!/usr/bin/env python3
"""Smoke run of tgi_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. environment: versions, the card, its power limit;
  2. build every CUDA kernel from tgi_torch/csrc with nvcc;
  3. each kernel against its plain PyTorch version, at the full-width
     shapes and at small ragged ones;
  4. the port's generation path at full width — the FFHQ-rebalanced 512
     generator (z/w 512, 256² backbone with 3 x 32-channel planes, 128²
     rays, 48 + 48 samples, SuperresolutionHybrid8XDC), weights drawn
     from a seed — through ``generate_samples`` for 2 seeds x 3 yaws:
     finite images, views that differ, depths inside [ray_start,
     ray_end], 2 kernel launches per render, the same image with the
     plain sampler swapped in, and a small generator that agrees with
     its CPU run (the CPU path is held against the JAX package by the
     tests);
  5. times: each kernel per launch (CUDA events, median) beside its
     plain version, a PyTorch library call computing the same function
     and the card's bound; one full-width render.

TF32 is off throughout, so every comparison is in full fp32.

The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the tgi_torch package beside it, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Device-memory rate by card name (NVIDIA data sheets); any other card is
# taken as an H100 SXM. fp32 peak outside the tensor cores: 67 TFLOP/s.
HBM_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                   ("H200", 4.8e12), ("", 3.35e12))
FP32_FLOPS = 67e12
KERNEL_TOL = 1e-5          # kernel vs plain, max abs (the same fp32 formula)
SWAP_TOL = 1e-4            # full render, kernel vs plain sampler, max abs
SMALL_CPU_TOL = 1e-4       # small generator, card vs CPU, max abs
DEPTH_RANGE = (2.25, 3.3)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def log(*args):
    print(*args, flush=True)


def cuda_ms(torch, fn, iters=30, warmup=3):
    """Median milliseconds of ``fn`` on the card, CUDA events per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def border_coords(H, W):
    """World points whose plane-0 corners sit on the plane's borders
    (x0 = -1, x0 = W-1, y0 = H-1, y0 = -1) and outside it (box_warp 1)."""
    def world(ix, iy):
        return [((ix + 0.5) * 2.0 / W - 1.0) / 2,
                ((iy + 0.5) * 2.0 / H - 1.0) / 2, 0.0]
    return [world(-0.3, 3.2), world(W - 0.6, 5.7), world(4.1, H - 0.4),
            world(2.5, -0.8), world(-0.5, -0.5), world(W + 3.0, 2.0)]


def phase_environment(torch):
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} (count {torch.cuda.device_count()})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN")
    bw = next(rate for key, rate in HBM_BYTES_PER_S if key in name)
    return name, card, bw


def phase_build():
    from tgi_torch.ops import _native
    t0 = time.perf_counter()
    libs = _native.build_all()
    log(f"build: {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, out in _native.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")


def phase_kernel_vs_plain(torch, gs):
    """Max abs error of the gather kernel against its plain version."""
    gen = torch.Generator().manual_seed(1)
    worst = 0.0
    for N, C, H, W, M in ((1, 32, 256, 256, 128 * 128 * 48),
                          (1, 8, 32, 32, 2085), (2, 16, 32, 32, 1037)):
        planes = torch.randn(N, 3, C, H, W, generator=gen).cuda()
        coords = torch.rand(N, M, 3, generator=gen) * 1.4 - 0.7
        coords[:, :6] = torch.tensor(border_coords(H, W))
        coords = coords.cuda()
        got = gs.sample_triplanes_cuda(gs.channels_last(planes), coords, 1.0)
        want = gs.sample_triplanes_plain(planes, coords, 1.0)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        log(f"triplane_gather vs plain: N={N} C={C} {H}x{W} M={M}: "
            f"max abs err {err:.3g}")
        check(err <= KERNEL_TOL, f"kernel disagrees with its plain version "
              f"by {err} > {KERNEL_TOL}")
        worst = max(worst, err)
    return worst


def full_width_generator(torch):
    from tgi_torch.models.generator import GeneratorConfig, TriPlaneGenerator
    G = TriPlaneGenerator(GeneratorConfig(neural_rendering_resolution=128))
    t0 = time.perf_counter()
    params = G.init(torch.Generator().manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    log(f"full-width generator: {n} parameters drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    return G, params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phase_generate(torch, gs, G, params, tmp):
    """PNGs go to ``tmp`` where PIL is installed; none are written
    otherwise."""
    from tgi_torch.apps.gen_samples import generate_samples
    try:
        import PIL  # noqa: F401
        outdir = tmp
    except ImportError:
        outdir = None
    seeds = [0, 1]
    angles = ((0.35, 0.0), (0.0, 0.0), (-0.35, 0.0))

    gs.LAUNCHES = 0
    t0 = time.perf_counter()
    res = generate_samples(G, params, seeds, angles=angles, outdir=outdir,
                           device="cuda")
    torch.cuda.synchronize()
    launches = gs.LAUNCHES
    log(f"generate_samples: {len(res)} renders in "
        f"{time.perf_counter() - t0:.1f} s, {launches} kernel launches, "
        f"PNGs: {outdir or 'none (no PIL)'}")
    check(launches == 2 * len(res),
          f"{launches} gather launches for {len(res)} renders, expected 2 each")

    for r in res:
        img, raw, depth = r["image"], r["image_raw"], r["image_depth"]
        check(tuple(img.shape) == (1, 3, 512, 512), f"image {img.shape}")
        check(tuple(raw.shape) == (1, 3, 128, 128), f"image_raw {raw.shape}")
        check(tuple(depth.shape) == (1, 1, 128, 128), f"depth {depth.shape}")
        check(bool(torch.isfinite(img).all() and torch.isfinite(raw).all()),
              "non-finite image")
        lo, hi = depth.min().item(), depth.max().item()
        check(DEPTH_RANGE[0] <= lo and hi <= DEPTH_RANGE[1],
              f"depth [{lo}, {hi}] outside {DEPTH_RANGE}")
    for s in range(len(seeds)):
        views = res[s * len(angles):(s + 1) * len(angles)]
        for a in range(1, len(views)):
            d = (views[a]["image"] - views[0]["image"]).abs().mean().item()
            check(d > 1e-3, f"seed {seeds[s]}: views 0 and {a} do not differ "
                  f"(mean abs diff {d})")
    d = (res[0]["image"] - res[len(angles)]["image"]).abs().mean().item()
    check(d > 1e-3, f"seeds do not differ (mean abs diff {d})")
    log(f"images finite, views and seeds differ, depth within {DEPTH_RANGE}")
    return res, launches


def render_once(torch, G, params):
    """The first render of phase_generate again: seed 0, yaw +0.35."""
    from tgi_torch.apps.gen_samples import seed_z
    from tgi_torch.render.cameras import (fov_to_intrinsics, look_at_pose,
                                          pack_camera)
    pivot = torch.tensor([0, 0, 0.2], dtype=torch.float32, device="cuda")
    intr = fov_to_intrinsics(18.837, device="cuda")
    cond = pack_camera(look_at_pose(math.pi / 2, math.pi / 2, pivot,
                                    radius=2.7, device="cuda")[None], intr)
    cam = pack_camera(look_at_pose(math.pi / 2 + 0.35, math.pi / 2, pivot,
                                   radius=2.7, device="cuda")[None], intr)
    with torch.no_grad():
        ws = G.mapping(params, seed_z(0, G.cfg.z_dim, "cuda"), cond,
                       truncation_psi=0.7, truncation_cutoff=14)
        return G.synthesis(params, ws, cam, det=True)


def phase_plain_swap(torch, gs, G, params, res):
    """The same render with the plain sampler: no launch, same image."""
    import tgi_torch.render.renderer as renderer
    before = gs.LAUNCHES
    renderer.sample_triplanes = gs.sample_triplanes_plain
    try:
        out = render_once(torch, G, params)
    finally:
        renderer.sample_triplanes = gs.sample_triplanes
    torch.cuda.synchronize()
    check(gs.LAUNCHES == before, "the plain render launched the kernel")
    err = {k: (out[k] - res[0][k]).abs().max().item()
           for k in ("image", "image_raw", "image_depth")}
    log(f"full render, plain sampler vs kernel: max abs err {err}")
    check(max(err.values()) <= SWAP_TOL,
          f"plain-sampler render differs by {err} > {SWAP_TOL}")


def phase_small_vs_cpu(torch):
    """A small generator on the card (kernel) against its CPU run (plain
    version, the path the tests hold against the JAX package)."""
    from tgi_torch.models.generator import (GeneratorConfig,
                                            TriPlaneGenerator,
                                            default_rendering_kwargs)
    from tgi_torch.render.cameras import (fov_to_intrinsics, look_at_pose,
                                          pack_camera)
    G = TriPlaneGenerator(GeneratorConfig(
        z_dim=32, w_dim=32, img_resolution=64, backbone_resolution=32,
        plane_channels=8, mapping_layers=2, channel_base=512,
        channel_max=32, neural_rendering_resolution=16,
        rendering_kwargs=default_rendering_kwargs(
            superresolution_module="SuperresolutionTiny", depth_resolution=8,
            depth_resolution_importance=8, image_resolution=64)))
    cpu = G.init(torch.Generator().manual_seed(3), device="cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        params = {k: _to(v, dev) for k, v in cpu.items()}
        z = torch.randn(1, 32, generator=torch.Generator().manual_seed(4))
        cam = look_at_pose(math.pi / 2 + 0.3, math.pi / 2,
                           torch.tensor([0, 0, 0.2]), radius=2.7, device=dev)
        c = pack_camera(cam[None], fov_to_intrinsics(18.837, device=dev))
        with torch.no_grad():
            outs[dev] = G(params, z.to(dev), c, truncation_psi=0.7, det=True)
    err = {k: (outs["cuda"][k].cpu() - outs["cpu"][k]).abs().max().item()
           for k in ("image", "image_raw", "image_depth")}
    log(f"small generator, card vs CPU: max abs err {err}")
    check(max(err.values()) <= SMALL_CPU_TOL,
          f"small generator on the card differs from the CPU by {err}")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def phase_times(torch, gs, G, params, bw):
    """Kernel, plain and F.grid_sample times on the main path's own
    inputs (both passes of one render), and one full render."""
    import torch.nn.functional as F
    import tgi_torch.render.renderer as renderer

    seen = []

    def record(planes, coords, box_warp):
        seen.append((planes, coords, box_warp))
        return gs.sample_triplanes(planes, coords, box_warp)

    renderer.sample_triplanes = record
    try:
        render_once(torch, G, params)
    finally:
        renderer.sample_triplanes = gs.sample_triplanes
    check(len(seen) == 2, f"{len(seen)} sampling passes, expected 2")

    rows = []
    for name, (planes, coords, bwarp) in zip(("coarse", "fine"), seen):
        N, _, C, H, W = planes.shape
        M = coords.shape[1]
        nchw = planes.contiguous().reshape(N * 3, C, H, W)
        grid = gs.project_onto_planes((2.0 / bwarp) * coords).reshape(
            N * 3, 1, M, 2)
        t_kernel = cuda_ms(torch, lambda: gs.sample_triplanes_cuda(
            planes, coords, bwarp))
        t_plain = cuda_ms(torch, lambda: gs.sample_triplanes_plain(
            planes, coords, bwarp), iters=10)
        t_lib = cuda_ms(torch, lambda: F.grid_sample(
            nchw, grid, mode="bilinear", padding_mode="zeros",
            align_corners=False))
        nbytes = 4 * (N * 3 * C * H * W + N * M * 3 + N * 3 * M * C)
        flops = N * 3 * M * (C * 9 + 20)
        bound = max(nbytes / bw, flops / FP32_FLOPS) * 1e3
        by = "bytes" if nbytes / bw >= flops / FP32_FLOPS else "operations"
        log(f"times, {name} pass (N={N}, M={M}, C={C}, {H}x{W}): kernel "
            f"{t_kernel:.4f} ms, plain {t_plain:.4f} ms, F.grid_sample "
            f"{t_lib:.4f} ms, bound {bound:.4f} ms ({by}: {nbytes / 1e6:.1f}"
            f" MB at {bw / 1e12:.2f} TB/s)")
        rows.append((t_kernel, t_plain, t_lib, bound, by))

    nchw5 = seen[0][0].contiguous()
    t_cl = cuda_ms(torch, lambda: gs.channels_last(nchw5))
    log(f"times, channels-last copy of the planes (once per render): "
        f"{t_cl:.4f} ms")

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_once(torch, G, params)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    log(f"times, one full-width render (mapping + synthesis, 512² image): "
        f"median {statistics.median(walls):.1f} ms of {walls}")
    mean = [sum(r[i] for r in rows) / len(rows) for i in range(4)]
    return {"ms": mean[0], "plain_ms": mean[1], "library_ms": mean[2],
            "bound_ms": mean[3], "bound_by": rows[0][4]}


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    if not os.path.isdir(os.path.join(REPO, "tgi_torch")):
        fail(f"no tgi_torch package beside {__file__}")
    sys.path.insert(0, REPO)
    from tgi_torch.ops import grid_sample as gs

    name, card, bw = phase_environment(torch)
    phase_build()
    err = phase_kernel_vs_plain(torch, gs)
    G, params = full_width_generator(torch)
    with tempfile.TemporaryDirectory(prefix="tgi_chip_smoke_") as tmp:
        res, launches = phase_generate(torch, gs, G, params, tmp)
    phase_plain_swap(torch, gs, G, params, res)
    phase_small_vs_cpu(torch)
    times = phase_times(torch, gs, G, params, bw)

    log(card)
    print(json.dumps({"kernels": [{
        "name": "triplane_gather", "route": "cuda",
        "source": "tgi_torch/csrc/triplane_gather.cu",
        "replaces": "tgi/ops/pallas/gather_vmem.py:62",
        "launches": launches, "max_abs_err": err, **times}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
