#!/usr/bin/env python3
"""Smoke run of tgi_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. environment: versions, the card, its power limit;
  2. build every CUDA kernel from tgi_torch/csrc with nvcc;
  3. each kernel against its plain PyTorch version, at the full-width
     shapes and at small ragged ones with points on the planes' borders:
     the tri-plane gather (forward) and the tri-plane splat (backward,
     ``d_planes`` and ``d_coords``);
  4. the port's generation path at full width — the FFHQ-rebalanced 512
     generator (z/w 512, 256² backbone with 3 x 32-channel planes, 128²
     rays, 48 + 48 samples, SuperresolutionHybrid8XDC), weights drawn
     from a seed — through ``generate_samples`` for 2 seeds x 3 yaws:
     finite images, views that differ, depths inside [ray_start,
     ray_end], 2 gather launches per render and no splat, the same image
     with the plain sampler swapped in, and a small generator that
     agrees with its CPU run (the CPU path is held against the JAX
     package by the tests);
  5. gradients through the render: one full-width synthesis forward and
     backward gives backbone, decoder and SR weights non-zero gradients
     through the splat kernel (2 launches), agreeing with the plain
     sampler's autograd; a small generator's gradients on the card agree
     with its CPU run;
  6. the port's stage-2 path (pivotal tuning, ``run_pti``'s
     ``invert_one`` from saved pivots) at full width: 10 Adam steps on a
     target rendered from another latent, 2 gather and 2 splat launches
     per step, finite losses, a last loss below the first, tuned weights
     that moved and a checkpoint that reads back;
  7. times: each kernel per launch (CUDA events, median) beside its
     plain version, a PyTorch library call computing the same function
     and the card's bound; one full-width render; one tuning step split
     into forward, backward and Adam.

TF32 is off throughout, so every comparison is in full fp32. The splat
sums with atomics in an order that changes from run to run, so it is
held to its plain version by a relative bound, not bit for bit.

The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the tgi_torch package beside it, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
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
DEVICE = "cuda"
KERNEL_TOL = 1e-5          # kernel vs plain, max abs (the same fp32 formula)
# Splat vs plain: max|got - want| <= SPLAT_TOL * max(1, max|want|), per
# output (the same fp32 products, summed in another order by atomics).
SPLAT_TOL = 1e-5
SWAP_TOL = 1e-4            # full render, kernel vs plain sampler, max abs
SMALL_CPU_TOL = 1e-4       # small generator, card vs CPU, max abs
# Gradients, kernels vs plain sampler and card vs CPU: ||Δ||_2 <= GRAD_TOL
# * ||want||_2 per tensor. A weight's gradient sums ~10^6 terms that
# largely cancel, in an order the card changes from run to run: under
# cuDNN's default backward algorithms the same computation run twice
# differs by up to ~1e-3 of its largest element, so the full-width
# comparison runs with deterministic cuDNN algorithms and logs the
# same-path spread beside each check.
GRAD_TOL = 1e-3
DEPTH_RANGE = (2.25, 3.3)
PTI_STEPS = 10


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


# (N, C, H, W, M): the full-width pass and two small ragged shapes.
CHECK_SHAPES = ((1, 32, 256, 256, 128 * 128 * 48), (1, 8, 32, 32, 2085),
                (2, 16, 32, 32, 1037))


def phase_kernel_vs_plain(torch, gs):
    """Max abs error of the gather kernel against its plain version."""
    gen = torch.Generator().manual_seed(1)
    worst = 0.0
    for N, C, H, W, M in CHECK_SHAPES:
        planes = torch.randn(N, 3, C, H, W, generator=gen).to(DEVICE)
        coords = torch.rand(N, M, 3, generator=gen) * 1.4 - 0.7
        coords[:, :6] = torch.tensor(border_coords(H, W))
        coords = coords.to(DEVICE)
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


def phase_splat_vs_plain(torch, gs):
    """Max errors of the splat kernel against its plain version, both
    outputs, with the point gradient asked for. Returns (max abs, max
    relative) error over all checks."""
    gen = torch.Generator().manual_seed(2)
    worst_abs = worst_rel = 0.0
    for N, C, H, W, M in CHECK_SHAPES:
        planes_cl = torch.randn(N, 3, H, W, C, generator=gen).to(DEVICE)
        coords = torch.rand(N, M, 3, generator=gen) * 1.4 - 0.7
        coords[:, :6] = torch.tensor(border_coords(H, W))
        coords = coords.to(DEVICE)
        g = torch.randn(N, 3, M, C, generator=gen).to(DEVICE)
        got = gs.triplane_splat_cuda(planes_cl, coords, g, 1.0, True)
        want = gs.triplane_splat_plain(planes_cl, coords, g, 1.0, True)
        torch.cuda.synchronize()
        for what, a, b in zip(("d_planes", "d_coords"), got, want):
            err = (a - b).abs().max().item()
            scale = max(1.0, b.abs().max().item())
            log(f"triplane_splat vs plain: N={N} C={C} {H}x{W} M={M}: "
                f"{what} max abs err {err:.3g} (max |plain| {scale:.4g}, "
                f"relative {err / scale:.3g})")
            check(err <= SPLAT_TOL * scale,
                  f"splat {what} disagrees with its plain version: {err} > "
                  f"{SPLAT_TOL} * {scale}")
            worst_abs = max(worst_abs, err)
            worst_rel = max(worst_rel, err / scale)
    return worst_abs, worst_rel


def full_width_generator(torch):
    from tgi_torch.models.generator import GeneratorConfig, TriPlaneGenerator
    G = TriPlaneGenerator(GeneratorConfig(neural_rendering_resolution=128))
    t0 = time.perf_counter()
    params = G.init(torch.Generator().manual_seed(0), device=DEVICE)
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

    gs.LAUNCHES = gs.SPLAT_LAUNCHES = 0
    t0 = time.perf_counter()
    res = generate_samples(G, params, seeds, angles=angles, outdir=outdir,
                           device=DEVICE)
    torch.cuda.synchronize()
    launches, splats = gs.LAUNCHES, gs.SPLAT_LAUNCHES
    log(f"generate_samples: {len(res)} renders in "
        f"{time.perf_counter() - t0:.1f} s, {launches} gather launches, "
        f"{splats} splat launches, PNGs: {outdir or 'none (no PIL)'}")
    check(launches == 2 * len(res),
          f"{launches} gather launches for {len(res)} renders, expected 2 each")
    check(splats == 0, f"{splats} splat launches in a forward-only path")

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
    pivot = torch.tensor([0, 0, 0.2], dtype=torch.float32, device=DEVICE)
    intr = fov_to_intrinsics(18.837, device=DEVICE)
    cond = pack_camera(look_at_pose(math.pi / 2, math.pi / 2, pivot,
                                    radius=2.7, device=DEVICE)[None], intr)
    cam = pack_camera(look_at_pose(math.pi / 2 + 0.35, math.pi / 2, pivot,
                                   radius=2.7, device=DEVICE)[None], intr)
    with torch.no_grad():
        ws = G.mapping(params, seed_z(0, G.cfg.z_dim, DEVICE), cond,
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


def _small_generator(torch):
    from tgi_torch.models.generator import (GeneratorConfig,
                                            TriPlaneGenerator,
                                            default_rendering_kwargs)
    G = TriPlaneGenerator(GeneratorConfig(
        z_dim=32, w_dim=32, img_resolution=64, backbone_resolution=32,
        plane_channels=8, mapping_layers=2, channel_base=512,
        channel_max=32, neural_rendering_resolution=16,
        rendering_kwargs=default_rendering_kwargs(
            superresolution_module="SuperresolutionTiny", depth_resolution=8,
            depth_resolution_importance=8, image_resolution=64)))
    return G, G.init(torch.Generator().manual_seed(3), device="cpu")


def _camera(torch, yaw, dev=None):
    dev = dev or DEVICE
    from tgi_torch.render.cameras import (fov_to_intrinsics, look_at_pose,
                                          pack_camera)
    cam = look_at_pose(math.pi / 2 + yaw, math.pi / 2,
                       torch.tensor([0, 0, 0.2], device=dev), radius=2.7,
                       device=dev)
    return pack_camera(cam[None], fov_to_intrinsics(18.837, device=dev))


def phase_small_vs_cpu(torch):
    """A small generator on the card (kernel) against its CPU run (plain
    version, the path the tests hold against the JAX package)."""
    G, cpu = _small_generator(torch)
    outs = {}
    for dev in ("cpu", DEVICE):
        params = {k: _to(v, dev) for k, v in cpu.items()}
        z = torch.randn(1, 32, generator=torch.Generator().manual_seed(4))
        with torch.no_grad():
            outs[dev] = G(params, z.to(dev), _camera(torch, 0.3, dev),
                          truncation_psi=0.7, det=True)
    err = {k: (outs[DEVICE][k].cpu() - outs["cpu"][k]).abs().max().item()
           for k in ("image", "image_raw", "image_depth")}
    log(f"small generator, card vs CPU: max abs err {err}")
    check(max(err.values()) <= SMALL_CPU_TOL,
          f"small generator on the card differs from the CPU by {err}")


def _loss_weights(torch, G, seed=6):
    """Fixed random projections of image, image_raw and image_depth."""
    gen = torch.Generator().manual_seed(seed)
    img = G.cfg.img_resolution
    res = G.cfg.neural_rendering_resolution
    return [torch.randn(shape, generator=gen) / shape[-1]
            for shape in ((1, 3, img, img), (1, 3, res, res),
                          (1, 1, res, res))]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _scalar_loss(out, weights):
    return sum((out[k] * w).sum() for k, w in
               zip(("image", "image_raw", "image_depth"), weights))


def _rel_err(a, b):
    """max|a - b| / max|b|: the worst element's error."""
    scale = b.abs().max().item()
    return (a - b).abs().max().item() / scale if scale > 0 else math.inf


def _norm_err(a, b):
    """||a - b||_2 / ||b||_2."""
    scale = b.norm().item()
    return (a - b).norm().item() / scale if scale > 0 else math.inf


# One weight of each part the render's gradient reaches.
GRAD_PATHS = (("backbone", "b256", "conv1", "weight"),
              ("decoder", "net0", "weight"),
              ("superresolution", "block0", "conv0", "weight"))


def phase_generator_grads(torch, gs, G, params):
    """One full-width synthesis forward and backward of a fixed scalar
    loss, through the kernels and then through the plain sampler's
    autograd: a backbone, a decoder and an SR weight get non-zero
    gradients through the render, the same in both."""
    import tgi_torch.render.renderer as renderer
    from tgi_torch.apps.gen_samples import seed_z
    paths = GRAD_PATHS
    with torch.no_grad():
        ws = G.mapping(params, seed_z(0, G.cfg.z_dim, DEVICE),
                       _camera(torch, 0.0),
                       truncation_psi=0.7, truncation_cutoff=14)
    cam = _camera(torch, 0.3)
    weights = [w.to(DEVICE) for w in _loss_weights(torch, G)]
    leaves = [_get(params, p) for p in paths]

    def grads(sampler):
        renderer.sample_triplanes = sampler
        for t in leaves:
            t.requires_grad_(True)
            t.grad = None
        try:
            _scalar_loss(G.synthesis(params, ws, cam, det=True),
                         weights).backward()
            torch.cuda.synchronize()
            return [t.grad.clone() for t in leaves]
        finally:
            renderer.sample_triplanes = gs.sample_triplanes
            for t in leaves:
                t.requires_grad_(False)
                t.grad = None

    # Deterministic cuDNN algorithms for this comparison, so that what
    # differs between two runs is the order of the atomics alone.
    torch.backends.cudnn.deterministic = True
    try:
        gs.LAUNCHES = gs.SPLAT_LAUNCHES = 0
        kernel = grads(gs.sample_triplanes)
        launches = (gs.LAUNCHES, gs.SPLAT_LAUNCHES)
        check(launches == (2, 2), f"(gather, splat) launches {launches} for "
              f"one render's forward and backward, expected (2, 2)")
        again = grads(gs.sample_triplanes)
        before = (gs.LAUNCHES, gs.SPLAT_LAUNCHES)
        plain = grads(gs.sample_triplanes_plain)
        check((gs.LAUNCHES, gs.SPLAT_LAUNCHES) == before,
              "the plain sampler launched a kernel")
    finally:
        torch.backends.cudnn.deterministic = False
    for path, k, k2, p in zip(paths, kernel, again, plain):
        name = ".".join(path)
        peak = k.abs().max().item()
        err = _norm_err(k, p)
        log(f"full-width gradient of {name}: max |grad| {peak:.4g}; kernels "
            f"vs plain sampler: norm err {err:.3g}, worst element "
            f"{_rel_err(k, p):.3g} of the max; kernels run twice: norm err "
            f"{_norm_err(k2, k):.3g}, worst element {_rel_err(k2, k):.3g}")
        check(math.isfinite(peak) and peak > 0,
              f"{name} gets no gradient through the render")
        check(err <= GRAD_TOL, f"{name}: kernels vs plain sampler {err} > "
              f"{GRAD_TOL}")


def phase_small_grads_vs_cpu(torch):
    """Every gradient of a small generator's scalar loss on the card
    (kernels) against its CPU run (plain versions)."""
    G, cpu = _small_generator(torch)
    weights = _loss_weights(torch, G)
    z = torch.randn(1, 32, generator=torch.Generator().manual_seed(4))
    got = {}
    for dev in ("cpu", DEVICE):
        params = _map_detach(_to(cpu, dev))
        leaves = list(_leaves(params))
        out = G(params, z.to(dev), _camera(torch, 0.3, dev),
                truncation_psi=0.7, det=True)
        _scalar_loss(out, [w.to(dev) for w in weights]).backward()
        got[dev] = [None if t.grad is None else t.grad.cpu() for t in leaves]
    worst = worst_el = 0.0
    for a, b in zip(got[DEVICE], got["cpu"]):
        check((a is None) == (b is None), "gradient present on one device")
        if b is not None and b.abs().max().item() > 0:
            worst = max(worst, _norm_err(a, b))
            worst_el = max(worst_el, _rel_err(a, b))
    log(f"small generator gradients, card vs CPU: worst norm err {worst:.3g} "
        f"(worst element {worst_el:.3g} of its tensor's max) over "
        f"{len(got['cpu'])} tensors")
    check(worst <= GRAD_TOL, f"small generator gradients differ by {worst}")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def phase_stage2(torch, gs, G, params, tmp):
    """Stage 2 through ``run_pti``'s per-image entry point at full width:
    a target rendered from seed 1's latent at yaw 0.3, the pivot (seed
    0's latent, the same camera) saved as ``.npy``, PTI_STEPS Adam steps
    with stochastic renders drawn from a seeded CUDA generator."""
    import numpy as np
    from tgi_torch.apps.gen_samples import seed_z
    from tgi_torch.apps.run_pti import invert_one
    from tgi_torch.invert.coach import CoachConfig, PTICoach
    from tgi_torch.io.checkpoints import load_checkpoint
    from tgi_torch.losses.lpips import make_lpips
    cond, cam = _camera(torch, 0.0), _camera(torch, 0.3)
    with torch.no_grad():
        ws_t = G.mapping(params, seed_z(1, G.cfg.z_dim, DEVICE), cond,
                         truncation_psi=0.7, truncation_cutoff=14)
        target = G.synthesis(params, ws_t, cam, det=True)["image"]
        ws = G.mapping(params, seed_z(0, G.cfg.z_dim, DEVICE), cond,
                       truncation_psi=0.7, truncation_cutoff=14)
    np.save(os.path.join(tmp, "face_ws.npy"), ws.cpu().numpy())
    np.save(os.path.join(tmp, "face_cam.npy"), cam.cpu().numpy())
    lpips = make_lpips("alex", generator=torch.Generator().manual_seed(5),
                       device=DEVICE)
    coach = PTICoach(G, lpips, CoachConfig(max_pti_steps=PTI_STEPS,
                                           lpips_threshold=0.0))
    try:
        import PIL  # noqa: F401
        png_renders = 2     # invert_one renders the pivot and the result
    except ImportError:
        png_renders = 0

    torch.cuda.synchronize()
    gs.LAUNCHES = gs.SPLAT_LAUNCHES = 0
    t0 = time.perf_counter()
    entry, tuned, info = invert_one(
        "face", target, G=G, gen_params=params, coach=coach, out_dir=tmp,
        generator=torch.Generator(device=DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"triplane_gather": gs.LAUNCHES,
                "triplane_splat": gs.SPLAT_LAUNCHES}
    losses = info["losses"]
    log(f"stage 2 (invert_one, {info['steps']} steps) in {wall:.1f} s: "
        f"launches {launches}, losses {losses}, final LPIPS "
        f"{info['final_lpips']:.4g}, entry {entry}")
    check(info["steps"] == PTI_STEPS == len(losses),
          f"{info['steps']} steps, expected {PTI_STEPS}")
    check(launches["triplane_gather"] == 2 * (PTI_STEPS + png_renders),
          f"{launches['triplane_gather']} gather launches for {PTI_STEPS} "
          f"steps and {png_renders} PNG renders, expected 2 per render")
    check(launches["triplane_splat"] == 2 * PTI_STEPS,
          f"{launches['triplane_splat']} splat launches for {PTI_STEPS} "
          f"steps, expected 2 per step")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    moved = [(a - b).abs().max().item() for a, b in
             zip(_leaves(tuned), _leaves(params))]
    log(f"tuned weights: {sum(m > 0 for m in moved)} of {len(moved)} tensors "
        f"moved, largest change {max(moved):.4g}")
    for path in GRAD_PATHS:
        check((_get(tuned, path) - _get(params, path)).abs().max().item() > 0,
              f"tuning left {'.'.join(path)} where it was")
    saved = load_checkpoint(os.path.join(tmp, "face_G.pt"), device=DEVICE)
    check(all(torch.equal(a, b) for a, b in
              zip(_leaves(saved["params"]), _leaves(tuned))),
          "face_G.pt does not read back as the tuned weights")
    check(saved["config"] == dataclasses.asdict(G.cfg),
          f"face_G.pt config {saved['config']} is not the generator's")
    log("face_G.pt reads back as the tuned weights")
    return launches, dict(coach=coach, ws=ws, cam=cam, target=target)


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


def phase_step_times(torch, gs, params, st, steps=6, warmup=2):
    """One tuning step — the body of ``PTICoach.tune``: the loss forward
    with its LPIPS read back for the threshold check, the backward, the
    Adam update — on CUDA events, split into those three parts, and on
    the host clock as a whole. Returns the medians and the splat's
    inputs in one step's backward (the main path's own)."""
    coach = st["coach"]
    p = {k: _map_detach(v) for k, v in params.items()}
    opt = torch.optim.Adam(list(_leaves(p)), lr=coach.cfg.pti_learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    real = gs.triplane_splat_cuda
    seen = []

    def record(*args):
        seen.append(args)
        return real(*args)

    parts = {"forward": [], "backward": [], "adam": [], "step": [],
             "step_host": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(warmup + steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        loss, aux = coach._loss(p, st["ws"], st["cam"], st["target"],
                                generator=gen)
        float(aux["lpips"].detach())
        ev[1].record()
        opt.zero_grad(set_to_none=True)
        gs.triplane_splat_cuda = record if i == warmup else real
        try:
            loss.backward()
        finally:
            gs.triplane_splat_cuda = real
        ev[2].record()
        opt.step()
        ev[3].record()
        ev[3].synchronize()
        host = (time.perf_counter() - t0) * 1e3
        if i >= warmup:
            parts["forward"].append(ev[0].elapsed_time(ev[1]))
            parts["backward"].append(ev[1].elapsed_time(ev[2]))
            parts["adam"].append(ev[2].elapsed_time(ev[3]))
            parts["step"].append(ev[0].elapsed_time(ev[3]))
            parts["step_host"].append(host)
    med = {k: statistics.median(v) for k, v in parts.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"times, one full-width tuning step (median of {steps}): "
        f"{med['step']:.2f} ms = forward {med['forward']:.2f} + backward "
        f"{med['backward']:.2f} + Adam {med['adam']:.2f} ms (CUDA events); "
        f"host clock {med['step_host']:.2f} ms; peak memory {peak:.2f} GiB; "
        f"all steps: {parts}")
    check(len(seen) == 2, f"{len(seen)} splat passes in one backward, "
          f"expected 2")
    return med, seen


def _map_detach(tree):
    if isinstance(tree, dict):
        return {k: _map_detach(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)


def phase_splat_times(torch, gs, seen, bw):
    """Splat kernel, plain and ``grid_sampler_2d_backward`` times on the
    inputs of the main path's two backward passes, beside the card's
    bound."""
    rows = []
    for name, (planes_cl, coords, g, bwarp, need) in zip(("coarse", "fine"),
                                                          seen):
        N, _, H, W, C = planes_cl.shape
        M = coords.shape[1]
        check(not need, "the tuning step asked the splat for d_coords")
        nchw = planes_cl.permute(0, 1, 4, 2, 3).reshape(
            N * 3, C, H, W).contiguous()
        grid = gs.project_onto_planes((2.0 / bwarp) * coords).reshape(
            N * 3, 1, M, 2)
        g_lib = g.reshape(N * 3, M, C).permute(0, 2, 1).reshape(
            N * 3, C, 1, M).contiguous()

        def lib(mask):
            return torch.ops.aten.grid_sampler_2d_backward(
                g_lib, nchw, grid, 0, 0, False, mask)

        t_kernel = cuda_ms(torch, lambda: gs.triplane_splat_cuda(
            planes_cl, coords, g, bwarp, False))
        t_kernel_c = cuda_ms(torch, lambda: gs.triplane_splat_cuda(
            planes_cl, coords, g, bwarp, True))
        t_plain = cuda_ms(torch, lambda: gs.triplane_splat_plain(
            planes_cl, coords, g, bwarp, False), iters=5)
        t_lib = cuda_ms(torch, lambda: lib([True, False]))
        t_lib_c = cuda_ms(torch, lambda: lib([True, True]))
        # Each input read once, each output written once: g, coords in,
        # d_planes out. Operations: per point, plane and channel four
        # weighted adds (8 flops), plus ~20 per point and plane for the
        # projection, floor and weights.
        nbytes = 4 * (N * 3 * M * C + N * M * 3 + N * 3 * H * W * C)
        flops = N * 3 * M * (8 * C + 20)
        bound = max(nbytes / bw, flops / FP32_FLOPS) * 1e3
        by = "bytes" if nbytes / bw >= flops / FP32_FLOPS else "operations"
        log(f"times, splat {name} pass (N={N}, M={M}, C={C}, {H}x{W}): "
            f"kernel {t_kernel:.4f} ms (with d_coords {t_kernel_c:.4f}), "
            f"plain {t_plain:.4f} ms, grid_sampler_2d_backward {t_lib:.4f} "
            f"ms (with d_grid {t_lib_c:.4f}), bound {bound:.4f} ms ({by}: "
            f"{nbytes / 1e6:.1f} MB at {bw / 1e12:.2f} TB/s)")
        rows.append((t_kernel, t_plain, t_lib, bound, by))
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
    gather_err = phase_kernel_vs_plain(torch, gs)
    splat_err, splat_rel = phase_splat_vs_plain(torch, gs)
    G, params = full_width_generator(torch)
    with tempfile.TemporaryDirectory(prefix="tgi_chip_smoke_") as tmp:
        res, gen_launches = phase_generate(torch, gs, G, params, tmp)
        phase_plain_swap(torch, gs, G, params, res)
        phase_small_vs_cpu(torch)
        phase_generator_grads(torch, gs, G, params)
        phase_small_grads_vs_cpu(torch)
        pti_launches, st = phase_stage2(torch, gs, G, params, tmp)
    gather_times = phase_times(torch, gs, G, params, bw)
    _, seen = phase_step_times(torch, gs, params, st)
    splat_times = phase_splat_times(torch, gs, seen, bw)

    log(card)
    print(json.dumps({"kernels": [{
        "name": "triplane_gather", "route": "cuda",
        "source": "tgi_torch/csrc/triplane_gather.cu",
        "replaces": "tgi/ops/pallas/gather_vmem.py:62",
        "launches": pti_launches["triplane_gather"],
        "launches_by_path": {"generate_samples": gen_launches,
                             "run_pti_stage2": pti_launches[
                                 "triplane_gather"]},
        "max_abs_err": gather_err, **gather_times}, {
        "name": "triplane_splat", "route": "cuda",
        "source": "tgi_torch/csrc/triplane_splat.cu",
        "replaces": "tgi/ops/pallas/splat_pack.py:192",
        "also_replaces": "tgi/ops/pallas/splat.py:97",
        "launches": pti_launches["triplane_splat"],
        "max_abs_err": splat_err, "max_rel_err": splat_rel,
        **splat_times}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
