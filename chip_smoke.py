#!/usr/bin/env python3
"""Smoke run of tgi_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. environment: versions, the card, its power limit, which optional
     modules (Pillow, click, imageio, scipy) import;
  2. build every CUDA kernel from tgi_torch/csrc with nvcc;
  3. each kernel against its plain PyTorch version, at the full-width
     shapes (uniform points, and a ray-ordered frustum march, some of
     whose consecutive samples share a cell and whose outer rays leave
     the box), at small ragged ones with points on the planes' borders,
     at C = 6 and with planes and g off 16-byte alignment (the kernels'
     scalar path), and with rows longer than a 32-lane group takes at
     once (C = 132, C = 66): the tri-plane gather (forward) and the
     tri-plane splat (backward, ``d_planes`` and ``d_coords``);
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
  7. the port's stage-1 path (projection) at full width, with VGG16 and
     the pose ResNet-34 drawn from a seed: one step's gradients (w, noise,
     pose net, translation) through the kernels against the plain
     sampler, a non-zero pose-net gradient, non-zero ``d_coords`` from
     the splat and their share of the pose-net gradient (the same step
     with the render's sample points detached) well above the kernels'
     error, the same step under ``TGI_SPLAT=mxu`` against the default
     route, and the launches per step;
  8. stage 1 + stage 2 through ``run_pti``'s ``invert_one`` without
     pivots, twice in each splat mode: 60 projection steps (50 preheat +
     10 joint) on a target rendered from another latent and yaw, the
     pivot files written and read by stage 2, 10 tuning steps; the
     spread of the loss trajectories between two runs of one mode and
     between the modes;
  9. times: each kernel per launch (CUDA events, median) beside its
     plain version, a PyTorch library call computing the same function
     and the card's bound, and per pass the gather's and the splat's
     ratio to their library calls and share of the bound; one
     full-width render; one tuning step split into forward, backward
     and Adam; one stage-1 step split into forward, backward and the
     three Adams; the sorted splat's prep (key kernel, sort,
     offsets-and-records kernel) and segment kernel apart;
 10. the kernels of tgi's two kernel benches (scripts/bench_gather_vmem.py
     and scripts/bench_splat_sched.py), at their shapes (3 planes of
     256², the points of a 64² or 128² ray frustum march, 48 samples):
     a. the row fetch (gather_rows.cu, fp32 and bf16) bitwise equal to
        its plain version at P = 786,432 and at a ragged P = 1037 with
        rows of 128 and 64;
     b. the tile walk (gather_tilewalk.cu, bf16 and fp32, block-local and
        ray-major order) bitwise equal to its plain version, and its
        passes per block equal to the plain count, at the same shapes;
     c. the scheduled splat (splat_sched.cu): walk and nbhd against the
        full index_add_ sum, static9 against its own masked sum, within
        SPLAT_TOL, at P = 786,432 and at ragged 64² shapes;
     e. the port's twins of the two benches through their ``main`` at
        their default shapes, each with every count set to 0 before it
        and read after (the slice's main path);
     d. each of the three kernels timed at P = 786,432 and 196,608
        beside its plain version, the library call (torch indexing;
        index_add_) and the byte bound.

Phase 3 also holds the sorted splat (``TGI_SPLAT=mxu``'s backward)
against its plain version, at the same shapes and at one whose points
pile into 8 cells by the thousand, checks its prep (sorted order,
offsets, records) bit for bit against the plain prep and that two runs
give the same bits, and that ``triplane_splat.cu`` without its
``d_planes`` gives the fused run's ``d_coords``.

TF32 is off throughout, so every comparison is in full fp32. The fused
splat sums with atomics in an order that changes from run to run, so it
is held to its plain version by a relative bound, not bit for bit; the
sorted splat has no atomics.

Phase 11, ``pkl_bf16``, drives the path of a user with an EG3D ``.pkl``
in ``tgi``'s mixed precision: a full-width pickle in the reference's
layout written in the process from the generator's weights, read through
``run_pti.load_any_generator`` (bit for bit, a bf16 config), a 512² bf16
render beside fp32, ``invert_one`` on the bf16 generator (20 float32
projection steps, 10 bf16 tuning steps) through the gather and splat
kernels in both stages, one bf16 tuning step's gradients through the
kernels against the plain sampler, and a bf16 render and tuning step
timed beside float32 ones.

Phase 12 drives the closed-loop self-inversion gate and the rest of
``run_pti``'s evaluation path at full width: on the gate's generator
(seed 2, whose target is not black), the aux nets bootstrapped on a
pseudo-dataset the generator renders (64 images, 100 pose-net and 50
VGG steps), then ``self_inversion_eval`` (20 + 60 steps, the
bootstrapped e4e start, the 0.06 early-stop probe, the quat camera lr /
30 as ``bench.py`` runs its gate with bootstrapped nets), held to the
CPU gate test's assertions, final MSE at most 1.05 x the pivot's
included, with both bootstrap losses falling; e4e
(IR-SE50, 256²) and ArcFace (112²) on the card against their CPU run;
and ``run_pti`` with the e4e start and ``--eval`` from seeded ``.pt``
files (20 + 10 steps), its metrics checked; the gather and splat
launches of each part counted. The gate also runs batched at B = 4 on
the same nets (phase 17f reads it).

Phase 13 drives what ``run_pti`` writes at ``tgi``'s defaults, and
GANSpace, on the seed-0 full-width generator: (a) ``sample_mixed`` on one
1<<20-point chunk of the 256³ mesh grid through the gather (one launch)
against the plain sampler; (b) ``extract_mesh`` at 256³, the native
marching library built by g++ from the checkout, the sigma grid's 16
chunks one gather each, a non-empty mesh and its .ply read back; (c)
``render_orbit``, 8 frames 4 at a time with 96 + 96 samples, 2 gathers a
batch, ms a frame and peak memory; (d) ``run_pti`` 20 + 10 steps with
orbit videos (where imageio is installed), ``gen_mesh``,
``use_locality_reg`` and ``visualize_opt``, the files it writes and its
launches, and a tuning step with the locality term (6 gathers, 4
splats) timed beside one without (2 and 2); (e) ``compute_pca`` at
100,000 samples, the basis read back by ``load_components``, and the
"smile" edit rendered.

Phase 14 drives GAN training (``train_gan`` -> ``training_loop`` ->
``GANTrainer.train_step``) at ``tgi``'s default configuration, EG3D's
FFHQ 512 training setup: the bf16 generator (64² rays, 48 + 48 samples,
SR 64->512), the dual discriminator at 512², batch 4, R1 gamma 1, the
density regulariser, the blur fade from sigma 10, ADA, EMA. (a) 16
renders of the seed-2 generator at a yaw and pitch grid written as
``.npy`` images with their labels and read back through
``ImageFolderDataset`` with xflip; (b) 8 steps (greg on steps 0 and 4,
R1 on step 0, ADA p from 0.2) with a tick, a checkpoint and, where
Pillow imports, an image grid every 4 steps, then a resume from the
checkpoint for one step: finite losses, signs_real in [-1, 1], G and D
moved, the EMA lagging, the tick records, 4 gathers and 2 splats a
plain step and 5 and 3 with the density regulariser; step times (CUDA
events), peak memory and s/kimg, and warm plain, greg, R1 and greg + R1
steps; (c) one G phase plus the density regulariser at full width
through the kernels and through the plain sampler (per group within
BF16_GRAD_TOL), and the regulariser's 4 x 2,000 points, most of them
outside the box, through the gather and the splat against their plain
versions; (d) a tiny ``train_step`` on the card against the CPU.

Phase 15 drives the GAN metrics (``tgi``'s evaluation path) on the
seed-2 full-width generator: (a) Inception-v3 with drawn weights whose
BatchNorm is calibrated on 16 renders and their clamped copies, on 4
renders at 512² (so through the antialiased resize to 299²), card
against CPU within INCEPTION_TOL: torchvision's layout through
``inception_feature_fn``, and NVIDIA's names converted and run through
``nvidia_detector_fn`` (BN separate), features and 1008-way logits; (b)
``python -m tgi_torch.apps.calc_metrics`` in the process on a port
``.ckpt``, 256 ``.npy`` renders from other z's and each detector saved
with ``torch.save``, ``--metrics fid,kid,pr --num-items 256``: finite
jsonl records, exactly 2 x 32 gathers and no splat per run (every count
set to 0 just before and read just after), its seconds split into
rendering, Inception and the distances, and then, outside the counted
runs, one batch of 8 at the metrics' camera distribution through the
kernel against the plain sampler on the same z and c (image, image_raw
and image_depth within SWAP_TOL); (c) fid of a set of the card's
features against itself within the square root's error on its
rank-deficient covariance, pr exactly (1, 1); (d) ``is50k`` on the
NVIDIA head's softmax without the bias over 64 renders, in [1, 1008],
and ``ppl2_wend`` with drawn VGG/LPIPS, 16 samples in batches of 4,
finite, 4 gathers a segment, both through ``calc_metric``; (e) the
alias-free generator at ``tgi``'s default SG3Config (256², 14 layers):
ms a forward at batch 8 and EQ-T, EQ-T_frac and EQ-R over 16 samples;
a tiny SG3 on the card against its CPU run, images within SG3_CPU_TOL
and the three PSNRs with fixed draws within EQ_DB_TOL dB. Every card
number is printed beside the card's name and power limit.

Phase 16 drives a user's way in from a raw photo or a TF-era pickle,
and the render options the port took over from ``tgi``: (a) a TF-era
``(G, D, Gs)`` StyleGAN2 pickle of FFHQ config F (1024², fmap_base
16384, 8 mapping layers, minibatch-std groups of 4), drawn and written
here (``tf_network_pickle``), read through ``load_network_pkl`` onto the
card; Gs at batch 4 against the CPU at batch 1 and D at batch 4 against
the CPU within SG2_CPU_TOL of the largest value, both timed, then
``legacy_convert.convert_pickle`` to the port's checkpoint, read back
bit for bit; (b) the seed-0 generator with ``density_noise=1`` and
random SR noise from one seeded CUDA generator: a 512² render through
the gather against the plain sampler from the same planes (within
SWAP_TOL), the coarse and fine pass handed one and the same normals
(``tgi``'s reuse), one step's gradients kernels vs plain within
GRAD_TOL, 2 gathers a render and 2 splats a backward; float16 and bf16
renders against float32 (float16 at least FP16_PSNR_MIN dB, its
reduced-precision blocks seen running in float16); a render at a ``gaussian_camera_pose`` draw;
(c) a 1024 x 768 photo with the seed-2 generator's render pasted in, a
drawn 68-point predictor at dlib's defaults (``drawn_predictor``) saved
with ``save_shape_predictor``, ``align_data --predictor --size 512``,
``dataset_tool`` to a zip read back through ``ImageFolderDataset`` bit
for bit, and ``run_pti`` on the aligned folder at 10 + 5 steps with its
gathers and splats counted.

Phase 17 drives batched inversion (``Projector.project_batch``,
``PTICoach.tune_batch``, ``run_pti --batch``, the batched gate) on the
gate's generator (seed 2) at B = 4, the targets at the batched gate's
cameras (``selfinv._BATCH_POSE_OFFSETS``): (a) one batched stage-1 joint
step (each image's calibrated pose ResNet-34, one render of the 4 images
a view) and one batched tuning step (4 generator copies, every leaf per
image) through the kernels, again, through the plain sampler and under
``TGI_SPLAT=mxu``, per group within STAGE1_GRAD_TOL / GRAD_TOL with
deterministic cuDNN and TF32 off; the gather, the fused splat and the
sorted splat (up to 4 x 3 x 786,432 keys) against their plain versions
on the inputs those steps handed them; (b) image b of each step against
the one-image step on its inputs and draws (BATCH_LANE_TOL, the
camera's groups BATCH_CAMERA_TOL); (c) the
launches: one gather a render pass and one splat a backward pass at
N = 4, as a one-image step; the gather and the fused splat per pass at
N = 4 beside plain, F.grid_sample / grid_sampler_2d_backward and the
bound; (d) ``run_pti(batch=4)`` over 5 images (a chunk of 4, a ragged
one of 1) at 10 + 5 steps without videos: every image's pivots, tuned
generator and results entry, passes at N = 4 and 1; (e) ms per image
and peak memory of a stage-1 step and a tuning step at B = 1, 2, 4, with
and without remat (CUDA events); (f) the batched gate phase 12 ran beside
the single one (20 + 60 steps on the same bootstrapped nets): each
image's final MSE at most 1.05 x its pivot's, image 0 within 0.01
MS-SSIM of the single gate, and its launches.

Phase 18 drives the port's last modules at full width: (a)
``training_loop(mesh=make_mesh())`` over a process group of world size 1
on NCCL (its store a file in the temporary directory), 2 steps of phase
14's configuration on phase 14's dataset, against the same 2 steps with
``mesh=None``, held to phase 14's tolerances, with the collectives a
step, the gathers and the splats counted (on one rank the collectives
move nothing: this is the code path on the card, not a speed-up); (b)
``synthesis`` under ``ray_constrained`` of a mesh naming the card twice
(rays = 2) against the unsharded render, forward and one backward to ws
with deterministic cuDNN, the gather once per shard per pass; (c) CLIP
ViT-B/32 (drawn weights, fp32) card vs CPU at batch 4 with 77-token
prompts from the BPE tokenizer, and ``clip_loss`` of a 512² render with
its gradient to ws through the gather and the splat against the plain
sampler, timed; (d) the visualizer served on 127.0.0.1 in a thread: the
page, frames of each render type, the stats and a capture, a served
frame equal to the direct call, ms a frame with the plane cache hit and
missed.

Phase 19 drives what the port refused before: (a) ``train_gan`` at
phase 14's configuration on its dataset with
``checkpoint_backend="orbax"`` and ``snapshot_keep=2`` (versioned step
directories, written in the background, ``io/orbax_io.py``), a snapshot
every tick of 2 steps for 4 ticks: two finished steps kept, the newest
with the loop's cur_nimg and restored bit for bit against the host copy
taken when it was saved, then a resume from them (a left-over temporary
step beside them) that starts at that cur_nimg, writes a later step and
keeps two; phase 14's launches a step; the bytes a snapshot takes, the
seconds each async save held the loop beside a synchronous save, the
seconds a restore takes; (b) phase 17a-c on the gate's generator with
``density_noise=1`` and random SR noise (as 16b sets them): the batched
stage-1 and tuning steps at N = 4 through the kernels, the plain sampler
and TGI_SPLAT=mxu, each image against its one-image step on its own
generator's draws, the kernels against their plain versions, the same
steps under remat against none (every draw taken before the recomputed
render), and the step times at B = 4 beside phase 17's without the
options.

The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the tgi_torch package beside it, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
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
STAGE1_STEPS = 60          # the 50 preheat steps and 10 joint ones
# Stage-1 gradients, kernels vs plain sampler and TGI_SPLAT=mxu vs the
# default route, ||Δ||_2 <= STAGE1_GRAD_TOL * ||want||_2 per group (w,
# noise, pose net, translation), with deterministic cuDNN algorithms.
STAGE1_GRAD_TOL = 1e-4
# The .pkl path (phase 11): a bf16 generator's inversion, cut to 20
# projection steps (10 preheat, 10 joint) and 10 tuning steps.
PKL_STAGE1_STEPS = 20
PKL_PTI_STEPS = 10
# A bf16 tuning step's gradients, kernels vs plain sampler, ||Δ||_2 <=
# BF16_GRAD_TOL * ||want||_2 per group (backbone, SR, decoder), with
# deterministic cuDNN algorithms. The gather is bit-equal to plain, so
# the SR and the decoder agree exactly; the backbone's gradient passes
# through the splat's float atomics, whose order changes from call to
# call: on an H100 the kernels read 4.5e-4 against the plain sampler and
# 4.6e-4 to 4.9e-4 against themselves run twice. The limit stands about
# 4 x above that, so a splat that is slightly wrong on this path fails.
BF16_GRAD_TOL = 2e-3


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def log(*args):
    print(*args, flush=True)


def cuda_ms(torch, fn, iters=30, warmup=3):
    """Median milliseconds of ``fn`` on the card, CUDA events per call.
    The yardstick stays here, outside the package it measures."""
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
    import importlib.util
    log("optional modules: " + ", ".join(
        f"{m} {'imports' if importlib.util.find_spec(m) else 'absent'}"
        for m in ("PIL", "click", "imageio", "scipy")))
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


# (N, C, H, W, M, points): the full-width pass, two small ragged shapes,
# C = 6 (the kernels' scalar path), a small shape whose planes and g sit
# one float past a 16-byte boundary (the scalar path again), the
# full-width pass in ray order (the frustum march of 128² rays x 48
# samples, the order in which the renderer hands points to the kernels,
# some of whose consecutive samples share a cell, which the splat sums
# before its atomics, and whose outer rays leave the box), and two rows
# longer than a group of 32 lanes takes at once: C = 132 on the vector
# path (33 float4s) and C = 66 on the scalar path.
CHECK_SHAPES = ((1, 32, 256, 256, 128 * 128 * 48, "uniform"),
                (1, 8, 32, 32, 2085, "uniform"),
                (2, 16, 32, 32, 1037, "uniform"),
                (1, 6, 32, 32, 1037, "uniform"),
                (1, 32, 32, 32, 515, "offset"),
                (1, 32, 256, 256, 128 * 128 * 48, "rays"),
                (1, 132, 16, 16, 300, "uniform"),
                (1, 66, 16, 16, 300, "uniform"))


# The sorted splat's check shapes: CHECK_SHAPES, and points piled into
# 8 cells of a 64² plane by the thousand, so that a cell's segments run
# for many 32-record chunks.
SORTED_CHECK_SHAPES = CHECK_SHAPES + ((1, 32, 64, 64, 65536, "skewed"),)


def check_inputs(torch, gen, N, C, H, W, M, points):
    """(planes_cl [N, 3, H, W, C], coords [N, M, 3], g [N, 3, M, C]) on
    the card for one check shape, box_warp 1. Uniform points carry the
    border points first; "offset" stores planes_cl and g one float past
    a 16-byte boundary; "skewed" moves 7/8 of the uniform points to
    within a fifth of a cell of 8 centres."""
    planes_cl = torch.randn(N, 3, H, W, C, generator=gen)
    if points == "rays":
        from tgi_torch.scripts import frustum_points
        R = math.isqrt(M // 48)
        coords = (torch.from_numpy(frustum_points(R, R, 48)).float() / 2)
        coords = coords[None].expand(N, -1, -1).contiguous()
    else:
        coords = torch.rand(N, M, 3, generator=gen) * 1.4 - 0.7
        coords[:, :6] = torch.tensor(border_coords(H, W))
    if points == "skewed":
        pile = coords[:, 6:6 + M * 7 // 8]
        centres = torch.rand(8, 3, generator=gen) - 0.5
        jitter = (torch.rand(pile.shape, generator=gen) - 0.5) * (0.2 / H)
        pile.copy_(centres.repeat(pile.shape[1] // 8 + 1, 1)[
            :pile.shape[1]] + jitter)
    g = torch.randn(N, 3, M, C, generator=gen)
    if points == "offset":
        planes_cl, g = (torch.cat([torch.zeros(1), t.reshape(-1)]).to(
            DEVICE)[1:].view(t.shape) for t in (planes_cl, g))
        check(planes_cl.data_ptr() % 16 == 4 and g.data_ptr() % 16 == 4,
              "the offset inputs are 16-byte aligned")
    return planes_cl.to(DEVICE), coords.to(DEVICE), g.to(DEVICE)


def phase_kernel_vs_plain(torch, gs):
    """Max abs error of the gather kernel against its plain version."""
    gen = torch.Generator().manual_seed(1)
    worst = 0.0
    for N, C, H, W, M, points in CHECK_SHAPES:
        planes_cl, coords, _ = check_inputs(torch, gen, N, C, H, W, M, points)
        planes = planes_cl.permute(0, 1, 4, 2, 3)  # [N, 3, C, H, W] view
        got = gs.sample_triplanes_cuda(planes, coords, 1.0)
        want = gs.sample_triplanes_plain(planes, coords, 1.0)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        log(f"triplane_gather vs plain: N={N} C={C} {H}x{W} M={M} {points}: "
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
    for N, C, H, W, M, points in CHECK_SHAPES:
        planes_cl, coords, g = check_inputs(torch, gen, N, C, H, W, M, points)
        got = gs.triplane_splat_cuda(planes_cl, coords, g, 1.0, True)
        want = gs.triplane_splat_plain(planes_cl, coords, g, 1.0, True)
        torch.cuda.synchronize()
        for what, a, b in zip(("d_planes", "d_coords"), got, want):
            err = (a - b).abs().max().item()
            scale = max(1.0, b.abs().max().item())
            log(f"triplane_splat vs plain: N={N} C={C} {H}x{W} M={M} "
                f"{points}: {what} max abs err {err:.3g} (max |plain| "
                f"{scale:.4g}, relative {err / scale:.3g})")
            check(err <= SPLAT_TOL * scale,
                  f"splat {what} disagrees with its plain version: {err} > "
                  f"{SPLAT_TOL} * {scale}")
            worst_abs = max(worst_abs, err)
            worst_rel = max(worst_rel, err / scale)
    return worst_abs, worst_rel


def phase_sorted_vs_plain(torch, gs):
    """The sorted splat against its plain version at the check shapes
    and a skewed one, its prep (sorted order, offsets and records) bit
    for bit against the plain prep, two runs of it bit for bit, and
    ``triplane_splat.cu``'s ``d_coords`` without its ``d_planes`` against
    the fused run's. Returns the max absolute and relative errors."""
    gen = torch.Generator().manual_seed(7)
    worst_abs = worst_rel = 0.0
    for N, C, H, W, M, points in SORTED_CHECK_SHAPES:
        planes_cl, coords, g = check_inputs(torch, gen, N, C, H, W, M, points)
        prep = gs.splat_prep_cuda(coords, 1.0, H, W)
        prep_plain = gs.splat_prep_plain(coords, 1.0, H, W)
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(prep, prep_plain)]
        longest = prep[1].diff(dim=1).max().item()
        log(f"triplane_splat_sorted prep vs plain: N={N} C={C} {H}x{W} "
            f"M={M} {points}: order, offsets, records bitwise equal {same}; "
            f"longest floor-cell segment {longest}")
        check(all(same), f"the sorted splat's prep differs from its plain "
              f"version (order, offsets, records equal: {same})")
        got = gs.triplane_splat_sorted_cuda(coords, g, 1.0, H, W)
        again = gs.triplane_splat_sorted_cuda(coords, g, 1.0, H, W)
        want = gs.triplane_splat_sorted_plain(coords, g, 1.0, H, W)
        _, fused = gs.triplane_splat_cuda(planes_cl, coords, g, 1.0, True)
        none, alone = gs.triplane_splat_cuda(planes_cl, coords, g, 1.0, True,
                                             want_dplanes=False)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        c_err = (alone - fused).abs().max().item()
        c_scale = max(1.0, fused.abs().max().item())
        log(f"triplane_splat_sorted vs plain: N={N} C={C} {H}x{W} M={M} "
            f"{points}: max abs err {err:.3g} (max |plain| {scale:.4g}, "
            f"relative {err / scale:.3g}); two runs bitwise equal: "
            f"{torch.equal(got, again)}; d_coords without d_planes vs "
            f"fused: max abs err {c_err:.3g}, bitwise equal "
            f"{torch.equal(alone, fused)}")
        check(err <= SPLAT_TOL * scale, f"sorted splat disagrees with its "
              f"plain version: {err} > {SPLAT_TOL} * {scale}")
        check(torch.equal(got, again), "two runs of the sorted splat differ")
        check(none is None and c_err <= SPLAT_TOL * c_scale,
              f"d_coords without d_planes differs by {c_err}")
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / scale)
    return worst_abs, worst_rel


def full_width_generator(torch):
    """The gate's generator (``selfinv_gate.full_width_generator``):
    ``ffhqrebalanced512-128`` in fp32, weights from seed 0."""
    from tgi_torch.scripts import selfinv_gate
    t0 = time.perf_counter()
    G, params = selfinv_gate.full_width_generator(DEVICE)
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


# Reference module classes by the key that holds them in the params tree
# (EG3D's training/networks_stylegan2.py, superresolution.py,
# triplane.py); every other dict of tensors is a FullyConnectedLayer.
REF_CLASSES = {"backbone": "training.networks_stylegan2.Generator",
               "mapping": "training.networks_stylegan2.MappingNetwork",
               "synthesis": "training.networks_stylegan2.SynthesisNetwork",
               "conv0": "training.networks_stylegan2.SynthesisLayer",
               "conv1": "training.networks_stylegan2.SynthesisLayer",
               "torgb": "training.networks_stylegan2.ToRGBLayer"}
REF_BUFFERS = ("noise_const", "w_avg", "resample_filter")


def reference_pickle(cfg, params, dtype=None):
    """The bytes of a reference EG3D network pickle, ``{"G_ema": G}``,
    holding ``params`` (the port's tree, any device) under the reference
    ``state_dict`` names, with the layout the reference's persistence
    machinery writes (torch_utils/persistence.py:37-60): each persistent
    module reduces to ``torch_utils.persistence._reconstruct_persistent_obj``
    of its meta, whose state carries ``_parameters`` (requires_grad off,
    as in ``G_ema``), ``_buffers`` (``noise_const``, ``w_avg`` and the
    ``resample_filter`` constants) and ``_modules``; the decoder is a plain
    ``training.triplane.OSGDecoder`` around a ``torch.nn.Sequential``.
    ``G``'s state holds EG3D's init args and kwargs for ``cfg`` (channel
    base and max, ``sr_num_fp16_res``, the mapping depth, the rendering
    kwargs as a ``dnnlib.EasyDict``) and ``neural_rendering_resolution``
    as a pickled attribute; the backbone's, its resolution and channels
    (triplane.py:28). ``dtype`` stores the weights in another dtype
    (float16 for a force-fp16 pickle); the resample filters stay float32.

    No code of the reference is needed: the classes it names are stand-ins
    in modules registered in ``sys.modules`` only while pickling."""
    import collections
    import pickle
    import types

    import torch
    from tgi_torch.ops.filters import setup_filter

    modules = {}

    def register(qualname, obj):
        module, name = qualname.rsplit(".", 1)
        obj.__module__, obj.__qualname__, obj.__name__ = module, name, name
        for i in range(1, module.count(".") + 2):
            part = ".".join(module.split(".")[:i])
            modules.setdefault(part, types.ModuleType(part))
        setattr(modules[module], name, obj)
        return obj

    def reconstruct(meta):
        raise RuntimeError("never called: the pickle is only written here")

    register("torch_utils.persistence._reconstruct_persistent_obj",
             reconstruct)
    easy_dict = register("dnnlib.util.EasyDict", type("EasyDict", (dict,), {}))

    class Persistent:
        def __init__(self, class_name, state):
            self.class_name, self.state = class_name, state

        def __reduce__(self):
            return reconstruct, (dict(type="class", version=6,
                                      module_src="", class_name=self.class_name,
                                      state=self.state),)

    def plain(class_name, state):
        cls = register(class_name, type(class_name, (), {}))
        obj = cls.__new__(cls)
        obj.__dict__.update(state)
        return obj

    rfilter = torch.as_tensor(setup_filter([1, 3, 3, 1]))

    def tensor(t):
        t = t.detach().cpu()
        return t.to(dtype) if dtype is not None else t.clone()

    def module_state(tree, extra_buffers=(), **attrs):
        state = {"training": False, "_parameters": collections.OrderedDict(),
                 "_buffers": collections.OrderedDict(),
                 "_non_persistent_buffers_set": set(),
                 "_modules": collections.OrderedDict(),
                 "_init_args": (), "_init_kwargs": {}, **attrs}
        for k, v in tree.items():
            if isinstance(v, dict):
                state["_modules"][k] = build(k, v)
            elif k in REF_BUFFERS:
                state["_buffers"][k] = tensor(v)
            else:
                state["_parameters"][k] = torch.nn.Parameter(
                    tensor(v), requires_grad=False)
        for k in extra_buffers:
            state["_buffers"][k] = rfilter.clone()
        return state

    def build(key, tree):
        if re.fullmatch(r"b\d+|block\d", key):
            return Persistent("training.networks_stylegan2.SynthesisBlock",
                              module_state(tree, ("resample_filter",)))
        name = REF_CLASSES.get(key,
                               "training.networks_stylegan2.FullyConnectedLayer")
        layer = name.endswith("SynthesisLayer")
        return Persistent(name, module_state(
            tree, ("resample_filter",) if layer else ()))

    net = torch.nn.Sequential()
    net._modules.update([("0", build("net0", params["decoder"]["net0"])),
                         ("1", torch.nn.Softplus()),
                         ("2", build("net1", params["decoder"]["net1"]))])
    decoder = plain("training.triplane.OSGDecoder", {
        "training": False, "_parameters": collections.OrderedDict(),
        "_buffers": collections.OrderedDict(),
        "_modules": collections.OrderedDict(net=net), "hidden_dim": 64})
    sr_name = cfg.rendering_kwargs["superresolution_module"].rsplit(".", 1)[-1]
    init_kwargs = {
        "sr_num_fp16_res": cfg.sr_num_fp16_res,
        "mapping_kwargs": {"num_layers": cfg.mapping_layers},
        "rendering_kwargs": easy_dict(cfg.rendering_kwargs),
        "sr_kwargs": {"channel_base": cfg.channel_base,
                      "channel_max": cfg.channel_max,
                      "fused_modconv_default": "inference_only"},
        "channel_base": cfg.channel_base, "channel_max": cfg.channel_max,
        "fused_modconv_default": "inference_only", "num_fp16_res": 0,
        "conv_clamp": None}
    state = module_state(
        {"backbone": {"mapping": params["mapping"],
                      "synthesis": params["backbone"]},
         "superresolution": params["superresolution"]},
        _init_args=(cfg.z_dim, cfg.c_dim, cfg.w_dim, cfg.img_resolution,
                    cfg.img_channels),
        _init_kwargs=init_kwargs, z_dim=cfg.z_dim, c_dim=cfg.c_dim,
        w_dim=cfg.w_dim, img_resolution=cfg.img_resolution,
        img_channels=cfg.img_channels,
        rendering_kwargs=dict(cfg.rendering_kwargs),
        neural_rendering_resolution=cfg.neural_rendering_resolution)
    state["_modules"]["backbone"].state.update(
        _init_args=(cfg.z_dim, cfg.c_dim, cfg.w_dim),
        _init_kwargs={"img_resolution": cfg.backbone_resolution,
                      "img_channels": cfg.plane_channels * cfg.n_planes,
                      "mapping_kwargs": init_kwargs["mapping_kwargs"],
                      **init_kwargs["sr_kwargs"]})
    state["_modules"]["superresolution"].class_name = (
        f"training.superresolution.{sr_name}")
    state["_modules"]["renderer"] = plain(
        "training.volumetric_rendering.renderer.ImportanceRenderer",
        {"training": False, "_parameters": {}, "_buffers": {},
         "_modules": {}})
    state["_modules"]["decoder"] = decoder
    G = Persistent("training.triplane.TriPlaneGenerator", state)

    saved = {name: sys.modules.get(name) for name in modules}
    sys.modules.update(modules)
    try:
        return pickle.dumps({"G_ema": G}, protocol=4)
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod


# ---------------------------------------------------------------------------
# Phase 16's inputs: TF-era StyleGAN2 pickles and dlib shape predictors,
# drawn from a seed (no such file is in the tree).


def tf_variables(rng, kind, *, resolution, fmap_base, fmap_max=512,
                 latent=512, dlatent=512, mapping_layers=8, label_size=0,
                 scale=1.0):
    """The variables of a TF StyleGAN2 network (``kind`` "G" or "D") in
    the layouts the TF export stores (legacy.py:173-205, :266-290): conv
    [kh, kw, in, out], dense [in, out], const [1, C, 4, 4], noise [1, 1,
    r, r]; standard normal times ``scale`` from numpy's ``rng``. Channels
    are ``min(2 * fmap_base // res, fmap_max)`` per resolution. Returns
    (top-level, mapping, synthesis) lists for G, one list for D."""
    import numpy as np

    def draw(*shape):
        return (rng.randn(*shape) * scale).astype(np.float32)

    log2 = int(math.log2(resolution))
    ch = {2 ** i: min(2 * fmap_base // 2 ** i, fmap_max)
          for i in range(2, log2 + 1)}
    if kind == "D":
        cmap = ch[4] if label_size else 1
        out = []

        def conv(name, cin, cout, k=3, bias=True):
            out.append((f"{name}/weight", draw(k, k, cin, cout)))
            if bias:
                out.append((f"{name}/bias", draw(cout)))

        conv(f"{resolution}x{resolution}/FromRGB", 3, ch[resolution], k=1)
        for r in (2 ** i for i in range(log2, 2, -1)):
            conv(f"{r}x{r}/Conv0", ch[r], ch[r])
            conv(f"{r}x{r}/Conv1_down", ch[r], ch[r // 2])
            conv(f"{r}x{r}/Skip", ch[r], ch[r // 2], k=1, bias=False)
        conv("4x4/Conv", ch[4] + 1, ch[4])
        if label_size:
            out += [("LabelEmbed/weight", draw(label_size, cmap)),
                    ("LabelEmbed/bias", draw(cmap))]
        out += [("4x4/Dense0/weight", draw(ch[4] * 16, ch[4])),
                ("4x4/Dense0/bias", draw(ch[4])),
                ("Output/weight", draw(ch[4], cmap)),
                ("Output/bias", draw(cmap))]
        return out

    mapping = []
    if label_size:
        mapping += [("LabelEmbed/weight", draw(label_size, dlatent)),
                    ("LabelEmbed/bias", draw(dlatent))]
    width = latent + (dlatent if label_size else 0)
    for i in range(mapping_layers):
        mapping += [(f"Dense{i}/weight", draw(width, dlatent)),
                    (f"Dense{i}/bias", draw(dlatent))]
        width = dlatent

    def layer(name, cin, cout, k):
        out = [(f"{name}/weight", draw(k, k, cin, cout)),
               (f"{name}/bias", draw(cout))]
        if k == 3:
            out.append((f"{name}/noise_strength", np.float32(
                rng.randn() * 0.05)))
        return out + [(f"{name}/mod_weight", draw(dlatent, cin)),
                      (f"{name}/mod_bias", draw(cin))]

    synthesis = [("4x4/Const/const", draw(1, ch[4], 4, 4))]
    synthesis += layer("4x4/Conv", ch[4], ch[4], 3)
    synthesis += layer("4x4/ToRGB", ch[4], 3, 1)
    noise = [(0, 4)]
    for r in (2 ** i for i in range(3, log2 + 1)):
        lg = int(math.log2(r))
        synthesis += layer(f"{r}x{r}/Conv0_up", ch[r // 2], ch[r], 3)
        synthesis += layer(f"{r}x{r}/Conv1", ch[r], ch[r], 3)
        synthesis += layer(f"{r}x{r}/ToRGB", ch[r], 3, 1)
        noise += [(2 * lg - 5, r), (2 * lg - 4, r)]
    synthesis += [(f"noise{i}", draw(1, 1, r, r)) for i, r in noise]
    top = [("dlatent_avg", draw(dlatent)), ("lod", np.float32(0.0))]
    return top, mapping, synthesis


def tf_network_pickle(g_kwargs, d_kwargs, seed, scale=1.0):
    """The bytes of a TF-era ``(G, D, Gs)`` pickle: three
    ``dnnlib.tflib.network.Network`` objects (version 4) with their
    ``static_kwargs``, ``variables`` and ``components`` (G's mapping and
    synthesis), as a TF StyleGAN2 export holds them (legacy.py:64-84).
    ``g_kwargs`` / ``d_kwargs`` are the static kwargs (``resolution``,
    ``fmap_base``, ...); the variables are drawn by :func:`tf_variables`
    from ``seed``, G and Gs apart. The Network class is a stand-in in
    modules registered in ``sys.modules`` only while pickling."""
    import pickle
    import types

    import numpy as np

    rng = np.random.RandomState(seed)
    shapes = dict(resolution=g_kwargs.get("resolution", 1024),
                  fmap_base=g_kwargs.get("fmap_base", 16384),
                  fmap_max=g_kwargs.get("fmap_max", 512),
                  label_size=g_kwargs.get("label_size", 0))
    g_shapes = dict(shapes, latent=g_kwargs.get("latent_size", 512),
                    dlatent=g_kwargs.get("dlatent_size", 512),
                    mapping_layers=g_kwargs.get("mapping_layers", 8))
    d_shapes = dict(resolution=d_kwargs.get("resolution", 1024),
                    fmap_base=d_kwargs.get("fmap_base", 16384),
                    fmap_max=d_kwargs.get("fmap_max", 512),
                    label_size=d_kwargs.get("label_size", 0))
    modules = {k: types.ModuleType(k)
               for k in ("dnnlib", "dnnlib.tflib", "dnnlib.tflib.network")}

    class Network:
        def __init__(self, **kw):
            self.__dict__.update(kw)

    Network.__module__ = "dnnlib.tflib.network"
    Network.__qualname__ = Network.__name__ = "Network"
    modules["dnnlib.tflib.network"].Network = Network

    def generator(name):
        top, mapping, synthesis = tf_variables(rng, "G", scale=scale,
                                               **g_shapes)
        return Network(version=4, name=name, static_kwargs=dict(g_kwargs),
                       variables=top, components={
                           "mapping": Network(
                               version=4, name=f"{name}_mapping",
                               static_kwargs={}, variables=mapping,
                               components={}),
                           "synthesis": Network(
                               version=4, name=f"{name}_synthesis",
                               static_kwargs={}, variables=synthesis,
                               components={})})

    G = generator("G")
    D = Network(version=4, name="D", static_kwargs=dict(d_kwargs),
                variables=tf_variables(rng, "D", scale=scale, **d_shapes),
                components={})
    Gs = generator("Gs")
    saved = {k: sys.modules.get(k) for k in modules}
    sys.modules.update(modules)
    try:
        return pickle.dumps((G, D, Gs), protocol=4)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def mean_face():
    """A plausible 68-point face in dlib's layout, in normalized [0, 1]²
    coordinates (the initial shape of ``tests/test_landmarks.py``)."""
    import numpy as np
    lm = np.zeros((68, 2))
    lm[0:17] = np.stack([np.linspace(0.1, 0.9, 17),
                         0.45 + 0.35 * np.sin(np.linspace(0, np.pi, 17))], 1)
    lm[17:22] = np.stack([np.linspace(0.2, 0.4, 5), np.full(5, 0.30)], 1)
    lm[22:27] = np.stack([np.linspace(0.6, 0.8, 5), np.full(5, 0.30)], 1)
    lm[27:31] = np.stack([np.full(4, 0.5), np.linspace(0.35, 0.55, 4)], 1)
    lm[31:36] = np.stack([np.linspace(0.42, 0.58, 5), np.full(5, 0.60)], 1)
    ang = np.linspace(0, 2 * np.pi, 6, endpoint=False)
    lm[36:42] = np.stack([0.33 + 0.05 * np.cos(ang),
                          0.40 + 0.025 * np.sin(ang)], 1)
    lm[42:48] = np.stack([0.67 + 0.05 * np.cos(ang),
                          0.40 + 0.025 * np.sin(ang)], 1)
    ang12 = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    lm[48:60] = np.stack([0.5 + 0.12 * np.cos(ang12),
                          0.72 + 0.05 * np.sin(ang12)], 1)
    ang8 = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    lm[60:68] = np.stack([0.5 + 0.06 * np.cos(ang8),
                          0.72 + 0.02 * np.sin(ang8)], 1)
    return lm


def drawn_predictor(seed, cascades=10, trees=500, depth=4, features=400,
                    scale=1e-3):
    """A 68-point dlib ``shape_predictor`` (``tgi_torch.utils.landmarks``)
    with random splits, thresholds, anchors and offsets and leaves of
    ``scale`` (so the landmarks stay near the mean face), at dlib's
    ``shape_predictor_training_options`` defaults unless told otherwise:
    cascade depth 10, 500 trees per level, tree depth 4, a feature pool
    of 400."""
    import numpy as np
    from tgi_torch.utils.landmarks import RegressionTree, ShapePredictor
    rng = np.random.RandomState(seed)
    shape0 = mean_face().reshape(-1)
    n_splits = 2 ** depth - 1
    forests, anchors, deltas = [], [], []
    for _ in range(cascades):
        forests.append([RegressionTree(
            rng.randint(0, features, (n_splits, 2)).astype(np.int64),
            rng.randn(n_splits) * 8,
            rng.randn(n_splits + 1, shape0.size) * scale)
            for _ in range(trees)])
        anchors.append(rng.randint(0, 68, features).astype(np.int64))
        deltas.append(rng.randn(features, 2) * 0.05)
    return ShapePredictor(shape0, forests, anchors, deltas)


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

    zero_counts(gs)
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
        zero_counts(gs)
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
    zero_counts(gs)
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


def counts(gs):
    """Launches per kernel; the sorted splat's three kernels apart."""
    return {"triplane_gather": gs.LAUNCHES,
            "triplane_splat": gs.SPLAT_LAUNCHES,
            "triplane_splat_sorted": gs.SORTED_SPLAT_LAUNCHES,
            "triplane_splat_keys": gs.SPLAT_KEYS_LAUNCHES,
            "triplane_splat_offsets": gs.SPLAT_OFFSETS_LAUNCHES}


def zero_counts(gs):
    """Every kernel's count to 0: the tri-plane kernels' and the bench
    kernels'."""
    from tgi_torch.ops import gather_rows as gr
    from tgi_torch.ops import splat_sched as ss
    gs.LAUNCHES = gs.SPLAT_LAUNCHES = gs.SORTED_SPLAT_LAUNCHES = 0
    gs.SPLAT_KEYS_LAUNCHES = gs.SPLAT_OFFSETS_LAUNCHES = 0
    gr.GATHER_ROWS_LAUNCHES = gr.TILEWALK_LAUNCHES = 0
    ss.SPLAT_SCHED_LAUNCHES = 0


def bench_counts():
    """Launches of the bench kernels (gather_rows.cu, gather_tilewalk.cu,
    splat_sched.cu)."""
    from tgi_torch.ops import gather_rows as gr
    from tgi_torch.ops import splat_sched as ss
    return {"gather_rows": gr.GATHER_ROWS_LAUNCHES,
            "gather_tilewalk": gr.TILEWALK_LAUNCHES,
            "splat_sched": ss.SPLAT_SCHED_LAUNCHES}


class splat_route:
    """``TGI_SPLAT`` set to ``mode`` inside the block, restored after."""

    def __init__(self, mode):
        self.mode = mode

    def __enter__(self):
        self.old = os.environ.get("TGI_SPLAT")
        os.environ["TGI_SPLAT"] = self.mode

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop("TGI_SPLAT", None)
        else:
            os.environ["TGI_SPLAT"] = self.old


def stage1_nets(torch, target_255):
    """(pose ResNet-34 with a quaternion head, VGG16, its LPIPS head) at
    full width, drawn from a seed. A random ResNet-34 saturates its tanh
    head, which leaves the pose net no gradient; its BatchNorm statistics
    are calibrated on the target (``resnet34_calibrate``), the O(1)
    operating point of a trained estimator."""
    from tgi_torch.models.pose_resnet import resnet34_calibrate, resnet34_init
    from tgi_torch.models.vgg import lpips_head_init, vgg16_init
    gen = torch.Generator().manual_seed(8)
    pose = resnet34_init(gen, 4, DEVICE)
    with torch.no_grad():
        pose = resnet34_calibrate(pose, target_255)
    return pose, vgg16_init(gen, DEVICE), lpips_head_init(gen, DEVICE)


def stage1_target(torch, G, params, seed=2, yaw=-0.25):
    """A target rendered from ``seed``'s latent at ``yaw``: (image in
    [-1, 1] at the generator's resolution, the 256² [0, 255] target the
    pose net and LPIPS read)."""
    from tgi_torch.apps.gen_samples import seed_z
    from tgi_torch.losses.warp import area_downsample
    with torch.no_grad():
        ws = G.mapping(params, seed_z(seed, G.cfg.z_dim, DEVICE),
                       _camera(torch, 0.0), truncation_psi=0.7,
                       truncation_cutoff=14)
        img = G.synthesis(params, ws, _camera(torch, yaw),
                          det=True)["image"].clamp(-1, 1)
    return img, area_downsample((img + 1) * 127.5, 256)


def stage1_setup(torch, G, params, nets):
    """A projector at full width, its initial state and the inputs of one
    joint-phase step, every draw from a seed."""
    from tgi_torch.invert.projector import Projector, ProjectorConfig
    from tgi_torch.models.vgg import lpips_features
    pose, vgg, head = nets
    img, t255 = stage1_target(torch, G, params)
    proj = Projector(G, params, vgg, head, pose,
                     ProjectorConfig(num_steps=STAGE1_STEPS))
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    state, opts, w_std = proj.init_state(generator=gen)
    with torch.no_grad():
        feats = lpips_features(vgg, head, t255)
    step = proj.cfg.cam_preheat_steps + 5
    w_noise = torch.randn(state["w"].shape, generator=gen, device=DEVICE) * (
        w_std * proj.schedule(step)[0])
    res = G.cfg.neural_rendering_resolution
    rk = G.cfg.rendering_kwargs
    cpu = torch.Generator().manual_seed(10)
    draws = tuple((torch.rand(1, res * res, rk["depth_resolution"], 1,
                              generator=cpu).to(DEVICE),
                   torch.rand(res * res, rk["depth_resolution_importance"],
                              generator=cpu).to(DEVICE)) for _ in range(2))
    return dict(proj=proj, state=state, opts=opts, t255=t255, img=img,
                feats=feats, w_noise=w_noise, draws=draws, step=step,
                gen=gen)


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _group_vec(torch, grads, group):
    """Every tensor of ``group`` in ``grads``, flattened into one."""
    return torch.cat([t.flatten() for k, t in grads.items()
                      if k.split(".")[0] == group])


def _group_err(torch, a, b, group):
    """Norm-wise error of a against b over every tensor of ``group``,
    and b's norm."""
    vb = _group_vec(torch, b, group)
    return _norm_err(_group_vec(torch, a, group), vb), vb.norm().item()


def phase_stage1_grads(torch, gs, st):
    """One full-width stage-1 step's gradients (w, every noise buffer,
    every pose-net leaf, the translation) through the kernels, again,
    through the plain sampler's autograd, and under ``TGI_SPLAT=mxu``,
    with deterministic cuDNN algorithms. The camera reaches the render
    only through the predicted view's sample points, so the step again
    with those points detached (both samplers) isolates the share of the
    pose-net gradient that crosses the splat's ``d_coords``; that share
    must be well above the kernels' error, so that the comparison sees
    ``d_coords``. Returns the launches per step and the sorted splat's
    inputs (the main path's own)."""
    import tgi_torch.render.renderer as renderer
    proj, state = st["proj"], st["state"]
    named = dict(_named_leaves(state))
    real = {name: getattr(gs, name) for name in
            ("triplane_splat_cuda", "triplane_splat_sorted_cuda")}
    flags, seen = [], []

    def record_splat(*args, **kw):
        out = real["triplane_splat_cuda"](*args, **kw)
        flags.append((args[4], kw.get("want_dplanes", True),
                      None if out[1] is None else out[1].abs().max().item()))
        return out

    def detached(sampler):
        return lambda planes, coords, box_warp: sampler(
            planes, coords.detach(), box_warp)

    def record_sorted(*args):
        seen.append(args)
        return real["triplane_splat_sorted_cuda"](*args)

    def grads(mode="pack", sampler=None):
        for t in named.values():
            t.grad = None
        renderer.sample_triplanes = sampler or gs.sample_triplanes
        gs.triplane_splat_cuda = record_splat
        gs.triplane_splat_sorted_cuda = record_sorted
        try:
            with splat_route(mode):
                loss, _ = proj._loss(state, st["t255"], st["feats"],
                                     st["w_noise"], draws=st["draws"],
                                     target_warp=st["img"])
                loss.backward()
            torch.cuda.synchronize()
            return {k: t.grad.clone() for k, t in named.items()}
        finally:
            renderer.sample_triplanes = gs.sample_triplanes
            for name, fn in real.items():
                setattr(gs, name, fn)

    torch.backends.cudnn.deterministic = True
    try:
        zero_counts(gs)
        kernel = grads()
        per_step = counts(gs)
        with_coords = [top for need, _, top in flags if need]
        check(per_step == {"triplane_gather": 4, "triplane_splat": 4,
                           "triplane_splat_sorted": 0,
                           "triplane_splat_keys": 0,
                           "triplane_splat_offsets": 0}
              and len(with_coords) == 2,
              f"launches per stage-1 step {per_step}, {len(with_coords)} "
              f"with d_coords; expected 4 gathers and 4 splats, 2 with "
              f"d_coords")
        check(all(top > 0 for top in with_coords),
              f"the splat gave d_coords of max |.| {with_coords}")
        again = grads()
        before = counts(gs)
        plain = grads(sampler=gs.sample_triplanes_plain)
        check(counts(gs) == before, "the plain sampler launched a kernel")
        kernel_det = grads(sampler=detached(gs.sample_triplanes))
        plain_det = grads(sampler=detached(gs.sample_triplanes_plain))
        zero_counts(gs)
        flags.clear()
        mxu = grads("mxu")
        per_step_mxu = counts(gs)
        coords_only = sum(need and not want for need, want, _ in flags)
        check(per_step_mxu == {"triplane_gather": 4, "triplane_splat": 2,
                               "triplane_splat_sorted": 4,
                               "triplane_splat_keys": 4,
                               "triplane_splat_offsets": 4}
              and coords_only == 2,
              f"launches per stage-1 step under TGI_SPLAT=mxu "
              f"{per_step_mxu}; expected 4 gathers, 4 sorted splats and 2 "
              f"d_coords-only splats")
    finally:
        torch.backends.cudnn.deterministic = False
    log(f"stage-1 step launches: default {per_step} ({len(with_coords)} "
        f"splats with d_coords, max |d_coords| {with_coords}); TGI_SPLAT=mxu "
        f"{per_step_mxu} ({coords_only} splats for d_coords only)")
    pose = _group_vec(torch, kernel, "pose")
    share = pose - _group_vec(torch, kernel_det, "pose")
    share_plain = (_group_vec(torch, plain, "pose")
                   - _group_vec(torch, plain_det, "pose"))
    gap = (pose - _group_vec(torch, plain, "pose")).norm().item()
    log(f"pose-net gradient through the splat's d_coords (the step minus "
        f"the step with the sample points detached): norm "
        f"{share.norm().item():.4g} of the whole {pose.norm().item():.4g}; "
        f"kernels vs plain sampler, whole gradient: abs norm err "
        f"{gap:.3g}; the d_coords share, kernels vs plain: norm err "
        f"{_norm_err(share, share_plain):.3g}")
    check(share.norm().item() > 0 and share.norm().item() >= 100 * gap,
          f"the pose-net gradient's d_coords share {share.norm().item()} is "
          f"not well above the kernels' error {gap}")
    worst = 0.0
    for group in ("w", "noise", "pose", "translation"):
        err, scale = _group_err(torch, kernel, plain, group)
        err2, _ = _group_err(torch, again, kernel, group)
        err_mxu, _ = _group_err(torch, mxu, kernel, group)
        log(f"stage-1 gradient of {group}: norm {scale:.4g}; kernels vs "
            f"plain sampler: norm err {err:.3g}; kernels twice: {err2:.3g}; "
            f"TGI_SPLAT=mxu vs default: {err_mxu:.3g}")
        check(math.isfinite(scale) and scale > 0,
              f"the stage-1 step gives {group} no gradient")
        check(err <= STAGE1_GRAD_TOL and err_mxu <= STAGE1_GRAD_TOL,
              f"{group}: kernels vs plain {err}, mxu vs default {err_mxu} > "
              f"{STAGE1_GRAD_TOL}")
        worst = max(worst, err, err_mxu)
    leaf_errs = sorted((_norm_err(kernel[k], plain[k]), k) for k in named
                       if plain[k].abs().max().item() > 0)
    log(f"stage-1 gradients per tensor, kernels vs plain: worst norm err "
        f"{leaf_errs[-1][0]:.3g} ({leaf_errs[-1][1]}) over {len(leaf_errs)} "
        f"tensors")
    return {"default": per_step, "mxu": per_step_mxu, "worst": worst}, seen


def phase_stage1_stage2(torch, gs, G, params, nets, tmp, mode, label):
    """Stage 1 and stage 2 through ``run_pti``'s ``invert_one`` without
    pivots, with ``TGI_SPLAT=mode``: STAGE1_STEPS projection steps on a
    target rendered from seed 2's latent at yaw -0.25, then PTI_STEPS
    tuning steps around the pivots it wrote, in the output directory
    ``label``. Returns the launches of each stage and the losses."""
    import numpy as np
    from tgi_torch.apps.run_pti import invert_one, pivot_files
    from tgi_torch.invert.coach import CoachConfig, PTICoach
    from tgi_torch.invert.projector import Projector, ProjectorConfig
    from tgi_torch.losses.lpips import make_lpips
    pose, vgg, head = nets
    img, t255 = stage1_target(torch, G, params)
    out = os.path.join(tmp, f"stage1_{label}")
    os.makedirs(out)
    proj = Projector(G, params, vgg, head, pose,
                     ProjectorConfig(num_steps=STAGE1_STEPS))
    lpips = make_lpips("alex", generator=torch.Generator().manual_seed(5),
                       device=DEVICE)
    coach = PTICoach(G, lpips, CoachConfig(max_pti_steps=PTI_STEPS,
                                           lpips_threshold=0.0))
    at_stage2 = {}
    real_tune = coach.tune

    def tune(gen_params, ws, cam, *args, **kw):
        torch.cuda.synchronize()
        at_stage2.update(launches=counts(gs), t=time.perf_counter(),
                         ws=ws.cpu().numpy(), cam=cam.cpu().numpy())
        return real_tune(gen_params, ws, cam, *args, **kw)

    coach.tune = tune
    try:
        import PIL  # noqa: F401
        png_renders = 2     # invert_one renders the pivot and the result
    except ImportError:
        png_renders = 0
    with splat_route(mode):
        torch.cuda.synchronize()
        zero_counts(gs)
        t0 = time.perf_counter()
        entry, _, info = invert_one(
            "face", img, G=G, gen_params=params, coach=coach, out_dir=out,
            projector=proj, target_255=t255, use_last_w_pivots=False,
            generator=torch.Generator(device=DEVICE).manual_seed(11))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total = counts(gs)
        bench_kernels = bench_counts()
    stage1 = at_stage2["launches"]
    stage2 = {k: total[k] - stage1[k] for k in total}
    proj_losses = info["projection"]["loss"]
    log(f"stage 1 + stage 2 (invert_one without pivots, TGI_SPLAT={mode}) "
        f"in {wall:.1f} s (stage 1 {at_stage2['t'] - t0:.1f} s): stage 1 "
        f"{len(proj_losses)} steps, loss {proj_losses[0]:.5g} -> "
        f"{proj_losses[-1]:.5g}; stage 2 {info['steps']} steps, loss "
        f"{info['losses'][0]:.5g} -> {info['losses'][-1]:.5g}; pivots ws "
        f"{at_stage2['ws'].shape}, cam {at_stage2['cam'].shape}; launches "
        f"stage 1 {stage1}, stage 2 {stage2}; entry {entry}")
    ws_file, cam_file = pivot_files(out, "face")
    check(os.path.exists(ws_file) and os.path.exists(cam_file),
          "stage 1 wrote no pivot files")
    check(np.array_equal(np.load(ws_file), at_stage2["ws"])
          and np.array_equal(np.load(cam_file), at_stage2["cam"]),
          "stage 2 did not tune around the pivots stage 1 wrote")
    check(at_stage2["ws"].shape == (1, G.cfg.num_ws, G.cfg.w_dim)
          and at_stage2["cam"].shape == (1, 25), "pivots of the wrong shape")
    check(len(proj_losses) == STAGE1_STEPS and info["steps"] == PTI_STEPS,
          f"{len(proj_losses)} projection and {info['steps']} tuning steps")
    check(all(math.isfinite(x) for x in proj_losses + info["losses"]),
          "non-finite loss")
    sorted_mode = mode == "mxu"
    sorted1 = 4 * STAGE1_STEPS if sorted_mode else 0
    sorted2 = 2 * PTI_STEPS if sorted_mode else 0
    want1 = {"triplane_gather": 4 * STAGE1_STEPS,
             "triplane_splat": (2 if sorted_mode else 4) * STAGE1_STEPS,
             "triplane_splat_sorted": sorted1, "triplane_splat_keys": sorted1,
             "triplane_splat_offsets": sorted1}
    want2 = {"triplane_gather": 2 * (PTI_STEPS + png_renders),
             "triplane_splat": 0 if sorted_mode else 2 * PTI_STEPS,
             "triplane_splat_sorted": sorted2, "triplane_splat_keys": sorted2,
             "triplane_splat_offsets": sorted2}
    check(stage1 == want1 and stage2 == want2,
          f"launches stage 1 {stage1}, stage 2 {stage2}; expected {want1}, "
          f"{want2}")
    check(not any(bench_kernels.values()),
          f"run_pti launched a bench kernel: {bench_kernels}")
    return {"stage1": stage1, "stage2": stage2, "wall": wall,
            "bench_kernels": bench_kernels,
            "losses1": proj_losses, "losses2": info["losses"]}


def phase_route_spread(runs):
    """How far two ``invert_one`` runs part: two runs of one splat mode
    (run-to-run order of the fused splat's atomics and of cuDNN's
    default algorithms; the sorted splat repeats its bits) and the two
    modes. Logs, per pair, the first stage-1 step whose loss differs and
    the largest loss difference of each stage."""
    for a, b in (("pack", "pack_again"), ("mxu", "mxu_again"),
                 ("pack", "mxu")):
        d1 = [abs(x - y) for x, y in zip(runs[a]["losses1"],
                                         runs[b]["losses1"])]
        d2 = [abs(x - y) for x, y in zip(runs[a]["losses2"],
                                         runs[b]["losses2"])]
        first = next((i for i, d in enumerate(d1) if d > 0), None)
        log(f"stage-1/2 loss spread, {a} vs {b}: first differing stage-1 "
            f"step {first}; max |Δ loss| stage 1 {max(d1):.4g} (last step "
            f"{d1[-1]:.4g}), stage 2 {max(d2):.4g}; first stage-1 losses "
            f"{runs[a]['losses1'][:3]}, {runs[b]['losses1'][:3]}; last "
            f"{runs[a]['losses1'][-1]:.5g}, {runs[b]['losses1'][-1]:.5g}")


def phase_pkl_bf16(torch, gs, G, params, nets, tmp):
    """The path of a user with an EG3D ``.pkl``, in ``tgi``'s mixed
    precision: a full-width reference-layout pickle of the generator's
    weights, written here (``reference_pickle``), read back through
    ``run_pti.load_any_generator`` (a bf16 generator, every parameter bit
    for bit); a 512² render in bf16 beside fp32; ``invert_one`` on the
    bf16 generator without pivots (PKL_STAGE1_STEPS float32 projection
    steps, PKL_PTI_STEPS tuning steps in bf16) with every count set to 0
    before it; one bf16 tuning step's gradients through the kernels
    against the plain sampler; a bf16 render and tuning step timed beside
    float32 ones. Returns the launches per part and the times."""
    import numpy as np
    from tgi_torch.apps.run_pti import invert_one, load_any_generator
    from tgi_torch.invert.coach import CoachConfig, PTICoach
    from tgi_torch.invert.projector import Projector, ProjectorConfig
    from tgi_torch.losses.lpips import make_lpips
    import tgi_torch.render.renderer as renderer

    t0 = time.perf_counter()
    path = os.path.join(tmp, "ffhqrebalanced512-128.pkl")
    with open(path, "wb") as f:
        f.write(reference_pickle(G.cfg, params))
    t1 = time.perf_counter()
    G16, p16 = load_any_generator(path, device=DEVICE)
    torch.cuda.synchronize()
    log(f"pkl_bf16: wrote a {os.path.getsize(path) / 2 ** 20:.1f} MiB "
        f"reference pickle in {t1 - t0:.1f} s, read it through "
        f"load_any_generator in {time.perf_counter() - t1:.1f} s: "
        f"fused_dtype {G16.cfg.fused_dtype}, sr_num_fp16_res "
        f"{G16.cfg.sr_num_fp16_res}, neural_rendering_resolution "
        f"{G16.cfg.neural_rendering_resolution}")
    check(G16.cfg.fused_dtype == "bfloat16"
          and dataclasses.replace(G16.cfg, fused_dtype="float32") == G.cfg,
          f"the pickle's config {G16.cfg} is not the generator's in bf16")
    got, want = dict(_named_leaves(p16)), dict(_named_leaves(params))
    check(set(got) == set(want) and all(
        torch.equal(got[k], want[k]) for k in want),
          "the pickle's parameters do not read back bit for bit")
    log(f"pkl_bf16: all {len(want)} parameter tensors read back bit for bit")

    zero_counts(gs)
    out16 = render_once(torch, G16, p16)
    torch.cuda.synchronize()
    render_launches = counts(gs)
    out32 = render_once(torch, G, params)
    img16, img32 = out16["image"], out32["image"]
    R = G.cfg.img_resolution
    check(bool(torch.isfinite(img16).all()) and tuple(img16.shape) == (
        1, 3, R, R), f"bf16 render {tuple(img16.shape)} not finite")
    d = (img16 - img32).abs()
    psnr = 10 * math.log10(4.0 / (d.square().mean().item() or 1e-30))
    log(f"pkl_bf16: {R}² render, bf16 vs fp32: max abs diff "
        f"{d.max().item():.4g}, mean abs diff {d.mean().item():.4g}, PSNR "
        f"{psnr:.2f} dB (peak-to-peak 2); image_raw max abs diff "
        f"{(out16['image_raw'] - out32['image_raw']).abs().max().item():.4g};"
        f" launches {render_launches}")
    check(render_launches["triplane_gather"] == 2,
          f"the bf16 render launched {render_launches}")

    pose, vgg, head = nets
    img, t255 = stage1_target(torch, G, params)
    out = os.path.join(tmp, "pkl_bf16")
    os.makedirs(out)
    proj = Projector(G16, p16, vgg, head, pose, ProjectorConfig(
        num_steps=PKL_STAGE1_STEPS, cam_preheat_steps=PKL_STAGE1_STEPS // 2))
    lpips = make_lpips("alex", generator=torch.Generator().manual_seed(5),
                       device=DEVICE)
    coach = PTICoach(G16, lpips, CoachConfig(max_pti_steps=PKL_PTI_STEPS,
                                             lpips_threshold=0.0))
    at_stage2 = {}
    real_tune = coach.tune

    def tune(gen_params, ws, cam, *args, **kw):
        torch.cuda.synchronize()
        at_stage2.update(launches=counts(gs), t=time.perf_counter(), ws=ws,
                         cam=cam)
        return real_tune(gen_params, ws, cam, *args, **kw)

    coach.tune = tune
    try:
        import PIL  # noqa: F401
        png_renders = 2
    except ImportError:
        png_renders = 0
    torch.cuda.synchronize()
    zero_counts(gs)
    t0 = time.perf_counter()
    entry, tuned, info = invert_one(
        "face", img, G=G16, gen_params=p16, coach=coach, out_dir=out,
        projector=proj, target_255=t255, use_last_w_pivots=False,
        generator=torch.Generator(device=DEVICE).manual_seed(11))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = counts(gs)
    stage1 = at_stage2["launches"]
    stage2 = {k: total[k] - stage1[k] for k in total}
    losses1 = info["projection"]["loss"]
    log(f"pkl_bf16: invert_one on the bf16 generator in {wall:.1f} s "
        f"(stage 1 {at_stage2['t'] - t0:.1f} s): stage 1 {len(losses1)} "
        f"fp32-render steps, loss {losses1[0]:.5g} -> {losses1[-1]:.5g}; "
        f"stage 2 {info['steps']} bf16 steps, loss {info['losses'][0]:.5g}"
        f" -> {info['losses'][-1]:.5g}; launches stage 1 {stage1}, stage 2 "
        f"{stage2}; entry {entry}")
    check(len(losses1) == PKL_STAGE1_STEPS and info["steps"] == PKL_PTI_STEPS
          and all(math.isfinite(x) for x in losses1 + info["losses"]),
          f"{len(losses1)} projection, {info['steps']} tuning steps, "
          f"losses {losses1}, {info['losses']}")
    want1 = {"triplane_gather": 4 * PKL_STAGE1_STEPS,
             "triplane_splat": 4 * PKL_STAGE1_STEPS}
    want2 = {"triplane_gather": 2 * (PKL_PTI_STEPS + png_renders),
             "triplane_splat": 2 * PKL_PTI_STEPS}
    check(all(stage1[k] == v for k, v in want1.items())
          and all(stage2[k] == v for k, v in want2.items()),
          f"launches stage 1 {stage1}, stage 2 {stage2}; expected {want1}, "
          f"{want2}")
    check(all(t.dtype == torch.float32 for t in _leaves(tuned)),
          "the tuned parameters are not float32")
    check(np.isfinite(np.load(os.path.join(out, "face_ws.npy"))).all(),
          "non-finite pivot")

    ws, cam = at_stage2["ws"], at_stage2["cam"]
    res = G16.cfg.neural_rendering_resolution
    rk = G16.cfg.rendering_kwargs
    cpu = torch.Generator().manual_seed(12)
    jitter = torch.rand(1, res * res, rk["depth_resolution"], 1,
                        generator=cpu).to(DEVICE)
    u = torch.rand(res * res, rk["depth_resolution_importance"],
                   generator=cpu).to(DEVICE)
    tree = _map_detach(p16)
    leaves = dict(_named_leaves(tree))

    def grads(sampler):
        renderer.sample_triplanes = sampler
        for t in leaves.values():
            t.grad = None
        try:
            loss, _ = coach._loss(tree, ws, cam, img, jitter=jitter, u=u)
            loss.backward()
            torch.cuda.synchronize()
            return {k: t.grad for k, t in leaves.items()
                    if t.grad is not None}
        finally:
            renderer.sample_triplanes = gs.sample_triplanes

    torch.backends.cudnn.deterministic = True
    try:
        zero_counts(gs)
        kernel = grads(gs.sample_triplanes)
        check_launches = counts(gs)
        again = grads(gs.sample_triplanes)
        plain = grads(gs.sample_triplanes_plain)
    finally:
        torch.backends.cudnn.deterministic = False
    check(check_launches["triplane_gather"] == 2
          and check_launches["triplane_splat"] == 2,
          f"one bf16 tuning step launched {check_launches}")
    check(all(t.dtype == torch.float32 for t in kernel.values()),
          "a bf16 step gave a gradient that is not float32")
    worst = 0.0
    for group in ("backbone", "superresolution", "decoder"):
        err, scale = _group_err(torch, kernel, plain, group)
        err2, _ = _group_err(torch, again, kernel, group)
        log(f"pkl_bf16: bf16 stage-2 gradient of {group}: norm {scale:.4g}; "
            f"kernels vs plain sampler: norm err {err:.3g}; kernels twice: "
            f"{err2:.3g}")
        check(math.isfinite(scale) and scale > 0,
              f"the bf16 step gives {group} no gradient")
        check(err <= BF16_GRAD_TOL, f"{group}: bf16 gradient, kernels vs "
              f"plain sampler {err} > {BF16_GRAD_TOL}")
        worst = max(worst, err)

    walls = {"float32": [], "bfloat16": []}
    for _ in range(3):
        for name, gen, p in (("float32", G, params), ("bfloat16", G16, p16)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render_once(torch, gen, p)
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    render_ms = {k: statistics.median(v) for k, v in walls.items()}
    log(f"times, one full-width render (mapping + synthesis, {R}² image; "
        f"host clock, in turns): fp32 median {render_ms['float32']:.1f} ms "
        f"of {walls['float32']}, bf16 (.pkl) median "
        f"{render_ms['bfloat16']:.1f} ms of {walls['bfloat16']}")

    st16 = dict(coach=coach, ws=ws, cam=cam, target=img)
    coach32 = PTICoach(G, lpips, CoachConfig(max_pti_steps=PKL_PTI_STEPS,
                                             lpips_threshold=0.0))
    step32, _ = phase_step_times(torch, gs, params, dict(st16, coach=coach32),
                                 label="fp32 (beside bf16)")
    step16, _ = phase_step_times(torch, gs, p16, st16, label="bf16 (.pkl)")
    return {"render": render_launches, "stage1": stage1, "stage2": stage2,
            "wall": wall, "grad_worst": worst, "step_ms": {
                "float32": step32["step"], "bfloat16": step16["step"]},
            "render_ms": render_ms, "render_psnr": psnr}


# Phase 12: the self-inversion gate with bootstrapped aux nets, cut to
# 64 pseudo-dataset images, 100 pose and 50 VGG steps, and 20 + 60
# inversion steps (10 of them camera-only preheat). Stage 2's raw-image
# term first pulls the 512² image off the pivot: on an H100 the final
# MSE stood at 2.8-2.9 x the pivot's after 10-20 tuning steps, 0.91 x
# after 30 and 0.54 x after 60 (PERF.md §6, PR 13 call 12).
GATE_BOOTSTRAP = dict(num_images=64, pose_steps=100, vgg_steps=50)
GATE_STAGE1, GATE_STAGE2, GATE_PREHEAT, GATE_TRACE = 20, 60, 10, 10
# e4e (IR-SE50, 256²) and ArcFace (112²) on the card against their CPU
# run: max|Δ| <= FACE_TOL * max|CPU|. With their BatchNorm statistics
# calibrated (``_calibrate_trunk``) each net's float32 output stands
# ~1e-6 of its largest value from its float64 one on the CPU, so two
# float32 runs that sum in other orders part by ~1e-5 at most.
FACE_TOL = 1e-4


def _falls(losses, k=10):
    """Mean of the last k losses below the mean of the first k."""
    k = min(k, len(losses) // 2)
    return sum(losses[-k:]) / k < sum(losses[:k]) / k


def phase_selfinv_gate(torch, gs):
    """The gate through ``tgi_torch.scripts.selfinv_gate.run_gate`` at full
    width, on the gate's own generator (``selfinv_gate.GENERATOR_SEED``:
    seed 0's target is black, and no metric of the gate moves with w or
    the camera there), the pose ResNet-34, VGG16 and AlexNet-LPIPS from
    seeds: the aux nets bootstrapped on a pseudo-dataset the generator
    renders (GATE_BOOTSTRAP), then ``self_inversion_eval`` with the
    bootstrapped e4e start, the pose net aimed 3 degrees off, the quat
    camera lr / 30 (bench.py's harness adjustment for bootstrapped nets,
    not the product's), the production 0.06 early-stop probe and the
    quality traced every GATE_TRACE steps. Checks that both bootstrap
    losses fall, the CPU gate test's assertions
    (tests/test_torch_selfinv.py::test_gate_end_to_end), and the
    kernels' launches in each part, every count set to 0 before the
    run."""
    from tgi_torch.scripts import selfinv_gate
    G, params = selfinv_gate.full_width_generator(
        DEVICE, seed=selfinv_gate.GENERATOR_SEED)
    zero_counts(gs)
    out = selfinv_gate.run_gate(G, params, device=DEVICE, stage1=GATE_STAGE1,
                                stage2=GATE_STAGE2, preheat=GATE_PREHEAT,
                                trace_every=GATE_TRACE, batch=BATCH, log=log,
                                **GATE_BOOTSTRAP)
    rep, q, launched = out["bootstrap"], out["gate"], out["launches"]
    log(f"selfinv gate: bootstrap {out['seconds']['bootstrap']:.1f} s "
        f"(dataset {rep['dataset_s']:.1f}, pose {rep['pose_train_s']:.1f}, "
        f"vgg {rep['vgg_train_s']:.1f}); pose loss "
        f"{rep['pose_losses'][0]:.4f} -> {rep['pose_losses'][-1]:.4f}, val "
        f"rot {rep['pose_val_rot_deg']:.2f} deg; vgg loss "
        f"{rep['vgg_losses'][0]:.4f} -> {rep['vgg_losses'][-1]:.4f}; gate "
        f"{out['seconds']['gate']:.1f} s (stage 1 {q['stage1_s']:.1f}, "
        f"stage 2 {q['stage2_s']:.1f}, probe {q['es_s']:.1f}); metrics "
        f"{ {k: v for k, v in q.items() if not k.endswith('_s')} }; "
        f"launches {launched}")
    check(_falls(rep["pose_losses"]) and _falls(rep["vgg_losses"]),
          "a bootstrap loss did not fall: pose "
          f"{rep['pose_losses'][:3]}...{rep['pose_losses'][-3:]}, vgg "
          f"{rep['vgg_losses'][:3]}...{rep['vgg_losses'][-3:]}")
    check(all(math.isfinite(v) for k, v in q.items()
              if not k.endswith("_trace")), f"non-finite gate metric: {q}")
    check(q["stage1_final_loss"] < q["stage1_first_loss"],
          "the gate's stage-1 loss did not fall")
    ratio = q["final_mse"] / q["pivot_mse"]
    log(f"selfinv gate: final / pivot MSE {ratio:.3g} (stage 2 loss "
        f"{q['stage2_first_loss']:.4g} -> {q['stage2_final_loss']:.4g})")
    check(ratio <= 1.05, f"stage 2 left the final MSE at {ratio:.3g} x the "
          "pivot's")
    check(q["pti_steps"] <= GATE_STAGE2 and q["es_threshold"] == 0.06
          and 0 <= q["es_steps"] <= GATE_STAGE2, f"steps {q}")
    check(abs(q["init_pose_err_deg"] - 3.0) < 0.1,
          f"the aimed pose net starts {q['init_pose_err_deg']} deg off")
    renders = GATE_BOOTSTRAP["num_images"] // 8
    es, s1, s2 = q["es_steps"], GATE_STAGE1, GATE_STAGE2
    es_renders = es + (es < s2)      # the render that stopped it
    qconv = len(q["quality_trace"])
    want = {"bootstrap": {"triplane_gather": 2 * renders,
                          "triplane_splat": 0, "triplane_splat_sorted": 0},
            # target; stage 1; stage 2; its quality trace; the probe;
            # pivot, final and probe quality.
            "gate": {"triplane_gather": 2 + 4 * s1 + 2 * s2 + 2 * qconv
                     + 2 * es_renders + 6,
                     "triplane_splat": 4 * s1 + 2 * s2 + 2 * es,
                     "triplane_splat_sorted": 0}}
    got = {k: launched[k] for k in want}
    check(got == want, f"gate launches {got}, expected {want}")
    return out


def _calibrate_trunk(torch, params, x):
    """An IR-SE50 trunk's BatchNorm statistics set, block by block, from
    the activations the batch ``x`` gives them: the O(1) operating point
    of a trained net. With identity statistics a random trunk's
    activations grow to ~1e4-1e6 and its float32 output parts from its
    float64 one by ~5e-3 of its largest value on the CPU (ArcFace, seed
    12), so two float32 runs cannot be compared."""
    from tgi_torch.models import irse
    from tgi_torch.scripts.inception_error_scale import bn_stats
    il = dict(params["input_layer"])
    y = irse.conv(x, il["0"]["weight"], padding=1)
    il["1"] = bn_stats(il["1"], y)
    y = irse.prelu(il["2"], irse.batchnorm(il["1"], y))
    body = {}
    for i, (_, _, stride) in enumerate(irse.get_blocks(50)):
        p = dict(params["body"][str(i)])
        r = dict(p["res_layer"])
        r["0"] = bn_stats(r["0"], y)
        z = irse.conv(irse.batchnorm(r["0"], y), r["1"]["weight"], padding=1)
        z = irse.conv(irse.prelu(r["2"], z), r["3"]["weight"], stride=stride,
                      padding=1)
        r["4"] = bn_stats(r["4"], z)
        p["res_layer"] = r
        if "shortcut_layer" in p:
            sc = dict(p["shortcut_layer"])
            sc["1"] = bn_stats(sc["1"], irse.conv(y, sc["0"]["weight"],
                                                   stride=stride))
            p["shortcut_layer"] = sc
        y = irse.bottleneck_apply(p, y, stride, True)
        body[str(i)] = p
    return {**params, "input_layer": il, "body": body}, y


def _face_inputs(torch):
    """Full-width e4e and ArcFace weights from seed 12, their BatchNorm
    statistics calibrated on four seeded images (``_calibrate_trunk``;
    ArcFace's two output BatchNorms too), e4e's first code's linear
    scaled so its codes on a grey image reach 0.5 (a trained encoder's
    start lies near w_avg), and their inputs from seed 13: (e4e CPU
    params, ArcFace CPU params, 256² [0, 255] input, 112² input)."""
    from tgi_torch.models.arcface import arcface_init
    from tgi_torch.models.e4e import e4e_encode_w0, e4e_init
    from tgi_torch.models.irse import batchnorm
    from tgi_torch.scripts.inception_error_scale import bn_stats
    gen = torch.Generator().manual_seed(12)
    enc = e4e_init(gen, device="cpu")
    arc = arcface_init(gen, device="cpu")
    with torch.no_grad():
        enc, _ = _calibrate_trunk(
            torch, enc, torch.rand((4, 3, 256, 256), generator=gen) * 255)
        arc, t = _calibrate_trunk(
            torch, arc, torch.randn((4, 3, 112, 112), generator=gen))
        ol = dict(arc["output_layer"])
        ol["0"] = bn_stats(ol["0"], t)
        z = (batchnorm(ol["0"], t).reshape(4, -1) @ ol["3"]["weight"].T
             + ol["3"]["bias"])
        ol["4"] = bn_stats(ol["4"], z)
        arc["output_layer"] = ol
        w0 = e4e_encode_w0(enc, torch.full((1, 3, 256, 256), 128.0))
    enc["styles"]["0"]["linear"]["weight"] *= 0.5 / float(w0.abs().max())
    gen = torch.Generator().manual_seed(13)
    return (enc, arc, torch.rand((1, 3, 256, 256), generator=gen) * 255,
            torch.randn((1, 3, 112, 112), generator=gen))


def phase_faces_vs_cpu(torch):
    """e4e's codes (``e4e_apply``, 256²) and ArcFace's embedding (112²) on
    the card against their CPU run on the same weights, within FACE_TOL
    of the largest CPU value. Returns the CPU weights and the errors."""
    from tgi_torch.models.arcface import arcface_apply
    from tgi_torch.models.e4e import e4e_apply
    enc, arc, x_e, x_a = _face_inputs(torch)
    errs = {}
    for name, fn, p, x in (("e4e", e4e_apply, enc, x_e),
                           ("arcface", arcface_apply, arc, x_a)):
        t0 = time.perf_counter()
        with torch.no_grad():
            want = fn(p, x)
            t1 = time.perf_counter()
            got = fn(_to(p, DEVICE), x.to(DEVICE)).cpu()
        scale = float(want.abs().max())
        errs[name] = float((got - want).abs().max()) / scale
        log(f"{name} on the card vs the CPU: shape {tuple(got.shape)}, "
            f"max|Δ| / max|CPU| {errs[name]:.3g} (CPU {t1 - t0:.1f} s)")
        check(bool(torch.isfinite(got).all()) and errs[name] <= FACE_TOL,
              f"{name} on the card parts from the CPU by {errs[name]} of "
              f"its largest value > {FACE_TOL}")
    return enc, arc, errs


def phase_run_pti_eval(torch, gs, G, params, enc, arc, tmp):
    """``run_pti`` with the e4e start and ``--eval``, from seeded ``.pt``
    files read and checked as the command line reads and checks them
    (``load_e4e_weights``, ``load_arcface_weights``, ``validate_aux`` at
    full width; the function is called, so the run needs no click): a
    512² target rendered from seed 2's latent, saved as ``.npy`` (read
    without Pillow), 20 projection steps (camera only) and up to 10
    tuning steps under the production 0.06 early stop; checks the
    metrics it writes and the launches, every count set to 0 before the
    run."""
    import numpy as np
    from tgi_torch.apps import run_pti as app
    img, _ = stage1_target(torch, G, params)
    imgs, out = os.path.join(tmp, "eval_images"), os.path.join(tmp, "eval")
    os.makedirs(imgs)
    np.save(os.path.join(imgs, "face.npy"), img[0].cpu().numpy())
    t0 = time.perf_counter()
    torch.save({"state_dict": {f"encoder.{k}": v
                               for k, v in _named_leaves(enc)},
                "latent_avg": torch.zeros(18, 512)},
               os.path.join(tmp, "e4e.pt"))
    torch.save(dict(_named_leaves(arc)), os.path.join(tmp, "arcface.pt"))
    t1 = time.perf_counter()
    e4e_p, _ = app.load_e4e_weights(os.path.join(tmp, "e4e.pt"), DEVICE)
    arc_p = app.load_arcface_weights(os.path.join(tmp, "arcface.pt"),
                                     DEVICE)
    app.validate_aux(e4e_params=e4e_p, arcface_params=arc_p)
    torch.cuda.synchronize()
    mib = os.path.getsize(os.path.join(tmp, "e4e.pt")) / 2 ** 20
    log(f"run_pti --eval: e4e.pt {mib:.0f} MiB and arcface.pt written in "
        f"{t1 - t0:.1f} s, read and checked at full width in "
        f"{time.perf_counter() - t1:.1f} s")
    try:
        import PIL  # noqa: F401
        png_renders = 1     # the pivot grid; the final render is eval's
    except ImportError:
        png_renders = 0
    zero_counts(gs)
    t0 = time.perf_counter()
    res = app.run_pti(imgs, out, G=G, gen_params=params, e4e_params=e4e_p,
                      arcface_params=arc_p, do_evaluation=True,
                      gen_video=False,
                      first_inv_steps=STAGE1_STEPS // 3,
                      max_pti_steps=PTI_STEPS, seed=3, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts(gs)
    entry = res[0]
    log(f"run_pti --e4e-weights --arcface-weights --eval: {wall:.1f} s, "
        f"entry {entry}, launches {launched}")
    with open(os.path.join(out, "facemetrics.txt")) as f:
        written = json.load(f)
    check(written == entry, "facemetrics.txt is not the results entry")
    check(all(math.isfinite(entry[k]) for k in
              ("mse", "lpips", "ms_ssim", "id_similarity", "final_lpips")),
          f"non-finite metric {entry}")
    check(0 <= entry["ms_ssim"] <= 1 and -1 <= entry["id_similarity"] <= 1,
          f"a metric out of its range: {entry}")
    # run_pti tunes with the production 0.06 early stop: s2 updates, and
    # one more render when the stop fired before PTI_STEPS.
    s1, s2 = STAGE1_STEPS // 3, entry["pti_steps"]
    want = {"triplane_gather": 4 * s1 + 2 * (s2 + (s2 < PTI_STEPS) + 1
                                             + png_renders),
            "triplane_splat": 4 * s1 + 2 * s2,
            "triplane_splat_sorted": 0, "triplane_splat_keys": 0,
            "triplane_splat_offsets": 0}
    check(launched == want, f"run_pti --eval launches {launched}, expected "
          f"{want}")
    return {"launches": launched, "wall": wall, "entry": entry}


# Phase 13: what run_pti writes at tgi's defaults, and GANSpace. The
# 256³ mesh grid goes in 16 chunks of 1<<20 points (z fastest); the orbit
# renders 8 frames 4 at a time with 96 + 96 samples; run_pti inverts 20
# + 10 steps with its outputs on; the PCA maps 100,000 (25 x 4096) z.
MESH_RES, MESH_CHUNK, MESH_QUANTILE = 256, 1 << 20, 0.999
ORBIT_FRAMES, ORBIT_BATCH, ORBIT_SAMPLE_MULT = 8, 4, 2
OUTPUTS_STAGE1, OUTPUTS_PTI = 20, 10
PCA_SAMPLES, PCA_BATCH = 100_000, 4096


def _outputs_ws(torch, G, params, seed=1):
    from tgi_torch.apps.gen_samples import seed_z
    with torch.no_grad():
        return G.mapping(params, seed_z(seed, G.cfg.z_dim, DEVICE),
                         _camera(torch, 0.0), truncation_psi=0.7,
                         truncation_cutoff=14)


def phase_sample_mixed_chunk(torch, gs, G, params, ws):
    """a. ``sample_mixed`` on the middle chunk of the 256³ mesh grid (a
    regular grid, z fastest: hundreds of consecutive points share a cell
    on the planes) through the gather kernel, one launch, against the
    plain sampler on the same planes."""
    import numpy as np
    import tgi_torch.render.renderer as renderer
    R = MESH_RES
    lin = torch.from_numpy(np.linspace(-0.5, 0.5, R, dtype=np.float32)).to(
        DEVICE)
    c = (R ** 3 // MESH_CHUNK) // 2
    idx = torch.arange(c * MESH_CHUNK, (c + 1) * MESH_CHUNK, device=DEVICE)
    pts = torch.stack([lin[idx // (R * R)], lin[(idx // R) % R],
                       lin[idx % R]], dim=-1)[None]
    with torch.no_grad():
        planes = G.backbone_planes(params, ws)
        zero_counts(gs)
        got = G.sample_mixed(params, pts, ws, planes=planes)
        torch.cuda.synchronize()
        launches = counts(gs)
        renderer.sample_triplanes = gs.sample_triplanes_plain
        try:
            want = G.sample_mixed(params, pts, ws, planes=planes)
        finally:
            renderer.sample_triplanes = gs.sample_triplanes
    err = max((got[k] - want[k]).abs().max().item() for k in ("sigma", "rgb"))
    sigma = got["sigma"]
    log(f"sample_mixed, grid chunk {c} of {R}³ ({MESH_CHUNK} points): "
        f"kernel vs plain max abs err {err:.3g}, launches {launches}; sigma "
        f"in [{sigma.min().item():.4g}, {sigma.max().item():.4g}]")
    check(launches["triplane_gather"] == 1
          and launches["triplane_splat"] == 0,
          f"sample_mixed launched {launches}, expected one gather")
    check(err <= SWAP_TOL, f"sample_mixed kernel vs plain: {err} > "
          f"{SWAP_TOL}")
    return {"launches": launches["triplane_gather"], "max_abs_err": err}


def _read_ply(path):
    import numpy as np
    with open(path) as f:
        head = []
        while not head or head[-1] != "end_header":
            head.append(f.readline().strip())
        nv = int(next(h for h in head if h.startswith("element vertex"))
                 .split()[-1])
        nf = int(next(h for h in head if h.startswith("element face"))
                 .split()[-1])
        verts = np.loadtxt(f, dtype=np.float32, max_rows=nv, ndmin=2)
        faces = np.loadtxt(f, dtype=np.int64, max_rows=nf, ndmin=2)
    return verts, faces[:, 1:]


def phase_mesh(torch, gs, G, params, ws, tmp):
    """b. ``extract_mesh`` at 256³: the native marching library built by
    g++ from the checkout's source, the sigma grid in 16 chunks (one
    gather each), a non-empty mesh, and the .ply written and read back.
    ``tgi``'s level of 10 is a trained generator's: a random one's sigma
    stays far below it (the seed-0 generator's within [-0.89, 0.56]), so
    the mesh is taken at the grid's MESH_QUANTILE."""
    import numpy as np
    from tgi_torch.apps import shape
    from tgi_torch.utils import marching, native_build
    check(native_build.available(), "no g++: the marching library cannot "
          "be built")
    src = os.path.join(REPO, "tgi_torch", "native", "marching_tet.cpp")
    t0 = time.perf_counter()
    native_build.get_plugin("tgi_marching", [src])
    build_s = time.perf_counter() - t0
    # One set of planes for both grids: the backbone's cuDNN convolutions
    # need not repeat their bits from call to call.
    with torch.no_grad():
        planes = G.backbone_planes(params, ws)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = shape.sigma_grid(G, params, ws, resolution=MESH_RES,
                            chunk=MESH_CHUNK, planes=planes)
    grid_s = time.perf_counter() - t0
    level = float(np.quantile(grid, MESH_QUANTILE))
    t0 = time.perf_counter()
    want_v, want_f = marching.marching_tetrahedra(grid, level=level,
                                                  spacing=1.0 / MESH_RES)
    march_s = time.perf_counter() - t0
    ply = os.path.join(tmp, "mesh.ply")
    zero_counts(gs)
    t0 = time.perf_counter()
    verts, faces = shape.extract_mesh(G, params, ws, resolution=MESH_RES,
                                      level=level, out_ply=ply,
                                      chunk=MESH_CHUNK, planes=planes)
    mesh_s = time.perf_counter() - t0
    launches = counts(gs)
    back_v, back_f = _read_ply(ply)
    log(f"extract_mesh at {MESH_RES}³: marching library built in "
        f"{build_s:.1f} s; sigma grid {grid_s:.2f} s (sigma in "
        f"[{grid.min():.4g}, {grid.max():.4g}], {(grid > 10).mean():.2%} "
        f"above tgi's level 10; level {level:.4g} at the {MESH_QUANTILE} "
        f"quantile); marching {march_s:.2f} s: {len(verts)} verts, "
        f"{len(faces)} faces; extract_mesh with the .ply "
        f"({os.path.getsize(ply) / 2 ** 20:.1f} MiB) {mesh_s:.1f} s, "
        f"launches {launches}")
    check(launches["triplane_gather"] == -(-MESH_RES ** 3 // MESH_CHUNK)
          and launches["triplane_splat"] == 0,
          f"extract_mesh launches {launches}, expected one gather a chunk")
    check(bool(np.isfinite(grid).all()), "non-finite sigma")
    check(len(verts) > 0 and len(faces) > 0, f"empty mesh at {level}")
    check(np.array_equal(verts, want_v) and np.array_equal(faces, want_f),
          "extract_mesh's mesh is not the grid's")
    check(np.array_equal(back_f, faces) and back_v.shape == verts.shape
          and np.abs(back_v - verts).max() <= 1e-6,
          "the .ply does not read back as the mesh")
    return {"launches": launches["triplane_gather"], "sigma_grid_s": grid_s,
            "marching_s": march_s, "build_s": build_s,
            "extract_mesh_s": mesh_s, "verts": len(verts),
            "faces": len(faces)}


def phase_orbit(torch, gs, G, params, ws):
    """c. ``render_orbit``: 8 frames, 4 at a time, 96 + 96 samples; two
    gathers per batched render, frames that turn; ms per frame and the
    peak memory."""
    from tgi_torch.apps.gen_videos import render_orbit
    render_orbit(G, params, ws, num_frames=ORBIT_BATCH, batch=ORBIT_BATCH,
                 sample_mult=ORBIT_SAMPLE_MULT)      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(gs)
    t0 = time.perf_counter()
    frames = render_orbit(G, params, ws, num_frames=ORBIT_FRAMES,
                          batch=ORBIT_BATCH, sample_mult=ORBIT_SAMPLE_MULT)
    wall = time.perf_counter() - t0
    launches = counts(gs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    d = abs(frames[0].astype(int) - frames[4]).mean()
    ms = wall * 1e3 / ORBIT_FRAMES
    log(f"render_orbit: {ORBIT_FRAMES} frames, batch {ORBIT_BATCH}, "
        f"sample_mult {ORBIT_SAMPLE_MULT}: {ms:.1f} ms a frame (host clock, "
        f"PNG-free: frames to uint8 on the host included), peak memory "
        f"{peak:.2f} GiB, launches {launches}, frames 0 / 4 differ by "
        f"{d:.2f} (mean abs, uint8)")
    check(frames.shape == (ORBIT_FRAMES, 512, 512, 3)
          and str(frames.dtype) == "uint8", f"frames {frames.shape} "
          f"{frames.dtype}")
    check(launches["triplane_gather"] == 2 * ORBIT_FRAMES // ORBIT_BATCH
          and launches["triplane_splat"] == 0,
          f"render_orbit launches {launches}, expected 2 per batch")
    check(d > 0.1, f"frames 0 and 4 do not differ ({d})")
    err = _orbit_batch_swap_err(torch, gs, G, params, ws)
    log(f"render_orbit's batch 0 ({ORBIT_BATCH} frames, sample_mult "
        f"{ORBIT_SAMPLE_MULT}), plain sampler vs kernel: max abs err {err}")
    check(max(err.values()) <= SWAP_TOL,
          f"orbit batch, plain sampler vs kernel: {err} > {SWAP_TOL}")
    return {"launches": launches["triplane_gather"], "ms_per_frame": ms,
            "peak_gib": peak, "max_abs_err": max(err.values())}


def _orbit_batch_swap_err(torch, gs, G, params, ws):
    """render_orbit's first batch (N = ORBIT_BATCH, 96 + 96 samples a ray)
    rendered through the kernel and through the plain sampler; max abs
    difference of image, image_raw and image_depth. Its launches are
    outside the counted run."""
    import tgi_torch.render.renderer as renderer
    from tgi_torch.apps.gen_videos import orbit_cameras
    rk = G.cfg.rendering_kwargs
    Gv = type(G)(G.cfg.with_rendering(
        depth_resolution=int(rk["depth_resolution"] * ORBIT_SAMPLE_MULT),
        depth_resolution_importance=int(
            rk["depth_resolution_importance"] * ORBIT_SAMPLE_MULT)))
    cams = orbit_cameras(ORBIT_FRAMES, (0, 0, 0.2), device=DEVICE)
    wsb = ws.expand(ORBIT_BATCH, *ws.shape[1:]).contiguous()
    keys = ("image", "image_raw", "image_depth")
    with torch.no_grad():
        got = Gv.synthesis(params, wsb, cams[:ORBIT_BATCH], det=True)
        got = {k: got[k].float() for k in keys}
        before = gs.LAUNCHES
        renderer.sample_triplanes = gs.sample_triplanes_plain
        try:
            want = Gv.synthesis(params, wsb, cams[:ORBIT_BATCH], det=True)
        finally:
            renderer.sample_triplanes = gs.sample_triplanes
        torch.cuda.synchronize()
    check(gs.LAUNCHES == before, "the plain orbit render launched the kernel")
    return {k: (got[k] - want[k].float()).abs().max().item() for k in keys}


def _locality_step_ms(torch, gs, G, params, st, with_locality, steps=4,
                      warmup=1):
    """One tuning step (loss forward, backward, Adam) with or without the
    locality term, CUDA-event median; the launches of one step."""
    from tgi_torch.invert.coach import PTICoach
    from tgi_torch.losses.locality import SpaceRegularizer
    coach = st["coach"]
    reg = (SpaceRegularizer(G, params, coach.lpips) if with_locality
           else None)
    c = PTICoach(G, coach.lpips, coach.cfg, locality_regularizer=reg)
    p = {k: _map_detach(v) for k, v in params.items()}
    opt = torch.optim.Adam(list(_leaves(p)), lr=c.cfg.pti_learning_rate)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    times, per_step = [], None
    for i in range(warmup + steps):
        zero_counts(gs)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loss, aux = c._loss(p, st["ws"], st["cam"], st["target"],
                            generator=gen)
        float(aux["lpips"].detach())
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        b.record()
        b.synchronize()
        if i >= warmup:
            times.append(a.elapsed_time(b))
        per_step = counts(gs)
    return statistics.median(times), per_step


def phase_run_pti_outputs(torch, gs, G, params, st, tmp):
    """d. ``run_pti`` at tgi's defaults (orbit videos on, where imageio is
    installed) with ``gen_mesh``, ``use_locality_reg`` and
    ``visualize_opt``: 20 + 10 steps on a 512² target rendered from seed
    2's latent, the aux nets drawn at full width from the seed; the files
    it writes and its launches; one tuning step timed with and without
    the locality term."""
    import importlib.util
    import numpy as np
    from tgi_torch.apps import run_pti as app
    video = importlib.util.find_spec("imageio") is not None
    check(importlib.util.find_spec("PIL") is not None,
          "no Pillow: run_pti's snapshots and PNGs need it")
    img, _ = stage1_target(torch, G, params)
    imgs, out = os.path.join(tmp, "out_images"), os.path.join(tmp, "outputs")
    os.makedirs(imgs)
    np.save(os.path.join(imgs, "face.npy"), img[0].cpu().numpy())
    log("run_pti outputs: imageio " + (
        "installed: orbit videos on (the default)" if video else
        "absent: gen_video=False (write_video would raise ImportError), "
        "render_orbit driven in c alone"))
    zero_counts(gs)
    t0 = time.perf_counter()
    res = app.run_pti(imgs, out, G=G, gen_params=params, gen_video=video,
                      gen_mesh=True, use_locality_reg=True,
                      visualize_opt=True, first_inv_steps=OUTPUTS_STAGE1,
                      max_pti_steps=OUTPUTS_PTI, seed=4, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts(gs)
    entry = res[0]
    files = sorted(os.listdir(out))
    snaps = sorted(os.listdir(f"{out}_pivot/face"))
    log(f"run_pti --mesh --use-locality-reg --visualize-opt"
        f"{'' if video else ' --no-video'}: {wall:.1f} s, entry {entry}, "
        f"launches {launched}, files {files}, snapshots {snaps}")
    want_files = {"face_ws.npy", "face_cam.npy", "face_G.pt", "face.ply",
                  "results.json", "face.png", "face_pivot.png"}
    check(want_files <= set(files), f"run_pti wrote {files}, expected "
          f"{sorted(want_files)}")
    if video:
        for stem in ("face_pivot", "face"):
            check(any(f in files for f in (f"{stem}.mp4", f"{stem}.gif")),
                  f"no {stem} video in {files}")
    check(snaps == sorted(["10.png", "20.png", "warp_10.png",
                           "warp_20.png"]), f"snapshots {snaps}")
    s1, s2 = OUTPUTS_STAGE1, entry["pti_steps"]
    renders = s2 + (s2 < OUTPUTS_PTI)     # with the one that stopped it
    mesh = -(-MESH_RES ** 3 // MESH_CHUNK)
    # Stage 1 two renders a step, two snapshots of two renders, tuning
    # three renders a step, the two PNG renders, two 60-frame videos in
    # batches of 4, the mesh's chunks: two gathers a render.
    want = {"triplane_gather": (4 * s1 + 2 * 4 + 6 * renders + 2 * 2
                                + video * 2 * 2 * (60 // 4) + mesh),
            "triplane_splat": 4 * s1 + 4 * s2,
            "triplane_splat_sorted": 0, "triplane_splat_keys": 0,
            "triplane_splat_offsets": 0}
    check(launched == want, f"run_pti outputs launches {launched}, "
          f"expected {want}")
    with_ms, with_launches = _locality_step_ms(torch, gs, G, params, st,
                                               True)
    without_ms, without_launches = _locality_step_ms(torch, gs, G, params,
                                                     st, False)
    log(f"tuning step, one call: with the locality term {with_ms:.2f} ms "
        f"({with_launches}), without {without_ms:.2f} ms "
        f"({without_launches}) (CUDA events, median of 4)")
    check(with_launches["triplane_gather"] == 6
          and with_launches["triplane_splat"] == 4,
          f"a locality tuning step launched {with_launches}, expected 6 "
          f"gathers and 4 splats")
    check(without_launches["triplane_gather"] == 2
          and without_launches["triplane_splat"] == 2,
          f"a tuning step launched {without_launches}, expected 2 and 2")
    return {"launches": launched, "wall_s": wall, "video": video,
            "entry": entry, "step_ms_locality": with_ms,
            "step_ms": without_ms}


def phase_ganspace(torch, gs, G, params, ws, tmp):
    """e. ``compute_pca`` at 100,000 samples, the basis saved and read by
    ``load_components``, and ``edit_and_render`` with the "smile"
    direction."""
    import numpy as np
    from tgi_torch.apps import ganspace
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comps, stdev, mean = ganspace.compute_pca(
        G, params, num_samples=PCA_SAMPLES, batch=PCA_BATCH,
        generator=torch.Generator(device=DEVICE).manual_seed(6))
    pca_s = time.perf_counter() - t0
    path = os.path.join(tmp, "pcs.npy")
    np.save(path, comps)
    basis = ganspace.load_components(path, w_dim=G.cfg.w_dim)
    zero_counts(gs)
    orig, edit = ganspace.edit_and_render(G, params, ws, _camera(torch, 0.0),
                                          basis, direction="smile")
    torch.cuda.synchronize()
    launches = counts(gs)
    d = (edit - orig).abs().mean().item()
    log(f"ganspace: PCA of {-(-PCA_SAMPLES // PCA_BATCH) * PCA_BATCH} w in "
        f"{pca_s:.2f} s (stdev {stdev[0]:.4g} .. {stdev[-1]:.4g}); smile "
        f"edit differs by {d:.4g} (mean abs); launches {launches}")
    check(bool(np.isfinite(comps).all() and np.isfinite(stdev).all()),
          "non-finite PCA")
    check(bool(torch.isfinite(edit).all()) and d > 1e-4,
          f"the smile edit is not finite or does not differ ({d})")
    check(launches["triplane_gather"] == 4, f"edit_and_render launched "
          f"{launches}, expected 2 renders")
    return {"launches": launches["triplane_gather"], "pca_s": pca_s}


def phase_outputs(torch, gs, G, params, st, tmp):
    """Phase 13, a-e, on the seed-0 generator."""
    t0 = time.perf_counter()
    ws = _outputs_ws(torch, G, params)
    out = {"sample_mixed": phase_sample_mixed_chunk(torch, gs, G, params,
                                                    ws),
           "mesh": phase_mesh(torch, gs, G, params, ws, tmp),
           "orbit": phase_orbit(torch, gs, G, params, ws),
           "run_pti": phase_run_pti_outputs(torch, gs, G, params, st, tmp),
           "ganspace": phase_ganspace(torch, gs, G, params, ws, tmp)}
    log(f"phase 13 (outputs) in {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 14: GAN training at full width (train_gan, training_loop,
# GANTrainer.train_step) through the gather and splat kernels.

TRAIN_IMAGES = 16          # dataset images (32 with their mirrors)
TRAIN_STEPS = 8            # steps of the first run; the resume takes one
TRAIN_BATCH = 4            # one of EG3D's 8 GPUs in its published run
# Launches per training step (gather, splat): the G phase's render forward
# and backward, the D phase's render of the fakes without autograd, and
# the density regulariser's one sample_mixed forward and backward.
STEP_LAUNCHES = {"plain": (4, 2), "greg": (5, 3)}
# Tiny train_step, card vs CPU (fp32, TF32 off): metrics within this
# relative error.
TRAIN_CPU_TOL = 1e-4


def phase_train_dataset(torch, tmp):
    """a. The dataset: TRAIN_IMAGES renders of the seed-2 full-width
    generator at a 4 x 4 grid of yaw and pitch, written as ``.npy``
    images (readable without Pillow) with their 25-float labels in
    dataset.json, then read back through ``ImageFolderDataset`` with
    xflip."""
    import numpy as np
    from tgi_torch.render.cameras import (fov_to_intrinsics, look_at_pose,
                                          pack_camera)
    from tgi_torch.scripts import selfinv_gate
    from tgi_torch.train.dataset import ImageFolderDataset
    t0 = time.perf_counter()
    G, params = selfinv_gate.full_width_generator(DEVICE, seed=2)
    yaw, pitch = torch.meshgrid(torch.linspace(-0.4, 0.4, 4),
                                torch.linspace(-0.2, 0.2, 4), indexing="ij")
    cam = look_at_pose(math.pi / 2 + yaw.flatten(),
                       math.pi / 2 + pitch.flatten(),
                       torch.tensor([0, 0, 0.2], device=DEVICE), radius=2.7,
                       device=DEVICE)
    c = pack_camera(cam, fov_to_intrinsics(18.837, device=DEVICE))
    z = torch.randn(TRAIN_IMAGES, G.cfg.z_dim,
                    generator=torch.Generator().manual_seed(5)).to(DEVICE)
    data = os.path.join(tmp, "train_data")
    os.makedirs(data)
    labels, images = [], []
    with torch.no_grad():
        for i in range(0, TRAIN_IMAGES, 4):
            img = G(params, z[i:i + 4], c[i:i + 4], truncation_psi=0.7,
                    det=True)["image"].clamp(-1, 1)
            images += list(img.cpu().numpy())
    for i, (img, label) in enumerate(zip(images, c.cpu().numpy())):
        np.save(os.path.join(data, f"img{i:02d}.npy"), img)
        labels.append([f"img{i:02d}.npy", label.tolist()])
    with open(os.path.join(data, "dataset.json"), "w") as f:
        json.dump({"labels": labels}, f)
    del G, params
    ds = ImageFolderDataset(data, resolution=images[0].shape[-1], xflip=True)
    img0, label0 = ds[0]
    flip0, flip_label0 = ds[TRAIN_IMAGES]
    check(len(ds) == 2 * TRAIN_IMAGES and np.array_equal(img0, images[0])
          and np.array_equal(flip0, images[0][:, :, ::-1])
          and np.array_equal(label0, c[0].cpu().numpy())
          and not np.array_equal(flip_label0, label0),
          "the dataset does not read back its images, mirrors and labels")
    log(f"train dataset: {TRAIN_IMAGES} renders at {images[0].shape[-1]}² "
        f"(seed-2 generator, "
        f"yaw and pitch grid) as .npy with labels, {len(ds)} with mirrors, "
        f"in {time.perf_counter() - t0:.1f} s")
    return data


class step_recorder:
    """Inside the block, every ``GANTrainer.train_step`` is timed with
    CUDA events and its launches, collectives, phase flags and metrics
    recorded."""

    def __init__(self, torch, gs):
        self.torch, self.gs, self.records = torch, gs, []

    def __enter__(self):
        from tgi_torch.parallel import collectives
        from tgi_torch.train.gan import GANTrainer
        self.cls, self.real = GANTrainer, GANTrainer.train_step
        torch, gs, records, real = self.torch, self.gs, self.records, \
            self.real

        def timed(trainer, state, z, c, real_img, rng, cur_nimg, do_greg,
                  do_dreg, ada_p=0.0):
            before = counts(gs)
            calls = collectives.CALLS
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = real(trainer, state, z, c, real_img, rng, cur_nimg,
                       do_greg, do_dreg, ada_p)
            ev[1].record()
            ev[1].synchronize()
            after = counts(gs)
            records.append(dict(
                cur_nimg=cur_nimg, greg=do_greg, r1=do_dreg, ada_p=ada_p,
                ms=ev[0].elapsed_time(ev[1]),
                gathers=after["triplane_gather"] - before["triplane_gather"],
                splats=after["triplane_splat"] - before["triplane_splat"],
                collectives=collectives.CALLS - calls,
                metrics={k: float(v) for k, v in out[1].items()}))
            return out

        GANTrainer.train_step = timed
        return self.records

    def __exit__(self, *exc):
        self.cls.train_step = self.real


def phase_train_gan(torch, gs, data, tmp):
    """b. ``train_gan`` at tgi's default configuration (EG3D FFHQ 512,
    bf16 generator, dual discriminator, batch 4, ADA from p = 0.2) for
    TRAIN_STEPS steps with a tick, a checkpoint and (where Pillow
    imports) an image grid every 4 steps, then a resume from the last
    checkpoint for one step. Every count is set to 0 just before and read
    just after (the slice's main path)."""
    import numpy as np
    from tgi_torch.apps.train_gan import train_gan, training_configs
    from tgi_torch.train.augment import AugmentPipe
    from tgi_torch.train.gan import (GANTrainer, _leaves, init_train_state)
    try:
        import PIL  # noqa: F401
        grids = 1
    except ImportError:
        grids = 0
    run, run2 = os.path.join(tmp, "train_run"), os.path.join(tmp, "resume")
    tick_kimg = 4 * TRAIN_BATCH / 1000
    common = dict(batch_size=TRAIN_BATCH, kimg_per_tick=tick_kimg,
                  snapshot_ticks=1, augment_p=0.2, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    zero_counts(gs)
    with step_recorder(torch, gs) as records:
        state = train_gan(data, run, total_kimg=TRAIN_STEPS * TRAIN_BATCH
                          / 1000, image_snapshot_ticks=grids, **common)
        ckpt = os.path.join(run, "network-000000.ckpt")
        resumed = train_gan(data, run2, resume_ckpt=ckpt,
                            total_kimg=(TRAIN_STEPS + 1) * TRAIN_BATCH / 1000,
                            image_snapshot_ticks=0, **common)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(gs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    files = sorted(os.listdir(run))
    log(f"train_gan: {len(records)} steps ({TRAIN_STEPS} + 1 resumed) in "
        f"{wall:.1f} s, launches {launches}, peak memory {peak:.2f} GiB; "
        f"files {files}; image grid "
        f"{'written (Pillow imports)' if grids else 'off: no Pillow'}")
    for i, r in enumerate(records):
        log(f"  step {i}: cur_nimg {r['cur_nimg']} greg {r['greg']} R1 "
            f"{r['r1']} ada_p {r['ada_p']:.6g}: {r['ms']:.1f} ms, "
            f"{r['gathers']} gathers, {r['splats']} splats, {r['metrics']}")
    check(len(records) == TRAIN_STEPS + 1,
          f"{len(records)} training steps, expected {TRAIN_STEPS + 1}")
    check([r["greg"] for r in records] == [i % 4 == 0 for i in range(9)]
          and [r["r1"] for r in records] == [i == 0 for i in range(9)],
          "greg on steps 0, 4 and 8 and R1 on step 0 expected")
    check(records[8]["cur_nimg"] == TRAIN_STEPS * TRAIN_BATCH,
          "the resumed step did not start from the checkpoint's cur_nimg")
    check(all(r["ada_p"] > 0.19 for r in records),
          "the augment pipe's p left 0.2 in 9 steps")
    for i, r in enumerate(records):
        m = r["metrics"]
        check(all(math.isfinite(v) for v in m.values()),
              f"step {i}: a loss is not finite: {m}")
        check(-1 <= m["signs_real"] <= 1, f"step {i}: signs_real {m}")
        want = STEP_LAUNCHES["greg" if r["greg"] else "plain"]
        check((r["gathers"], r["splats"]) == want,
              f"step {i}: {r['gathers']} gathers and {r['splats']} splats, "
              f"expected {want}")
    check(launches["triplane_splat_sorted"] == 0
          and launches["triplane_gather"] >= sum(r["gathers"]
                                                 for r in records),
          f"launches {launches}")
    with open(os.path.join(run, "stats.jsonl")) as f:
        ticks = [json.loads(line) for line in f if '"g_loss"' in line]
    check([t["kimg"] for t in ticks] == [tick_kimg, 2 * tick_kimg],
          f"tick records {ticks}")
    check("network-000000.ckpt" in files
          and ("fakes-000000.png" in files) == bool(grids),
          f"run files {files}")
    G, d_cfg, cfg = training_configs(batch_size=TRAIN_BATCH)
    trainer = GANTrainer(G, d_cfg, cfg, augment_fn=AugmentPipe())
    init = init_train_state(torch.Generator().manual_seed(0), G, d_cfg,
                            trainer, device=DEVICE)
    moved = {}
    for name in ("g_params", "d_params"):
        moved[name] = max((a.detach() - b.detach()).abs().max().item()
                          for (_, a), (_, b) in zip(_leaves(state[name]),
                                                    _leaves(init[name])))
    ema_lag = max((a - b.detach()).abs().max().item()
                  for (_, a), (_, b) in zip(_leaves(state["g_ema"]),
                                            _leaves(state["g_params"])))
    ema_moved = max((a - b.detach()).abs().max().item()
                    for (_, a), (_, b) in zip(_leaves(state["g_ema"]),
                                              _leaves(init["g_params"])))
    log(f"weights moved (max |Δ| over leaves): G {moved['g_params']:.4g}, D "
        f"{moved['d_params']:.4g}; g_ema moved {ema_moved:.4g} and lags G by "
        f"{ema_lag:.4g}")
    check(moved["g_params"] > 0 and moved["d_params"] > 0,
          f"weights did not move: {moved}")
    check(0 < ema_lag and 0 < ema_moved, "g_ema does not lag G")
    del init
    plain = [r["ms"] for r in records[1:] if not r["greg"]]
    greg = [r["ms"] for r in records[1:] if r["greg"]]
    times = {"plain_step_ms": statistics.median(plain),
             "greg_step_ms": statistics.median(greg),
             "r1_greg_step_ms_first": records[0]["ms"],
             "plain_steps_ms": plain, "greg_steps_ms": greg,
             "peak_gib": peak, "sec_per_kimg": ticks[-1]["sec_per_kimg"],
             "wall_s": wall}
    return dict(state=resumed, launches=launches, times=times,
                records=records, grids=bool(grids))


def phase_train_step_times(torch, gs, state, steps=3):
    """b. Warm step times at the same configuration on the resumed state
    (CUDA events, median of ``steps``): plain, with the density
    regulariser, and with both it and R1 (every R1 step of the schedule,
    1 in 16, is also one of the regulariser's, 1 in 4); and, forward
    only, the blur at its first sigma and one augment-pipe call."""
    from tgi_torch.apps.train_gan import training_configs
    from tgi_torch.nn.discriminator import filtered_resizing
    from tgi_torch.train.augment import AugmentPipe
    from tgi_torch.train.gan import GANTrainer, _blur
    from tgi_torch.utils.draws import TorchDraws
    G, d_cfg, cfg = training_configs(batch_size=TRAIN_BATCH)
    trainer = GANTrainer(G, d_cfg, cfg, augment_fn=AugmentPipe())
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    batch = _train_batch(torch, gen, G)
    out = {}
    with step_recorder(torch, gs) as records:
        for name, greg, r1 in (("plain", False, False), ("greg", True, False),
                               ("greg_r1", True, True)):
            records.clear()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(steps):
                trainer.train_step(state, *batch, gen, cur_nimg=40,
                                   do_greg=greg, do_dreg=r1, ada_p=0.2)
            out[name] = statistics.median(r["ms"] for r in records)
            out[name + "_peak_gib"] = (torch.cuda.max_memory_allocated()
                                       / 2 ** 30)
    img = batch[2]
    raw = filtered_resizing(img, cfg.neural_rendering_resolution_initial)
    sigma = cfg.blur_init_sigma
    with torch.no_grad():
        out["blur_ms"] = cuda_ms(torch, lambda: (
            _blur(img, sigma, int(sigma * 3)),
            _blur(raw, sigma, int(sigma * 3))), iters=10)
        out["augment_pipe_ms"] = cuda_ms(torch, lambda: trainer.augment_fn(
            img, raw, TorchDraws(gen), 0.2), iters=10)
    log(f"train step, warm (median of {steps}, CUDA events): {out}; the "
        f"blur at sigma {sigma} ({2 * int(sigma * 3) + 1} taps) of a 512² "
        f"batch and its 64² raw images, and one augment-pipe call on them, "
        f"forward only (median of 10)")
    return out


def _train_batch(torch, gen, G, N=TRAIN_BATCH):
    """(z, c, real images) on the card: latents and images from ``gen``,
    cameras at the FFHQ pivot turned by N yaws."""
    z = torch.randn(N, G.cfg.z_dim, generator=gen, device=DEVICE)
    c = torch.cat([_camera(torch, 0.2 * i - 0.3) for i in range(N)])
    real = torch.rand(N, 3, G.cfg.img_resolution, G.cfg.img_resolution,
                      generator=gen, device=DEVICE) * 2 - 1
    return z, c, real


def phase_train_grads_vs_plain(torch, gs, state):
    """c. One G phase plus the density regulariser at full width (the
    trained state, the same draws each time) through the kernels, again,
    and through the plain sampler, with deterministic cuDNN algorithms:
    per group (mapping, backbone, decoder, SR) ||Δ||_2 <= BF16_GRAD_TOL
    ||plain||_2."""
    import tgi_torch.render.renderer as renderer
    from tgi_torch.apps.train_gan import training_configs
    from tgi_torch.train.augment import AugmentPipe
    from tgi_torch.train.gan import GANTrainer, _grads, _leaves, _map
    from tgi_torch.utils.draws import TorchDraws
    G, d_cfg, cfg = training_configs(batch_size=TRAIN_BATCH)
    trainer = GANTrainer(G, d_cfg, cfg, augment_fn=AugmentPipe())
    g, d = state["g_params"], _map(torch.Tensor.detach, state["d_params"])
    batch = _train_batch(torch, torch.Generator(device=DEVICE).manual_seed(4),
                         G)
    blur_sigma, sp, res, _ = trainer._schedules(36)
    names = [".".join(p) for p, _ in _leaves(g)]

    def grads(sampler=None):
        draws = TorchDraws(torch.Generator(device=DEVICE).manual_seed(6))
        k_g, k_greg = draws.split(2)
        renderer.sample_triplanes = sampler or gs.sample_triplanes
        try:
            loss = trainer.gmain_loss(g, d, *batch[:2], k_g, blur_sigma,
                                      int(blur_sigma * 3), sp, res, 0.2)
            reg = trainer.greg_loss(g, *batch[:2], k_greg, sp)
            total = [a + cfg.g_reg_interval * b for a, b in
                     zip(_grads(loss, g), _grads(reg, g))]
            torch.cuda.synchronize()
            return dict(zip(names, total)), loss.item(), reg.item()
        finally:
            renderer.sample_triplanes = gs.sample_triplanes

    torch.backends.cudnn.deterministic = True
    try:
        zero_counts(gs)
        kernel, loss_k, reg_k = grads()
        per = counts(gs)
        again, _, _ = grads()
        before = counts(gs)
        plain, loss_p, reg_p = grads(gs.sample_triplanes_plain)
        check(counts(gs) == before, "the plain sampler launched a kernel")
    finally:
        torch.backends.cudnn.deterministic = False
    check(per["triplane_gather"] == 3 and per["triplane_splat"] == 3,
          f"a G phase plus greg launched {per}, expected 3 gathers and 3 "
          f"splats")
    errs = {}
    for group in ("mapping", "backbone", "decoder", "superresolution"):
        err, scale = _group_err(torch, kernel, plain, group)
        err2, _ = _group_err(torch, again, kernel, group)
        log(f"G phase + greg gradient of {group}: norm {scale:.4g}; kernels "
            f"vs plain sampler: norm err {err:.3g}; kernels twice: "
            f"{err2:.3g}")
        check(math.isfinite(scale) and scale > 0,
              f"the G phase gives {group} no gradient")
        check(err <= BF16_GRAD_TOL, f"{group}: kernels vs plain {err} > "
              f"{BF16_GRAD_TOL}")
        errs[group] = err
    log(f"G phase + greg losses, kernels / plain: gmain {loss_k:.6g} / "
        f"{loss_p:.6g}, greg {reg_k:.6g} / {reg_p:.6g}")
    return errs


def phase_density_points_vs_plain(torch, gs, state):
    """c. The density regulariser's own points: 4 x 1000 uniform in
    [-1, 1]³ and their N(0, 0.004) twins (4 x 2,000), on the trained
    generator's planes, through the gather and the splat (with and
    without ``d_coords``) against their plain versions at phase 3's
    tolerances. With box_warp 1 the box is [-0.5, 0.5]³, so most points
    lie outside it: the kernels must give zero there as plain does."""
    from tgi_torch.apps.train_gan import training_configs
    G, _, cfg = training_configs(batch_size=TRAIN_BATCH)
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    n = cfg.density_reg_samples
    rk = G.cfg.rendering_kwargs
    z = torch.randn(TRAIN_BATCH, G.cfg.z_dim, generator=gen, device=DEVICE)
    c = torch.cat([_camera(torch, 0.1 * i) for i in range(TRAIN_BATCH)])
    pts = torch.rand(TRAIN_BATCH, n, 3, generator=gen, device=DEVICE) * 2 - 1
    pts = torch.cat([pts, pts + torch.randn(pts.shape, generator=gen,
                                            device=DEVICE)
                     * rk["density_reg_p_dist"]], dim=1).contiguous()
    with torch.no_grad():
        planes = G.backbone_planes(state["g_params"],
                                   G.mapping(state["g_params"], z, c))
    planes_hwc = planes.float().permute(0, 1, 3, 4, 2).contiguous()
    planes_cl = planes_hwc.permute(0, 1, 4, 2, 3)     # [N, 3, C, H, W] view
    box = rk["box_warp"]
    outside = (pts.abs() > box / 2).any(dim=-1)
    twins_out = outside[:, n:] & ~outside[:, :n]
    got = gs.sample_triplanes_cuda(planes_cl, pts, box)
    want = gs.sample_triplanes_plain(planes_cl, pts, box)
    g = torch.randn(got.shape, generator=gen, device=DEVICE)
    errs = {"gather": (got - want).abs().max().item()}
    check(errs["gather"] <= KERNEL_TOL,
          f"density points: gather vs plain {errs['gather']}")
    # A plane's four corners all lie off it once a projected coordinate
    # is a cell past the border: zero features there.
    far = pts.abs() > (box / 2) * (1 + 2 / planes.shape[-1])
    off = far[..., [0, 0, 2]] | far[..., [1, 2, 0]]    # [N, M, plane]
    check(bool((got.permute(0, 2, 1, 3)[off] == 0).all()),
          "the gather gave non-zero features off a plane")
    for need in (False, True):
        a = gs.triplane_splat_cuda(planes_hwc, pts, g, box, need)
        b = gs.triplane_splat_plain(planes_hwc, pts, g, box, need)
        for what, x, y in zip(("d_planes", "d_coords"), a, b):
            if y is None:
                continue
            scale = max(1.0, y.abs().max().item())
            err = (x - y).abs().max().item()
            errs[f"{what}{'_with_coords' if need else ''}"] = err / scale
            check(err <= SPLAT_TOL * scale, f"density points: splat {what} "
                  f"(d_coords asked: {need}) {err} > {SPLAT_TOL} * {scale}")
    torch.cuda.synchronize()
    log(f"density-regulariser points ({TRAIN_BATCH} x {2 * n}): "
        f"{int(outside.sum())} of {outside.numel()} outside the box "
        f"({int(off.all(dim=-1).sum())} off all three planes) "
        f"[-{box / 2}, {box / 2}]³, {int(twins_out.sum())} pushed out by "
        f"the perturbation; kernels vs plain: {errs}")
    return {"outside": int(outside.sum()), "pushed_out": int(twins_out.sum()),
            "points": outside.numel(), **errs}


def phase_train_tiny_vs_cpu(torch):
    """d. One tiny-configuration ``train_step`` (greg and R1, the augment
    pipe at p = 0.3, style mixing, the blur) on the card against the same
    step on the CPU, the draws from one CPU generator placed on each
    device; fp32, TF32 off: metrics within TRAIN_CPU_TOL relative,
    updated weights within two Adam steps, and (Adam's first step moves
    a weight by about lr whatever its gradient) the share of weights
    whose update agrees within 1e-2 lr logged and held above 99 %."""
    from tgi_torch.nn.discriminator import DiscriminatorConfig
    from tgi_torch.train.augment import AugmentPipe
    from tgi_torch.train.gan import (GANTrainConfig, GANTrainer, _leaves,
                                     init_train_state)
    from tgi_torch.utils.draws import TorchDraws
    G, _ = _small_generator(torch)
    d_cfg = DiscriminatorConfig(c_dim=25, img_resolution=64, img_channels=6,
                                channel_base=512, channel_max=32,
                                mbstd_group_size=2, mapping_layers=2)
    cfg = GANTrainConfig(batch_size=2, blur_init_sigma=1.0,
                         density_reg_samples=64, style_mixing_prob=0.5,
                         neural_rendering_resolution_initial=16)
    trainer = GANTrainer(G, d_cfg, cfg, augment_fn=AugmentPipe())
    gen = torch.Generator().manual_seed(7)
    z = torch.randn(2, 32, generator=gen)
    real = torch.rand(2, 3, 64, 64, generator=gen) * 2 - 1
    results = {}
    for dev in ("cpu", DEVICE):
        state = init_train_state(torch.Generator().manual_seed(2), G, d_cfg,
                                 trainer, device=dev)
        c = torch.cat([_camera(torch, y, dev) for y in (-0.2, 0.3)])
        state, m = trainer.train_step(
            state, z.to(dev), c, real.to(dev),
            TorchDraws(torch.Generator().manual_seed(8), dev), cur_nimg=0,
            do_greg=True, do_dreg=True, ada_p=0.3)
        results[dev] = (state, {k: float(v) for k, v in m.items()})
    init = init_train_state(torch.Generator().manual_seed(2), G, d_cfg,
                            trainer, device="cpu")
    (cpu, m_cpu), (card, m_card) = results["cpu"], results[DEVICE]
    m_err = max(abs(m_card[k] - m_cpu[k]) / max(1.0, abs(m_cpu[k]))
                for k in m_cpu)
    agree, total, worst = 0, 0, 0.0
    for name, lr in (("g_params", trainer.g_adam[0]),
                     ("d_params", trainer.d_adam[0])):
        for (_, a), (_, b), (_, s) in zip(_leaves(card[name]),
                                          _leaves(cpu[name]),
                                          _leaves(init[name])):
            da = a.detach().cpu() - s.detach()
            db = b.detach() - s.detach()
            err = (da - db).abs()
            agree += int((err <= 1e-2 * lr).sum())
            total += err.numel()
            worst = max(worst, err.max().item() / lr)
    log(f"tiny train_step, card vs CPU: metrics {m_card} vs {m_cpu}, max "
        f"relative err {m_err:.3g}; updates agreeing within 1e-2 lr "
        f"{agree} of {total}, worst |Δ update| {worst:.3g} lr")
    check(m_err <= TRAIN_CPU_TOL, f"tiny step metrics card vs CPU {m_err}")
    check(worst <= 2 and agree >= 0.99 * total,
          f"tiny step updates card vs CPU: {agree} of {total} agree, worst "
          f"{worst} lr")
    return {"metrics_rel_err": m_err, "updates_agree": agree / total}


def phase_training(torch, gs, tmp):
    """Phase 14, a-d."""
    t0 = time.perf_counter()
    data = phase_train_dataset(torch, tmp)
    out = phase_train_gan(torch, gs, data, tmp)
    out["warm"] = phase_train_step_times(torch, gs, out["state"])
    out["grads"] = phase_train_grads_vs_plain(torch, gs, out["state"])
    out["density"] = phase_density_points_vs_plain(torch, gs, out["state"])
    out["tiny"] = phase_train_tiny_vs_cpu(torch)
    del out["state"]
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 14 (training) in {out['seconds']:.1f} s")
    return out


# Phase 15: GAN metrics (calc_metrics, Inception, IS, PPL, SG3 and EQ).
METRIC_ITEMS = 256         # the command line's --num-items
METRIC_BATCH = 8           # compute_generator_features' batch
# Inception, card vs CPU (fp32, TF32 off, BatchNorm calibrated): features
# and logits within INCEPTION_TOL x their largest magnitude. A correct
# float32 run stands 1.5e-5 to 4.1e-5 of that from its float64 one on the
# CPU, and two float32 runs that sum in other orders part by up to 6.1e-5
# (tgi_torch.scripts.inception_error_scale, seeds 0 and 1): each of ~47
# chained convolutions rounds at ~1e-7, and the calibrated BatchNorms of
# near-dead channels amplify it. The faults it must catch read 100 x the
# limit and more: TF32 convolutions 2.8e-2, the resize not antialiased
# 0.20, BatchNorm's eps 1.1e-3 for 1e-3 0.40, the pad counted in the
# average pools 0.46 (the same script, float64).
INCEPTION_TOL = 3e-4
IS_IMAGES = 64
PPL_SAMPLES = 16           # 4 segments of 4
EQ_SAMPLES = 16            # 2 batches of 8 at SG3's default 256²
# Tiny SG3, card vs CPU: images within SG3_CPU_TOL x max(1, max|image|),
# PSNRs with fixed draws within EQ_DB_TOL dB.
SG3_CPU_TOL = 1e-4
EQ_DB_TOL = 1e-2


def _metric_images(torch, G, params, n, seed):
    """``n`` renders [n, 3, 512, 512] of the generator at the metrics'
    camera distribution, z and cameras from ``seed``."""
    from tgi_torch.apps.calc_metrics import default_camera_sampler
    from tgi_torch.metrics.features import generator_draws
    gen = torch.Generator().manual_seed(seed)
    sampler = default_camera_sampler(device=DEVICE)
    out = []
    with torch.no_grad():
        for _ in range(0, n, METRIC_BATCH):
            z, c = generator_draws(G, sampler, gen, METRIC_BATCH, DEVICE)
            out.append(G(params, z, c, det=True)["image"])
    return torch.cat(out)[:n]


def _max_rel(a, b):
    return ((a.cpu() - b).abs().max() / b.abs().max()).item()


def phase_inception_vs_cpu(torch, G, params, card, tmp):
    """a. Inception on 4 renders of the seed-2 generator (512², so through
    the antialiased resize to 299²), drawn weights with BatchNorm
    calibrated on 16 renders and their clamped copies (the dataset's
    images are clamped, the generator's are not), card against CPU:
    torchvision's layout through ``inception_feature_fn``, and NVIDIA's
    names converted and run through ``nvidia_detector_fn`` (BN
    separate), features and 1008-way logits. Saves both state dicts for
    the command line (b)."""
    from tgi_torch.metrics import inception as ti
    from tgi_torch.scripts.inception_error_scale import calibrate_inception
    calib = _metric_images(torch, G, params, 16, seed=9)
    calib = torch.cat([calib, calib.clamp(-1, 1)])
    img = calib[:4]
    gen = torch.Generator().manual_seed(11)
    dets, errs = {}, {}
    for layout, classes in (("torchvision", 1000), ("nvidia", 1008)):
        p = ti.inception_v3_init(gen, DEVICE)
        p["fc"] = {"weight": (torch.randn(classes, 2048, generator=gen)
                              * 0.01).to(DEVICE),
                   "bias": (torch.randn(classes, generator=gen)
                            * 0.01).to(DEVICE)}
        x = ti.resize_299(calib)
        if layout == "nvidia":
            x = (ti.resize_299((calib + 1) * 127.5) - 128.0) / 128.0
        calibrate_inception(p, x, layout == "nvidia")
        sd = (ti.torch_state_dict(p) if layout == "torchvision"
              else ti.nvidia_state_dict(p))
        dets[layout] = os.path.join(tmp, f"inception_{layout}.pt")
        torch.save(sd, dets[layout])
        outs = {}
        for dev in (DEVICE, "cpu"):
            im = img.to(dev)
            with torch.no_grad():
                if layout == "torchvision":
                    q = ti.convert_torch_inception(sd, dev)
                    outs[dev] = {"features": ti.inception_feature_fn(q)(im)}
                else:
                    q = ti.convert_nvidia_inception(sd, dev)
                    im = (im + 1) * 127.5
                    outs[dev] = {
                        "features": ti.nvidia_detector_fn(q)(im),
                        "logits": ti.nvidia_detector_fn(
                            q, return_logits=True)(im)}
        for k, want in outs["cpu"].items():
            got = outs[DEVICE][k]
            check(got.shape == want.shape and bool(torch.isfinite(got).all()),
                  f"inception {layout} {k}: shape {tuple(got.shape)}")
            errs[f"{layout}_{k}"] = _max_rel(got, want)
            log(f"inception {layout} {k}, card vs CPU: max |Δ| / max |CPU| "
                f"{errs[f'{layout}_{k}']:.3g} (max |CPU| "
                f"{want.abs().max().item():.4g}) [{card}]")
    check(max(errs.values()) <= INCEPTION_TOL,
          f"inception card vs CPU beyond {INCEPTION_TOL}: {errs}")
    return dets, errs


def metric_data(torch, G, params, tmp):
    """METRIC_ITEMS renders of the generator from other z's and cameras,
    written as ``.npy`` images ([3, 512, 512] in [-1, 1])."""
    import numpy as np
    data = os.path.join(tmp, "metric_data")
    os.makedirs(data)
    t0 = time.perf_counter()
    for i in range(0, METRIC_ITEMS, 32):
        imgs = _metric_images(torch, G, params, 32, seed=100 + i)
        for j, im in enumerate(imgs.clamp(-1, 1).cpu().numpy()):
            np.save(os.path.join(data, f"img{i + j:04d}.npy"), im)
    log(f"metric data: {METRIC_ITEMS} renders at {G.cfg.img_resolution}² "
        f"as .npy in "
        f"{time.perf_counter() - t0:.1f} s")
    return data


class metric_timer:
    """Inside the block, the command line's Inception calls, its feature
    loops and its distances are timed (the Inception calls between two
    synchronisations), and the statistics handed to ``calc_metric``
    kept."""

    def __init__(self, torch):
        self.torch = torch
        self.t = {"inception": 0.0, "dataset": 0.0, "generator": 0.0,
                  "distances": 0.0, "inception_generator": 0.0}
        self.stats = {}

    def __enter__(self):
        from tgi_torch.apps import calc_metrics
        from tgi_torch.metrics import features, gan_metrics
        torch, t, stats = self.torch, self.t, self.stats
        self.saved = [(calc_metrics, "load_detector_feature_fn"),
                      (features, "compute_dataset_features"),
                      (features, "compute_generator_features"),
                      (gan_metrics, "calc_metric")]
        self.saved = [(m, n, getattr(m, n)) for m, n in self.saved]
        (_, _, load), (_, _, data_fn), (_, _, gen_fn), (_, _, calc) = \
            self.saved
        in_gen = [False]

        def timed_loader(path, device=None):
            fn = load(path, device)

            def timed(x):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(x)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                t["inception"] += dt
                if in_gen[0]:
                    t["inception_generator"] += dt
                return out
            return timed

        def wrap(fn, key, gen=False):
            def run(*a, **kw):
                in_gen[0] = gen
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                t[key] += time.perf_counter() - t0
                in_gen[0] = False
                return out
            return run

        def timed_calc(name, **kw):
            stats["real"], stats["gen"] = kw["real_stats"], kw["gen_stats"]
            t0 = time.perf_counter()
            out = calc(name, **kw)
            t["distances"] += time.perf_counter() - t0
            return out

        calc_metrics.load_detector_feature_fn = timed_loader
        features.compute_dataset_features = wrap(data_fn, "dataset")
        features.compute_generator_features = wrap(gen_fn, "generator",
                                                   gen=True)
        gan_metrics.calc_metric = timed_calc
        return self

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def _metric_batch_swap_err(torch, gs, G, params):
    """One batch of METRIC_BATCH renders at the metrics' camera
    distribution, as ``compute_generator_features`` renders it, through
    the kernel and through the plain sampler on the same z and c; max abs
    difference of image, image_raw and image_depth. Its launches are
    outside the counted runs."""
    import tgi_torch.render.renderer as renderer
    from tgi_torch.apps.calc_metrics import default_camera_sampler
    from tgi_torch.metrics.features import generator_draws
    z, c = generator_draws(G, default_camera_sampler(device=DEVICE),
                           torch.Generator().manual_seed(21), METRIC_BATCH,
                           DEVICE)
    keys = ("image", "image_raw", "image_depth")
    with torch.no_grad():
        got = G(params, z, c, det=True)
        got = {k: got[k].float() for k in keys}
        before = gs.LAUNCHES
        renderer.sample_triplanes = gs.sample_triplanes_plain
        try:
            want = G(params, z, c, det=True)
        finally:
            renderer.sample_triplanes = gs.sample_triplanes
        torch.cuda.synchronize()
    check(gs.LAUNCHES == before, "the plain metrics batch launched the kernel")
    err = {k: (got[k] - want[k].float()).abs().max().item() for k in keys}
    log(f"calc_metrics batch (N = {METRIC_BATCH}), plain sampler vs kernel: "
        f"max abs err {err}")
    check(max(err.values()) <= SWAP_TOL,
          f"calc_metrics batch, plain sampler vs kernel: {err} > {SWAP_TOL}")
    return max(err.values())


def _read_jsonl(run, metric):
    with open(os.path.join(run, f"metric-{metric}.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_calc_metrics_cli(torch, gs, G, params, dets, card, tmp):
    """b. ``python -m tgi_torch.apps.calc_metrics`` end to end, in the
    process, on a port ``.ckpt`` of the seed-2 generator, METRIC_ITEMS
    ``.npy`` renders of it and each drawn detector (a torchvision-layout
    and an NVIDIA-named state dict): ``--metrics fid,kid,pr --num-items
    256 --run-dir``. Every count set to 0 just before each run and read
    just after: 2 gathers a rendered batch of 8, no splat. Its seconds
    split into rendering, Inception and the distances."""
    import math as m_
    from tgi_torch.apps import calc_metrics
    from tgi_torch.io.checkpoints import save_checkpoint
    net = os.path.join(tmp, "G_seed2.ckpt")
    save_checkpoint(net, params, config=G.cfg)
    data = metric_data(torch, G, params, tmp)
    want_gathers = 2 * m_.ceil(METRIC_ITEMS / METRIC_BATCH)
    runs = {}
    for layout, det in dets.items():
        run = os.path.join(tmp, f"metrics_{layout}")
        os.makedirs(run)
        zero_counts(gs)
        with metric_timer(torch) as mt:
            t0 = time.perf_counter()
            try:
                calc_metrics.main([
                    "--network", net, "--data", data,
                    "--metrics", "fid,kid,pr",
                    "--num-items", str(METRIC_ITEMS), "--run-dir", run,
                    "--detector", det, "--device", DEVICE])
            except SystemExit as e:
                check(e.code in (0, None), f"calc_metrics exited {e.code}")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = counts(gs)
        results = {}
        for metric in ("fid", "kid", "pr"):
            recs = _read_jsonl(run, metric)
            check(len(recs) == 1, f"metric-{metric}.jsonl: {len(recs)} rows")
            results.update(recs[0]["results"])
        check(all(math.isfinite(v) for v in results.values()),
              f"calc_metrics {layout}: {results}")
        check(launches["triplane_gather"] == want_gathers,
              f"calc_metrics {layout}: {launches['triplane_gather']} "
              f"gathers, want {want_gathers}")
        check(launches["triplane_splat"] == 0
              and launches["triplane_splat_sorted"] == 0,
              f"calc_metrics {layout}: a splat launched: {launches}")
        t = mt.t
        split = {"cli_s": wall,
                 "render_s": t["generator"] - t["inception_generator"],
                 "inception_s": t["inception"],
                 "dataset_read_s": t["dataset"] - (t["inception"]
                                                   - t["inception_generator"]),
                 "distances_s": t["distances"]}
        split["other_s"] = wall - (split["render_s"] + split["inception_s"]
                                   + split["dataset_read_s"]
                                   + split["distances_s"])
        runs[layout] = {"results": results, "launches": launches,
                        "seconds": split, "stats": mt.stats}
        log(f"calc_metrics {layout}: {results}; gathers "
            f"{launches['triplane_gather']}, splats "
            f"{launches['triplane_splat']}; "
            + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
            + f"; s per 1,000 items: render "
            f"{split['render_s'] * 1000 / METRIC_ITEMS:.2f}, Inception "
            f"{split['inception_s'] * 1000 / (2 * METRIC_ITEMS):.2f} [{card}]")
    return runs


def phase_fixed_points(torch, stats, card):
    """c. The distances at their fixed points on the card's features: fid
    of a set against itself within the square root's error on its
    rank-deficient covariance, pr exactly (1, 1)."""
    import numpy as np
    from tgi_torch.metrics.gan_metrics import calc_metric
    _, cov = stats.get_mean_cov()
    d = cov.shape[0]
    rank = min(stats.num_items - 1, d)
    lam = float(np.linalg.eigvalsh(cov).max())
    # sqrtm(Σ²) leaves each of Σ's d - rank null directions at
    # O(sqrt(eps) λmax) instead of 0, each counted twice in the trace.
    bound = 2 * (d - rank) * math.sqrt(np.finfo(np.float64).eps) * lam
    t0 = time.perf_counter()
    fid = calc_metric("fid", real_stats=stats, gen_stats=stats)[
        "results"]["fid"]
    pr = calc_metric("pr", real_stats=stats, gen_stats=stats)["results"]
    log(f"fixed points: fid(set, set) {fid:.3g} (bound {bound:.3g}: "
        f"2 x {d - rank} null directions x sqrt(eps) x λmax {lam:.4g}), "
        f"pr {pr}, {time.perf_counter() - t0:.1f} s [{card}]")
    check(abs(fid) <= bound, f"fid(set, set) = {fid} beyond {bound}")
    check(pr == {"precision": 1.0, "recall": 1.0}, f"pr(set, set) = {pr}")
    return {"fid_self": fid, "fid_bound": bound, "pr_self": pr}


def phase_is_ppl(torch, gs, G, params, nvidia_det, card):
    """d. ``is50k`` on the softmax of the NVIDIA detector's logits without
    the output bias on IS_IMAGES renders, in [1, 1008]; ``ppl2_wend`` on
    the full-width generator with drawn VGG/LPIPS, PPL_SAMPLES samples in
    batches of 4, finite, with 4 gathers a segment and no splat; both
    through ``calc_metric`` with explicit arguments."""
    from tgi_torch.apps.calc_metrics import default_camera_sampler
    from tgi_torch.apps.run_pti import load_state_dict
    from tgi_torch.losses.lpips import LPIPSLoss
    from tgi_torch.metrics import inception as ti
    from tgi_torch.metrics.gan_metrics import calc_metric
    det = ti.convert_nvidia_inception(load_state_dict(nvidia_det), DEVICE)
    logits_fn = ti.nvidia_detector_fn(det, return_logits=True,
                                      no_output_bias=True)
    zero_counts(gs)
    t0 = time.perf_counter()
    imgs = _metric_images(torch, G, params, IS_IMAGES, seed=31)
    with torch.no_grad():
        probs = torch.cat([logits_fn((imgs[i:i + 16] + 1) * 127.5)
                           .softmax(dim=1) for i in range(0, IS_IMAGES, 16)])
    is_res = calc_metric("is50k", gen_probs=probs)["results"]
    is_s = time.perf_counter() - t0
    is_launches = counts(gs)
    check(1.0 <= is_res["is_mean"] <= 1008 and math.isfinite(
        is_res["is_std"]), f"is50k {is_res}")
    zero_counts(gs)
    t0 = time.perf_counter()
    ppl = calc_metric(
        "ppl2_wend", G=G, params=params,
        lpips_loss=LPIPSLoss(generator=torch.Generator().manual_seed(41),
                             device=DEVICE),
        camera_sampler=default_camera_sampler(device=DEVICE),
        num_samples=PPL_SAMPLES)["results"]
    torch.cuda.synchronize()
    ppl_s = time.perf_counter() - t0
    ppl_launches = counts(gs)
    segments = PPL_SAMPLES // 4
    log(f"is50k on {IS_IMAGES} renders: {is_res}, {is_s:.1f} s, gathers "
        f"{is_launches['triplane_gather']}; ppl2_wend {PPL_SAMPLES} samples: "
        f"{ppl}, {ppl_s:.1f} s, gathers {ppl_launches['triplane_gather']} "
        f"({segments} segments) [{card}]")
    check(math.isfinite(ppl["ppl"]), f"ppl2_wend {ppl}")
    check(ppl_launches["triplane_gather"] == 4 * segments
          and ppl_launches["triplane_splat"] == 0,
          f"ppl2_wend launches {ppl_launches}")
    check(is_launches["triplane_gather"] == 2 * IS_IMAGES // METRIC_BATCH
          and is_launches["triplane_splat"] == 0,
          f"is50k renders' launches {is_launches}")
    return {"is50k": is_res, "is_s": is_s,
            "is_gathers": is_launches["triplane_gather"], "ppl": ppl["ppl"],
            "ppl_s": ppl_s, "ppl_gathers": ppl_launches["triplane_gather"]}


def _eq_samples(seed, n_batches, batch, z_dim, res):
    import numpy as np
    rng = np.random.RandomState(seed)
    return [dict(z=rng.randn(batch, z_dim).astype(np.float32),
                 t_int=np.round(rng.uniform(-0.125, 0.125, 2) * res) / res,
                 t_frac=rng.uniform(-0.125, 0.125, 2),
                 angle=float(rng.uniform(-np.pi, np.pi)))
            for _ in range(n_batches)]


def phase_sg3_eq(torch, card):
    """e. The alias-free generator at tgi's default SG3Config (256², 14
    layers, channel base 32768), drawn from a seed: ms per forward at
    batch 8, and ``compute_equivariance_metrics`` (EQ-T, EQ-T_frac,
    EQ-R) over EQ_SAMPLES samples, finite; a tiny SG3 on the card against
    its CPU run: images, and the three PSNRs with fixed draws."""
    from tgi_torch.nn.synthesis3 import SG3Config, SG3Generator
    from tgi_torch.metrics.equivariance import compute_equivariance_metrics
    eq_kw = dict(eqt_int=True, eqt_frac=True, eqr=True)
    G3 = SG3Generator(SG3Config())
    p3 = G3.init(torch.Generator().manual_seed(51), DEVICE)
    res = G3.cfg.img_resolution
    z = torch.randn(8, G3.cfg.z_dim,
                    generator=torch.Generator().manual_seed(52)).to(DEVICE)
    with torch.no_grad():
        img = G3(p3, z, None)
        check(img.shape == (8, 3, res, res)
              and bool(torch.isfinite(img).all()),
              f"SG3 forward: {tuple(img.shape)}")
        ms = cuda_ms(torch, lambda: G3(p3, z, None), iters=10, warmup=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    psnr = compute_equivariance_metrics(G3, p3, num_samples=EQ_SAMPLES,
                                        batch_size=8, **eq_kw)
    torch.cuda.synchronize()
    eq_s = time.perf_counter() - t0
    log(f"SG3 default config: {ms:.2f} ms per forward at batch 8; EQ over "
        f"{EQ_SAMPLES} samples: {psnr} dB in {eq_s:.1f} s [{card}]")
    check(all(math.isfinite(v) for v in psnr.values()), f"EQ {psnr}")
    del G3, p3

    tiny = dict(z_dim=16, w_dim=16, img_resolution=32, channel_base=1024,
                channel_max=16, num_layers=6, margin_size=4, num_fp16_res=0)
    g = SG3Generator(SG3Config(**tiny))
    cpu = g.init(torch.Generator().manual_seed(0), device="cpu")
    samples = _eq_samples(7, 2, 2, 16, 32)
    outs = {}
    for dev in ("cpu", DEVICE):
        p = _to(cpu, dev)
        zt = torch.from_numpy(samples[0]["z"]).to(dev)
        with torch.no_grad():
            outs[dev] = (g(p, zt, None, truncation_psi=0.8),
                         compute_equivariance_metrics(g, p, samples=samples,
                                                      **eq_kw))
    (img_cpu, psnr_cpu), (img_card, psnr_card) = outs["cpu"], outs[DEVICE]
    img_err = (img_card.cpu() - img_cpu).abs().max().item()
    img_scale = max(1.0, img_cpu.abs().max().item())
    db_err = max(abs(psnr_card[k] - psnr_cpu[k]) for k in psnr_cpu)
    log(f"tiny SG3, card vs CPU: image max |Δ| {img_err:.3g} (scale "
        f"{img_scale:.3g}); PSNRs {psnr_card} vs {psnr_cpu}, max |Δ| "
        f"{db_err:.3g} dB")
    check(img_err <= SG3_CPU_TOL * img_scale,
          f"tiny SG3 image card vs CPU {img_err}")
    check(db_err <= EQ_DB_TOL, f"tiny SG3 PSNRs card vs CPU {db_err} dB")
    return {"forward_ms_b8": ms, "eq_psnr_db": psnr, "eq_s": eq_s,
            "tiny_image_err": img_err, "tiny_psnr_err_db": db_err}


def phase_metrics(torch, gs, card, tmp):
    """Phase 15, a-e."""
    from tgi_torch.scripts import selfinv_gate
    t0 = time.perf_counter()
    G, params = selfinv_gate.full_width_generator(DEVICE, seed=2)
    dets, inc_errs = phase_inception_vs_cpu(torch, G, params, card, tmp)
    cli = phase_calc_metrics_cli(torch, gs, G, params, dets, card, tmp)
    batch_err = _metric_batch_swap_err(torch, gs, G, params)
    fixed = phase_fixed_points(torch, cli["torchvision"]["stats"]["gen"],
                               card)
    is_ppl = phase_is_ppl(torch, gs, G, params, dets["nvidia"], card)
    del G, params
    sg3 = phase_sg3_eq(torch, card)
    for run in cli.values():
        del run["stats"]
    out = {"inception_card_vs_cpu": inc_errs, "cli": cli,
           "batch_max_abs_err": batch_err,
           "fixed_points": fixed, "is_ppl": is_ppl, "sg3": sg3,
           "seconds": time.perf_counter() - t0}
    log(f"phase 15 (metrics) in {out['seconds']:.1f} s [{card}]")
    return out


# Phase 16: from a raw photo to an inversion, TF-era StyleGAN2 pickles and
# the render options. 16a: FFHQ config F (legacy.py's TF export of
# StyleGAN2 at 1024², fmap_base 16384, fmap_max 512, 8 mapping layers,
# minibatch-std groups of 4), drawn; Gs on the card at batch 4 against
# the CPU at batch 1, D at batch 4 on both.
SG2_G_KWARGS = dict(latent_size=512, dlatent_size=512, resolution=1024,
                    fmap_base=16384, fmap_max=512, mapping_layers=8,
                    truncation_psi=0.5, style_mixing_prob=0.9)
SG2_D_KWARGS = dict(resolution=1024, fmap_base=16384, fmap_max=512,
                    mbstd_group_size=4)
SG2_BATCH = 4
SG2_CPU_TOL = 1e-5         # card vs CPU, max abs / max |CPU|
FP16_PSNR_MIN = 55.0       # dB, a float16 render against float32 (float16
#                            read 67.10 dB and bf16 45.39 dB on the card)
PHOTO_STEPS = (10, 5)      # run_pti's projection and tuning steps
FREE_PAIRS = 4             # 16b's renders with the backbone recomputed


def phase_sg2_tf(torch, tmp, card):
    """16a: a TF-era ``(G, D, Gs)`` pickle of FFHQ config F, drawn and
    written here, read through ``load_network_pkl`` onto the card; Gs at
    batch 4 against the CPU at batch 1 and D at batch 4 against the CPU,
    within SG2_CPU_TOL of the largest value (deterministic cuDNN);
    ``legacy_convert.convert_pickle`` to the port's checkpoint, read back
    bit for bit. Returns the times and errors."""
    from tgi_torch.apps.legacy_convert import convert_pickle
    from tgi_torch.io import load_checkpoint, load_network_pkl
    from tgi_torch.models.stylegan2 import sg2_generator_apply
    from tgi_torch.nn.discriminator import discriminator_apply

    t0 = time.perf_counter()
    path = os.path.join(tmp, "stylegan2-ffhq-config-f.pkl")
    with open(path, "wb") as f:
        f.write(tf_network_pickle(SG2_G_KWARGS, SG2_D_KWARGS, seed=16))
    built = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    nets = load_network_pkl(path, device=DEVICE)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    gs_net, d_net = nets["G_ema"], nets["D"]
    n_params = {k: sum(t.numel() for t in _leaves(nets[k].params))
                for k in ("G", "D", "G_ema")}
    log(f"16a: TF (G, D, Gs) pickle of config F: "
        f"{os.path.getsize(path) / 2 ** 20:.1f} MiB drawn and written in "
        f"{built:.1f} s, read and converted onto the card in {read_s:.2f} "
        f"s; parameters {n_params}; Gs {gs_net.config}")
    R = SG2_G_KWARGS["resolution"]
    check(gs_net.config.img_resolution == R
          and gs_net.config.channel_base == 2 * SG2_G_KWARGS["fmap_base"]
          and gs_net.config.num_ws == 2 * int(math.log2(R)) - 2,
          f"Gs config {gs_net.config}")

    gen = torch.Generator().manual_seed(16)
    z = torch.randn(SG2_BATCH, gs_net.config.z_dim, generator=gen)
    c = torch.zeros(SG2_BATCH, 0)
    zd, cd = z.to(DEVICE), c.to(DEVICE)
    cpu_g = {k: _to(v, "cpu") for k, v in gs_net.params.items()}
    cpu_d = {k: _to(v, "cpu") for k, v in d_net.params.items()}
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            img = sg2_generator_apply(gs_net.params, zd, cd, gs_net.config)
            logits = discriminator_apply(d_net.params, img, cd,
                                         d_net.config)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img_cpu = sg2_generator_apply(cpu_g, z[:1], c[:1],
                                          gs_net.config)
            logits_cpu = discriminator_apply(cpu_d, img.cpu(), c,
                                             d_net.config)
            cpu_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = False
    check(tuple(img.shape) == (SG2_BATCH, 3, R, R)
          and bool(torch.isfinite(img).all()), f"Gs image {img.shape}")
    g_err = _rel_err(img[:1].cpu(), img_cpu)
    d_err = _rel_err(logits.cpu(), logits_cpu)
    log(f"16a: Gs {R}² card (batch {SG2_BATCH}) vs CPU (batch 1): max "
        f"|image| {img_cpu.abs().max().item():.4g}, max abs err / max "
        f"{g_err:.3g}; D logits {logits.flatten().tolist()}, card vs CPU "
        f"{d_err:.3g} (CPU forwards {cpu_s:.1f} s)")
    check(g_err <= SG2_CPU_TOL and d_err <= SG2_CPU_TOL,
          f"config F card vs CPU: Gs {g_err}, D {d_err} > {SG2_CPU_TOL}")
    with torch.no_grad():
        g_ms = cuda_ms(torch, lambda: sg2_generator_apply(
            gs_net.params, zd, cd, gs_net.config), iters=10, warmup=2)
        d_ms = cuda_ms(torch, lambda: discriminator_apply(
            d_net.params, img, cd, d_net.config), iters=10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    ckpt = os.path.join(tmp, "stylegan2-ffhq-config-f.ckpt")
    t0 = time.perf_counter()
    kinds = convert_pickle(path, ckpt)
    convert_s = time.perf_counter() - t0
    back = load_checkpoint(ckpt)
    for name in ("G", "D", "G_ema"):
        got = dict(_named_leaves(back["params"][name]))
        want = {k: v.cpu() for k, v in _named_leaves(nets[name].params)}
        check(set(got) == set(want) and all(
            torch.equal(got[k], want[k]) for k in want),
              f"{name}: the checkpoint does not read back bit for bit")
        check(back["config"][name]["kind"] == kinds[name],
              f"{name}: kind {back['config'][name]}")
    log(f"16a: legacy_convert.convert_pickle (CPU) in {convert_s:.1f} s -> "
        f"{os.path.getsize(ckpt) / 2 ** 20:.1f} MiB, {kinds}, every tensor "
        f"read back bit for bit; Gs forward {g_ms:.2f} ms at batch "
        f"{SG2_BATCH}, D forward {d_ms:.2f} ms at batch {SG2_BATCH}, peak "
        f"{peak:.2f} GiB [{card}]")
    out = {"read_convert_s": read_s, "legacy_convert_s": convert_s,
           "gs_forward_ms_batch4": g_ms, "d_forward_ms_batch4": d_ms,
           "peak_gib": peak, "gs_card_vs_cpu": g_err,
           "d_card_vs_cpu": d_err, "params": n_params}
    del nets, gs_net, d_net, cpu_g, cpu_d
    return out


def phase_render_options(torch, gs, G, params, card):
    """16b: the seed-0 generator with ``density_noise=1`` and random SR
    noise, every draw from one seeded CUDA generator, deterministic
    cuDNN: a 512² render through the gather and through the plain sampler
    from one and the same planes, so that the two differ only in the
    sampler (image, image_raw and image_depth within SWAP_TOL), the
    coarse and fine pass given one and the same normals (tgi's reuse of
    its key), one step's gradients kernels vs plain from one backbone
    forward within GRAD_TOL per weight, 2 gathers a render and 2 splats a
    backward; a float16 and a bf16 render against float32 (PSNR, float16
    >= FP16_PSNR_MIN dB, with float16 activations seen in its
    reduced-precision blocks); a render at a ``gaussian_camera_pose``
    draw. Logged beside: how far the backbone's planes move when
    recomputed without deterministic cuDNN, kernel vs plain when each
    render recomputes them (FREE_PAIRS times), and the kernel render's
    difference from itself."""
    import tgi_torch.nn.synthesis as synthesis
    import tgi_torch.render.renderer as renderer
    from tgi_torch.apps.gen_samples import seed_z
    from tgi_torch.models.generator import TriPlaneGenerator
    from tgi_torch.render.cameras import (fov_to_intrinsics,
                                          gaussian_camera_pose, pack_camera)

    Go = TriPlaneGenerator(G.cfg.with_rendering(
        density_noise=1.0, superresolution_noise_mode="random"))
    with torch.no_grad():
        ws = Go.mapping(params, seed_z(0, G.cfg.z_dim, DEVICE),
                        _camera(torch, 0.0), truncation_psi=0.7,
                        truncation_cutoff=14)
        planes_free = Go.backbone_planes(params, ws)
    cam = _camera(torch, 0.35)
    seen = []
    real_run_model = renderer.run_model

    def spy(*args, sigma_noise=None, **kw):
        seen.append(sigma_noise)
        return real_run_model(*args, sigma_noise=sigma_noise, **kw)

    def render(sampler, planes):
        renderer.sample_triplanes = sampler
        try:
            return Go.synthesis(params, ws, cam, det=True, planes=planes,
                                generator=torch.Generator(
                                    device=DEVICE).manual_seed(16))
        finally:
            renderer.sample_triplanes = gs.sample_triplanes

    keys = ("image", "image_raw", "image_depth")
    renderer.run_model = spy
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            planes = Go.backbone_planes(params, ws)
            zero_counts(gs)
            got = render(gs.sample_triplanes, planes)
            torch.cuda.synchronize()
            launches = counts(gs)
            want = render(gs.sample_triplanes_plain, planes)
            torch.cuda.synchronize()
            after_plain = counts(gs)
            again = render(gs.sample_triplanes, planes)
    finally:
        renderer.run_model = real_run_model
        torch.backends.cudnn.deterministic = False
    check(launches["triplane_gather"] == 2 and after_plain == launches,
          f"the options render launched {launches}, then {after_plain}")
    rk, res = Go.cfg.rendering_kwargs, Go.cfg.neural_rendering_resolution
    check(rk["depth_resolution"] == rk["depth_resolution_importance"]
          and len(seen) == 6 and seen[0] is seen[1] and seen[0] is not None
          and tuple(seen[0].shape) == (1, res * res * rk[
              "depth_resolution"], 1),
          "the coarse and fine passes did not get one and the same noise")
    err = {k: (got[k] - want[k]).abs().max().item() for k in keys}
    repeat = {k: (got[k] - again[k]).abs().max().item() for k in keys}
    planes_moved = (planes_free - planes).abs().max().item()
    # Kernel vs plain where each render recomputes its own backbone
    # (default cuDNN): the planes move at the last bits from one forward
    # to the next, and the importance pass under density noise can carry
    # that far into the image. Logged, not held.
    recomputed = []
    with torch.no_grad():
        for _ in range(FREE_PAIRS):
            a, b = (render(gs.sample_triplanes, None),
                    render(gs.sample_triplanes_plain, None))
            recomputed.append(max((a[k] - b[k]).abs().max().item()
                                  for k in keys))
    with torch.no_grad():
        base = G.synthesis(params, ws, cam, det=True, planes=planes)
    moved = (got["image"] - base["image"]).abs().max().item()
    log(f"16b: density_noise 1 + random SR noise, "
        f"{Go.cfg.img_resolution}² render from one set of planes: kernel "
        f"vs plain sampler max abs err {err}; the kernel render again "
        f"{repeat}; the backbone's planes recomputed without "
        f"deterministic cuDNN move by {planes_moved:.3g}, and kernel vs "
        f"plain with the backbone recomputed for each render reads "
        f"{[f'{e:.3g}' for e in recomputed]}; coarse and fine "
        f"noise one tensor {tuple(seen[0].shape)}; max |image - noiseless "
        f"image| {moved:.4g}; launches {launches}")
    check(max(err.values()) <= SWAP_TOL and moved > 1e-3,
          f"options render: kernel vs plain {err} > {SWAP_TOL} or the "
          f"noise moved nothing ({moved})")

    weights = [w.to(DEVICE) for w in _loss_weights(torch, G)]
    leaves = [_get(params, p) for p in GRAD_PATHS]
    for t in leaves:
        t.requires_grad_(True)
    torch.backends.cudnn.deterministic = True
    try:
        planes = Go.backbone_planes(params, ws)
        zero_counts(gs)
        kernel = torch.autograd.grad(
            _scalar_loss(render(gs.sample_triplanes, planes), weights),
            leaves, retain_graph=True)
        torch.cuda.synchronize()
        grad_launches = counts(gs)
        plain = torch.autograd.grad(
            _scalar_loss(render(gs.sample_triplanes_plain, planes), weights),
            leaves)
        del planes
    finally:
        torch.backends.cudnn.deterministic = False
        for t in leaves:
            t.requires_grad_(False)
    check(grad_launches["triplane_gather"] == 2
          and grad_launches["triplane_splat"] == 2,
          f"one options step launched {grad_launches}")
    grad_errs = {}
    for path, k, p in zip(GRAD_PATHS, kernel, plain):
        name = ".".join(path)
        grad_errs[name] = _norm_err(k, p)
        check(k.abs().max().item() > 0 and grad_errs[name] <= GRAD_TOL,
              f"{name}: options gradient kernels vs plain "
              f"{grad_errs[name]} > {GRAD_TOL}")
    log(f"16b: one step's gradients under the options, kernels vs plain "
        f"sampler from one backbone forward, norm err {grad_errs}; "
        f"launches {grad_launches}")

    psnr, act_dtypes = {}, {}
    out32 = render_once(torch, G, params)
    real_layer = synthesis.synthesis_layer_apply
    for dtype in ("float16", "bfloat16"):
        Gx = TriPlaneGenerator(dataclasses.replace(G.cfg, fused_dtype=dtype))
        dtypes = set()

        def layer_spy(p, x, *a, _dtypes=dtypes, **kw):
            _dtypes.add(x.dtype)
            return real_layer(p, x, *a, **kw)

        synthesis.synthesis_layer_apply = layer_spy
        try:
            out = render_once(torch, Gx, params)
        finally:
            synthesis.synthesis_layer_apply = real_layer
        d = out["image"] - out32["image"]
        check(bool(torch.isfinite(out["image"]).all()),
              f"non-finite {dtype} render")
        check(getattr(torch, dtype) in dtypes
              and dtypes <= {torch.float32, getattr(torch, dtype)},
              f"the {dtype} render's layers ran in {dtypes}")
        act_dtypes[dtype] = sorted(str(t).split(".")[1] for t in dtypes)
        psnr[dtype] = 10 * math.log10(4.0 / (d.square().mean().item()
                                             or 1e-30))
    log(f"16b: {G.cfg.img_resolution}² render against float32, PSNR "
        f"(peak-to-peak 2): "
        f"float16 {psnr['float16']:.2f} dB, bfloat16 "
        f"{psnr['bfloat16']:.2f} dB; activations {act_dtypes} [{card}]")
    check(psnr["float16"] >= FP16_PSNR_MIN,
          f"float16 render PSNR {psnr['float16']} < {FP16_PSNR_MIN} dB")

    cam2world = gaussian_camera_pose(
        torch.Generator(device=DEVICE).manual_seed(3), math.pi / 2,
        math.pi / 2, 0.3, 0.15, 2.7, 1, device=DEVICE)
    c = pack_camera(cam2world, fov_to_intrinsics(18.837, device=DEVICE))
    with torch.no_grad():
        out = G.synthesis(params, ws, c, det=True)
    depth = out["image_depth"]
    origin = cam2world[0, :3, 3].tolist()
    log(f"16b: render at a gaussian_camera_pose draw (CUDA generator, "
        f"seed 3): camera at {[round(v, 4) for v in origin]}, image mean "
        f"{out['image'].mean().item():.4g}, depth "
        f"[{depth.min().item():.4f}, {depth.max().item():.4f}]")
    check(bool(torch.isfinite(out["image"]).all())
          and abs(cam2world[0, :3, 3].norm().item() - 2.7) < 1e-4,
          "gaussian_camera_pose render")
    return {"launches": launches, "grad_launches": grad_launches,
            "max_abs_err": err, "kernel_repeat_max_abs_err": repeat,
            "planes_moved_nondeterministic": planes_moved,
            "max_abs_err_backbone_recomputed": recomputed,
            "grad_norm_err": grad_errs, "psnr": psnr,
            "activation_dtypes": act_dtypes}


def phase_photo_to_inversion(torch, gs, tmp, card):
    """16c: a raw 1024 x 768 photo (the seed-2 generator's target render,
    scaled to 600² and pasted off centre), a drawn predictor at dlib's
    defaults saved with ``save_shape_predictor``, ``align_data
    --predictor --size 512``, ``dataset_tool`` to a zip read back through
    ``ImageFolderDataset`` (the aligned PNG bit for bit), and ``run_pti``
    on the aligned folder at PHOTO_STEPS with every count set to 0 just
    before it."""
    import numpy as np
    from PIL import Image
    from tgi_torch.apps import align_data, dataset_tool
    from tgi_torch.apps.run_pti import run_pti
    from tgi_torch.scripts import selfinv_gate
    from tgi_torch.train.dataset import ImageFolderDataset
    from tgi_torch.utils import alignment, landmarks

    from tgi_torch.apps.gen_samples import seed_z
    G, params = selfinv_gate.full_width_generator(DEVICE, seed=2)
    with torch.no_grad():   # stage1_target's render: seed 2, yaw -0.25
        ws = G.mapping(params, seed_z(2, G.cfg.z_dim, DEVICE),
                       _camera(torch, 0.0), truncation_psi=0.7,
                       truncation_cutoff=14)
        img = G.synthesis(params, ws, _camera(torch, -0.25),
                          det=True)["image"].clamp(-1, 1)
    face = Image.fromarray(((img[0].permute(1, 2, 0).cpu().numpy() + 1)
                            * 127.5).round().clip(0, 255).astype(np.uint8))
    canvas = Image.new("RGB", (1024, 768), (40, 50, 60))
    canvas.paste(face.resize((600, 600), Image.LANCZOS), (250, 90))
    raw, aligned = os.path.join(tmp, "photo_raw"), os.path.join(
        tmp, "photo_aligned")
    os.makedirs(raw)
    canvas.save(os.path.join(raw, "photo.png"))

    t0 = time.perf_counter()
    sp = drawn_predictor(17)
    drawn_s = time.perf_counter() - t0
    pred = os.path.join(tmp, "shape_predictor_68_drawn.dat")
    t0 = time.perf_counter()
    landmarks.save_shape_predictor(sp, pred)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        align_data.main(["--src", raw, "--dst", aligned, "--predictor",
                         pred, "--size", "512"])
    except SystemExit as e:
        check(e.code == 0, f"align_data exited {e.code}")
    align_cli_s = time.perf_counter() - t0
    photo = np.asarray(canvas)
    t0 = time.perf_counter()
    box = landmarks.detect_face_box(photo)
    lms = landmarks.predict_landmarks(sp, photo, box)
    cascade_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    crop = alignment.align_face(canvas, lms, output_size=512)
    align_s = time.perf_counter() - t0
    with open(os.path.join(aligned, "_landmarks.json")) as f:
        table = json.load(f)
    out_png = os.path.join(aligned, "photo.png")
    check(np.array_equal(np.asarray(table["photo.png"]), lms)
          and np.array_equal(np.asarray(Image.open(out_png)),
                             np.asarray(crop)),
          "align_data's landmarks or crop differ from the library's")
    spread = np.abs(lms - (np.asarray(box[:2]) + mean_face() * (
        box[2] - box[0]))).max()
    log(f"16c: predictor at dlib's defaults (10 x 500 trees of depth 4, "
        f"pool 400) drawn in {drawn_s:.1f} s, saved "
        f"({os.path.getsize(pred) / 2 ** 20:.1f} MiB) in {save_s:.1f} s; "
        f"align_data --predictor --size 512 in {align_cli_s:.1f} s "
        f"(reading the .dat, the cascade, the warp); per face: landmark "
        f"cascade {cascade_s * 1e3:.1f} ms, alignment {align_s * 1e3:.1f} "
        f"ms; landmarks within {spread:.3g} px of the mean face in the box")

    zpath = os.path.join(tmp, "photo_dataset.zip")
    check(dataset_tool.convert(aligned, zpath) == 1, "dataset_tool count")
    ds = ImageFolderDataset(zpath)
    arr, label = ds[0]
    ds.close()
    png = np.asarray(Image.open(out_png), np.float32)
    check(len(ds) == 1 and np.array_equal(
        arr, png.transpose(2, 0, 1) / 127.5 - 1) and not label.any(),
          "the dataset's image is not the aligned PNG")
    log("16c: dataset_tool -> zip -> ImageFolderDataset: the aligned PNG "
        "bit for bit, no labels")

    steps1, steps2 = PHOTO_STEPS
    torch.cuda.synchronize()
    zero_counts(gs)
    t0 = time.perf_counter()
    results = run_pti(aligned, os.path.join(tmp, "photo_pti"), G=G,
                      gen_params=params, first_inv_steps=steps1,
                      max_pti_steps=steps2, gen_video=False, seed=0,
                      device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(gs)
    log(f"16c: run_pti on the aligned photo, {steps1} + {steps2} steps, in "
        f"{wall:.1f} s: {results}; launches {launches} [{card}]")
    check(len(results) == 1 and launches["triplane_splat"]
          == 4 * steps1 + 2 * steps2 and launches["triplane_gather"]
          >= 4 * steps1 + 2 * steps2,
          f"run_pti on the photo: {len(results)} results, launches "
          f"{launches}")
    del G, params
    return {"launches": launches, "run_pti_s": wall, "save_s": save_s,
            "align_data_s": align_cli_s, "cascade_ms": cascade_s * 1e3,
            "align_ms": align_s * 1e3}


def phase_photo_and_tf(torch, gs, G, params, card, tmp):
    """Phase 16, a-c."""
    t0 = time.perf_counter()
    out = {"sg2_tf": phase_sg2_tf(torch, tmp, card),
           "render_options": phase_render_options(torch, gs, G, params,
                                                  card),
           "photo": phase_photo_to_inversion(torch, gs, tmp, card)}
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 16 (photo, TF pickles, render options) in "
        f"{out['seconds']:.1f} s [{card}]")
    return out


def phase_forward_repeat(torch, G, params, st):
    """Which of stage 1's inputs and forwards repeat their bits when run
    twice: the target render, the w statistics of 5000 latents, and one
    step's loss forward under cuDNN's default and deterministic
    algorithms. Logs the largest differences."""
    proj = st["proj"]
    (img, t255), (img2, t2552) = (stage1_target(torch, G, params)
                                  for _ in range(2))
    stats = [proj.compute_w_stats(generator=torch.Generator(
        device=DEVICE).manual_seed(11)) for _ in range(2)]
    losses = {}
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        try:
            with torch.no_grad():
                losses[det] = [proj._loss(st["state"], st["t255"], st["feats"],
                                          st["w_noise"], draws=st["draws"],
                                          target_warp=st["img"])[0].item()
                               for _ in range(2)]
        finally:
            torch.backends.cudnn.deterministic = False
    d_img = (img - img2).abs().max().item()
    d_t255 = (t255 - t2552).abs().max().item()
    d_avg = (stats[0][0] - stats[1][0]).abs().max().item()
    d_std = (stats[0][1] - stats[1][1]).abs().item()
    log(f"run twice, max |Δ|: target render {d_img:.3g}, its 256² shrink "
        f"{d_t255:.3g}; w_avg {d_avg:.3g}, w_std {d_std:.3g}; one step's "
        f"loss forward, default cuDNN {losses[False]}, deterministic cuDNN "
        f"{losses[True]}")


def phase_stage1_step_times(torch, gs, st, mode="pack", steps=6, warmup=2):
    """One joint-phase stage-1 step, the body of ``Projector.step``: the
    loss forward, the backward, the three Adams with the noise
    renormalization, on CUDA events; returns the medians and the peak
    memory."""
    proj, state, opts = st["proj"], st["state"], st["opts"]
    parts = {"forward": [], "backward": [], "adams": [], "step": [],
             "step_host": []}
    with splat_route(mode):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(warmup + steps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            for opt in opts.values():
                opt.zero_grad(set_to_none=True)
            loss, _ = proj._loss(state, st["t255"], st["feats"],
                                 st["w_noise"], generator=st["gen"],
                                 target_warp=st["img"])
            ev[1].record()
            loss.backward()
            ev[2].record()
            proj.update(state, opts, st["step"])
            ev[3].record()
            ev[3].synchronize()
            host = (time.perf_counter() - t0) * 1e3
            if i >= warmup:
                parts["forward"].append(ev[0].elapsed_time(ev[1]))
                parts["backward"].append(ev[1].elapsed_time(ev[2]))
                parts["adams"].append(ev[2].elapsed_time(ev[3]))
                parts["step"].append(ev[0].elapsed_time(ev[3]))
                parts["step_host"].append(host)
    med = {k: statistics.median(v) for k, v in parts.items()}
    med["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"times, one full-width stage-1 step (TGI_SPLAT={mode}, median of "
        f"{steps}): {med['step']:.2f} ms = forward {med['forward']:.2f} + "
        f"backward {med['backward']:.2f} + Adams {med['adams']:.2f} ms (CUDA "
        f"events); host clock {med['step_host']:.2f} ms; peak memory "
        f"{med['peak_gib']:.2f} GiB; all steps: {parts}")
    return med


def phase_sorted_times(torch, gs, seen, bw):
    """The sorted splat per pass on the main path's inputs (the stage-1
    step's four backward passes under TGI_SPLAT=mxu): whole, its prep
    (key kernel, the stable sort, the offsets-and-records kernel) and
    its segment kernel apart, beside ``triplane_splat.cu``, the plain
    version and ``grid_sampler_2d_backward`` on the same input, and the
    bound."""
    rows = []
    for i, (coords, g, bwarp, H, W) in enumerate(seen):
        N, M = coords.shape[:2]
        C = g.shape[3]
        keys = gs.splat_keys_cuda(coords, bwarp, H, W)
        keys_s, order = torch.sort(keys, stable=True)
        offsets, records = gs.splat_offsets_cuda(coords, keys_s, order,
                                                 bwarp, H, W)
        planes_cl = torch.empty((N, 3, H, W, C), device=DEVICE)  # not read
        nchw = planes_cl.permute(0, 1, 4, 2, 3).reshape(N * 3, C, H, W)
        grid = gs.project_onto_planes((2.0 / bwarp) * coords).reshape(
            N * 3, 1, M, 2)
        g_lib = g.reshape(N * 3, M, C).permute(0, 2, 1).reshape(
            N * 3, C, 1, M).contiguous()
        t = {
            "ms": cuda_ms(torch, lambda: gs.triplane_splat_sorted_cuda(
                coords, g, bwarp, H, W)),
            "prep_ms": cuda_ms(torch, lambda: gs.splat_prep_cuda(
                coords, bwarp, H, W)),
            "keys_ms": cuda_ms(torch, lambda: gs.splat_keys_cuda(
                coords, bwarp, H, W)),
            "sort_ms": cuda_ms(torch, lambda: torch.sort(keys, stable=True)),
            "offsets_ms": cuda_ms(torch, lambda: gs.splat_offsets_cuda(
                coords, keys_s, order, bwarp, H, W)),
            "segment_ms": cuda_ms(torch, lambda: gs.splat_segments_cuda(
                g, records, offsets, H, W)),
            "fused_splat_ms": cuda_ms(torch, lambda: gs.triplane_splat_cuda(
                planes_cl, coords, g, bwarp, False)),
            "plain_ms": cuda_ms(torch, lambda: gs.triplane_splat_sorted_plain(
                coords, g, bwarp, H, W), iters=5),
            "library_ms": cuda_ms(torch, lambda: torch.ops.aten.
                                  grid_sampler_2d_backward(
                                      g_lib, nchw, grid, 0, 0, False,
                                      [True, False])),
        }
        # The function's bound, as the fused splat's: g and coords read,
        # d_planes written once; per point and plane four weighted adds
        # per channel and ~20 flops of projection and weights.
        nbytes = 4 * (N * 3 * M * C + N * M * 3 + N * 3 * H * W * C)
        flops = N * 3 * M * (8 * C + 20)
        t["bound_ms"] = max(nbytes / bw, flops / FP32_FLOPS) * 1e3
        t["bound_by"] = ("bytes" if nbytes / bw >= flops / FP32_FLOPS
                         else "operations")
        # The sorted design's own least traffic on top, each written once
        # and read once: its int32 keys, the sort's int64 indices, the
        # 16-byte records and the offsets.
        T = N * 3 * M
        design = nbytes + 2 * (4 * T + 8 * T + 16 * T + 4 * offsets.numel())
        t["design_bound_ms"] = max(design / bw, flops / FP32_FLOPS) * 1e3
        log(f"times, sorted splat pass {i} (N={N}, M={M}, C={C}, {H}x{W}): "
            + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else
                        f"{k} {v}" for k, v in t.items())
            + f" (bound {nbytes / 1e6:.1f} MB, with the keys, indices, "
            f"records and offsets {design / 1e6:.1f} MB, at "
            f"{bw / 1e12:.2f} TB/s)")
        rows.append(t)
    out = {k: sum(r[k] for r in rows) / len(rows) for k in rows[0]
           if k != "bound_by"}
    out["bound_by"] = rows[0]["bound_by"]
    return out


def phase_small_splat_times(torch, gs, bw):
    """``triplane_splat.cu`` at the C = 16 check shape (tgi's
    ``plane_splat`` case), beside its plain version, the library call and
    the bound."""
    N, C, H, W, M, _ = CHECK_SHAPES[2]
    gen = torch.Generator().manual_seed(12)
    planes_cl = torch.randn(N, 3, H, W, C, generator=gen).to(DEVICE)
    coords = (torch.rand(N, M, 3, generator=gen) * 1.4 - 0.7).to(DEVICE)
    g = torch.randn(N, 3, M, C, generator=gen).to(DEVICE)
    nchw = planes_cl.permute(0, 1, 4, 2, 3).reshape(
        N * 3, C, H, W).contiguous()
    grid = gs.project_onto_planes(2.0 * coords).reshape(N * 3, 1, M, 2)
    g_lib = g.reshape(N * 3, M, C).permute(0, 2, 1).reshape(
        N * 3, C, 1, M).contiguous()
    t = {"ms": cuda_ms(torch, lambda: gs.triplane_splat_cuda(
             planes_cl, coords, g, 1.0, False)),
         "plain_ms": cuda_ms(torch, lambda: gs.triplane_splat_plain(
             planes_cl, coords, g, 1.0, False)),
         "library_ms": cuda_ms(torch, lambda: torch.ops.aten.
                               grid_sampler_2d_backward(
                                   g_lib, nchw, grid, 0, 0, False,
                                   [True, False]))}
    nbytes = 4 * (N * 3 * M * C + N * M * 3 + N * 3 * H * W * C)
    flops = N * 3 * M * (8 * C + 20)
    t["bound_ms"] = max(nbytes / bw, flops / FP32_FLOPS) * 1e3
    t["bound_by"] = ("bytes" if nbytes / bw >= flops / FP32_FLOPS
                     else "operations")
    t["shape"] = [N, C, H, W, M]
    log(f"times, triplane_splat at the C={C} check shape (N={N}, M={M}, "
        f"{H}x{W}): {t}")
    return t


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
        log(f"ratios, gather {name} pass: kernel / F.grid_sample "
            f"{t_kernel / t_lib:.3f}, share of the bound "
            f"{100 * bound / t_kernel:.1f} %")
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


def phase_step_times(torch, gs, params, st, steps=6, warmup=2,
                     label="full-width"):
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
    log(f"times, one {label} tuning step (median of {steps}): "
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
        # With d_coords the planes are read and d_coords written too.
        bound_c = bound + 4 * (N * 3 * H * W * C + N * M * 3) / bw * 1e3
        log(f"times, splat {name} pass (N={N}, M={M}, C={C}, {H}x{W}): "
            f"kernel {t_kernel:.4f} ms (with d_coords {t_kernel_c:.4f}), "
            f"plain {t_plain:.4f} ms, grid_sampler_2d_backward {t_lib:.4f} "
            f"ms (with d_grid {t_lib_c:.4f}), bound {bound:.4f} ms ({by}: "
            f"{nbytes / 1e6:.1f} MB at {bw / 1e12:.2f} TB/s; with d_coords "
            f"{bound_c:.4f} ms)")
        log(f"ratios, splat {name} pass: kernel / grid_sampler_2d_backward "
            f"{t_kernel / t_lib:.3f} (with d_coords / with d_grid "
            f"{t_kernel_c / t_lib_c:.3f}), share of the bound "
            f"{100 * bound / t_kernel:.1f} % (with d_coords "
            f"{100 * bound_c / t_kernel_c:.1f} %)")
        rows.append((t_kernel, t_plain, t_lib, bound, by))
    mean = [sum(r[i] for r in rows) / len(rows) for i in range(4)]
    return {"ms": mean[0], "plain_ms": mean[1], "library_ms": mean[2],
            "bound_ms": mean[3], "bound_by": rows[0][4]}


# ---------------------------------------------------------------------------
# Phase 17: batched inversion on the gate's full-width generator (seed 2)
# at B = 4, the batched gate's cameras (selfinv._BATCH_POSE_OFFSETS).
BATCH = 4
BATCH_TIMING_SIZES = (1, 2, 4)
BATCH_RUN_PTI_IMAGES = 5           # a chunk of 4 and a ragged one of 1
BATCH_RUN_PTI_STEPS = (10, 5)      # run_pti's projection and tuning steps
# Image b of a batched step against the one-image step on its inputs and
# draws, with deterministic cuDNN and TF32 off: the loss within
# BATCH_LANE_LOSS_TOL relative and each group's gradient ||Δ||_2 <=
# BATCH_LANE_TOL * ||want||_2. The two differ in the convolutions' batch
# (stage 1: N = 4 against 1, the pose nets grouped), in stage 2 the
# modulated convs' form (the reference's fused grouped conv against the
# unfused one) and in the splat's atomics; the kernels against the plain
# sampler, which differ only in the splat's sums, are held to
# STAGE1_GRAD_TOL and GRAD_TOL.
BATCH_LANE_LOSS_TOL = 1e-5
BATCH_LANE_TOL = 1e-3
# The camera's gradient (pose net, translation) crosses discontinuities:
# a fine sample's bin in the importance sampler, the warp's foreground
# mask, a cell's floor in the warp's sampling. A rounding there moves it
# further: on an H100 image 3 read 1.7e-2 on the pose net and 1.5e-2 on
# the translation in one call and 3.5e-5 / 3.3e-5 in the next, same
# seeds (PERF.md §6, PR 18). An image mixed with another, or a wrong
# grouped conv, reads O(1). The log also gives how far the one-image
# step moves when its latent moves by BATCH_LANE_MOVE of itself.
BATCH_CAMERA_TOL = 5e-2
BATCH_LANE_MOVE = 1e-6
# The tuning step's groups of generator weights.
TUNE_GROUPS = ("backbone", "superresolution", "decoder")


def batch_targets(torch, G, params, n, seed=0):
    """n targets of the batched gate's kind: image i from seed + 10 i's
    latent at the i-th of ``_BATCH_POSE_OFFSETS`` (cycled). Returns
    (images [n, 1, 3, 512, 512] in [-1, 1], their 256² [0, 255] versions
    [n, 1, 3, 256, 256])."""
    from tgi_torch.invert import selfinv
    imgs, t255s = [], []
    for i in range(n):
        z = torch.randn((1, G.cfg.z_dim), generator=torch.Generator()
                        .manual_seed(seed + 10 * i)).to(DEVICE)
        with torch.no_grad():
            ws = G.mapping(params, z, _camera(torch, 0.0),
                           truncation_psi=0.7, truncation_cutoff=14)
        yaw, pitch = selfinv._BATCH_POSE_OFFSETS[
            i % len(selfinv._BATCH_POSE_OFFSETS)]
        _, cam = selfinv.gate_camera(yaw, pitch, DEVICE)
        img, t255 = selfinv.gate_target(G, params, ws, cam)
        imgs.append(img)
        t255s.append(t255)
    return torch.stack(imgs), torch.stack(t255s)


def batch_setup(torch, G, params, targets_G=None):
    """Stage 1 and stage 2 of B images at full width: each image's pose
    ResNet-34 calibrated on its target (rendered by ``targets_G``, else
    ``G``), VGG16 and its LPIPS head, drawn from seeds; a batched
    projector state with the inputs of one joint step, every draw of its
    two renders; a coach with AlexNet-LPIPS and the pivots the state
    gives. Every draw from a seed."""
    from tgi_torch.invert.coach import (CoachConfig, PTICoach, cat_draws,
                                        render_draws)
    from tgi_torch.invert.projector import Projector, ProjectorConfig
    from tgi_torch.losses.lpips import make_lpips
    from tgi_torch.models.pose_resnet import (resnet34_calibrate,
                                              resnet34_init, stack_nets)
    from tgi_torch.models.vgg import (lpips_features, lpips_head_init,
                                      vgg16_init)
    imgs, t255 = batch_targets(torch, targets_G or G, params, BATCH)
    gen = torch.Generator().manual_seed(8)
    pose0 = resnet34_init(gen, 4, DEVICE)
    vgg, head = vgg16_init(gen, DEVICE), lpips_head_init(gen, DEVICE)
    with torch.no_grad():
        nets = [resnet34_calibrate(pose0, t255[b]) for b in range(BATCH)]
        feats = lpips_features(vgg, head, t255[:, 0])
    proj = Projector(G, params, vgg, head, nets[0],
                     ProjectorConfig(num_steps=STAGE1_STEPS))
    state, opts, w_std = proj.init_state_batch(
        BATCH, generators=[torch.Generator(device=DEVICE).manual_seed(20 + b)
                           for b in range(BATCH)],
        pose_params_b=stack_nets(nets))
    step = proj.cfg.cam_preheat_steps + 5
    w_noise = torch.randn(state["w"].shape, generator=torch.Generator(
        device=DEVICE).manual_seed(9), device=DEVICE) * (
            w_std * proj.schedule(step)[0])
    cpu = [torch.Generator().manual_seed(30 + b) for b in range(BATCH)]
    views = [[render_draws(G, [g], DEVICE) for g in cpu] for _ in range(2)]
    draws = tuple(cat_draws(v) for v in views)
    lp = make_lpips("alex", generator=torch.Generator().manual_seed(5),
                    device=DEVICE)
    coach = PTICoach(G, lp, CoachConfig(lpips_threshold=0.0))
    with torch.no_grad():
        ws = state["w"].detach().reshape(BATCH, 1, -1).repeat(
            1, G.cfg.num_ws, 1)
        cams = proj.camera(state["pose"], state["translation"].reshape(
            BATCH, 3), t255[:, 0])[1]
    tune_draws = render_draws(G, [torch.Generator().manual_seed(40 + b)
                                  for b in range(BATCH)], DEVICE)
    return dict(proj=proj, state=state, opts=opts, w_std=w_std, t255=t255,
                imgs=imgs, feats=feats, w_noise=w_noise, draws=draws,
                step=step, nets=nets, vgg=vgg, head=head, pose0=pose0,
                coach=coach, ws=ws, cams=cams, tune_draws=tune_draws)


def _lane_draws(draws, b, M):
    """Image b's render draws out of a batch's (``render_draws``' dict):
    its row of every draw, its M rays' rows of the importance
    uniforms."""
    def take(key, v):
        if isinstance(v, dict):
            return {k: take(key, x) for k, x in v.items()}
        if isinstance(v, tuple):
            return tuple(take(key, x) for x in v)
        return v[b * M:(b + 1) * M] if key == "u" else v[b:b + 1]
    return {k: take(k, v) for k, v in draws.items()}


class _recorder:
    """Inside the block: the renderer's sampler (``sampler``, or the
    package's), recording each pass's (planes, coords, box_warp), and the
    splat wrappers recording their arguments; with ``keep=False`` only
    each pass's N (``self.Ns``)."""

    def __init__(self, gs, sampler=None, keep=True):
        self.gs, self.sampler, self.keep = gs, sampler, keep
        self.gathers, self.splats, self.sorted, self.Ns = [], [], [], []

    def __enter__(self):
        import tgi_torch.render.renderer as renderer
        gs, sampler = self.gs, self.sampler or self.gs.sample_triplanes
        self.real = (gs.triplane_splat_cuda, gs.triplane_splat_sorted_cuda)

        def sample(planes, coords, box_warp):
            self.Ns.append(planes.shape[0])
            if self.keep:
                self.gathers.append((planes, coords, box_warp))
            return sampler(planes, coords, box_warp)

        def splat(*args, **kw):
            if self.keep:
                self.splats.append((args, kw))
            return self.real[0](*args, **kw)

        def sorted_splat(*args):
            if self.keep:
                self.sorted.append(args)
            return self.real[1](*args)

        renderer.sample_triplanes = sample
        gs.triplane_splat_cuda = splat
        gs.triplane_splat_sorted_cuda = sorted_splat
        return self

    def __exit__(self, *exc):
        import tgi_torch.render.renderer as renderer
        renderer.sample_triplanes = self.gs.sample_triplanes
        self.gs.triplane_splat_cuda, self.gs.triplane_splat_sorted_cuda = \
            self.real


def _stage1_batch_grads(torch, gs, bs, mode="pack", sampler=None):
    """One batched stage-1 joint step's loss and gradients (the B images'
    states), the launches and what the kernels were handed."""
    named = dict(_named_leaves(bs["state"]))
    for t in named.values():
        t.grad = None
    zero_counts(gs)
    with splat_route(mode), _recorder(gs, sampler) as rec:
        loss, aux = bs["proj"]._loss_batch(
            bs["state"], bs["t255"][:, 0], bs["feats"], bs["w_noise"],
            bs["draws"], targets_warp=bs["imgs"][:, 0])
        loss.backward()
    torch.cuda.synchronize()
    return (loss.item(), aux, {k: t.grad.clone() for k, t in named.items()},
            counts(gs), rec)


def _tune_batch_grads(torch, gs, bs, params_b, mode="pack", sampler=None):
    """One batched tuning step's per-image losses and gradients."""
    named = dict(_named_leaves(params_b))
    for t in named.values():
        t.grad = None
    zero_counts(gs)
    with splat_route(mode), _recorder(gs, sampler) as rec:
        losses, _ = bs["coach"]._loss_batch(params_b, bs["ws"], bs["cams"],
                                            bs["imgs"][:, 0],
                                            bs["tune_draws"])
        losses.sum().backward()
    torch.cuda.synchronize()
    return (losses.detach(), {k: t.grad.clone() for k, t in named.items()
                              if t.grad is not None}, counts(gs), rec)


def _lane_err(torch, batched, single, b, group):
    """Norm-wise error of image b's gradient of ``group`` in a batched
    step against a one-image step's, and the one-image gradient's norm."""
    got = torch.cat([t[b].flatten() for k, t in batched.items()
                     if k.split(".")[0] == group])
    want = _group_vec(torch, single, group)
    return _norm_err(got, want), want.norm().item()


def phase_batched_steps(torch, gs, G, params, bs):
    """17a-c: one batched stage-1 joint step and one batched tuning step
    at N = 4 through the kernels, again, through the plain sampler and
    under TGI_SPLAT=mxu (deterministic cuDNN, TF32 off), per group within
    STAGE1_GRAD_TOL and GRAD_TOL; image b of each against the one-image
    step on its own inputs and draws (BATCH_LANE_TOL); the launches of
    each step, one gather a render pass and one splat a backward pass at
    N = 4; and the gather, the fused splat and the sorted splat held
    against their plain versions on the inputs the batched steps handed
    them. Returns the errors, the launches and those inputs."""
    from tgi_torch.models.generator import stack_params, take_image
    proj, state = bs["proj"], bs["state"]
    M = G.cfg.neural_rendering_resolution ** 2
    out = {"stage1": {}, "tuning": {}}
    torch.backends.cudnn.deterministic = True
    try:
        loss, _, kernel, n_kernel, rec = _stage1_batch_grads(torch, gs, bs)
        _, _, again, _, _ = _stage1_batch_grads(torch, gs, bs)
        loss_p, _, plain, n_plain, _ = _stage1_batch_grads(
            torch, gs, bs, sampler=gs.sample_triplanes_plain)
        loss_m, _, mxu, n_mxu, rec_m = _stage1_batch_grads(torch, gs, bs,
                                                           "mxu")
        Ns = {p.shape[0] for p, _, _ in rec.gathers} | {
            a[0].shape[0] for a, _ in rec.splats}
        check(Ns == {BATCH}, f"the batched step's passes ran at N = {Ns}")
        check(n_kernel == {"triplane_gather": 4, "triplane_splat": 4,
                           "triplane_splat_sorted": 0,
                           "triplane_splat_keys": 0,
                           "triplane_splat_offsets": 0}
              and n_plain["triplane_gather"] == 0
              and n_mxu == {"triplane_gather": 4, "triplane_splat": 2,
                            "triplane_splat_sorted": 4,
                            "triplane_splat_keys": 4,
                            "triplane_splat_offsets": 4},
              f"batched stage-1 step launches {n_kernel}, plain {n_plain}, "
              f"mxu {n_mxu}: expected one gather a render pass and one "
              f"splat a backward pass at N = {BATCH}, as a one-image step")
        log(f"batched stage-1 step (N = {BATCH}): launches {n_kernel}, "
            f"TGI_SPLAT=mxu {n_mxu}; loss kernels {loss:.6g}, plain "
            f"{loss_p:.6g}, mxu {loss_m:.6g}")
        for group in ("w", "noise", "pose", "translation"):
            err, scale = _group_err(torch, kernel, plain, group)
            err2, _ = _group_err(torch, again, kernel, group)
            err_m, _ = _group_err(torch, mxu, kernel, group)
            log(f"batched stage-1 gradient of {group}: norm {scale:.4g}; "
                f"kernels vs plain {err:.3g}; kernels twice {err2:.3g}; "
                f"mxu vs default {err_m:.3g}")
            check(scale > 0 and err <= STAGE1_GRAD_TOL
                  and err_m <= STAGE1_GRAD_TOL,
                  f"batched stage 1, {group}: kernels vs plain {err}, mxu "
                  f"{err_m} > {STAGE1_GRAD_TOL}")
            out["stage1"][group] = {"kernels_vs_plain": err,
                                    "twice": err2, "mxu_vs_default": err_m}
        check(abs(loss - loss_p) <= 1e-5 * abs(loss_p),
              f"batched stage-1 loss {loss} vs plain {loss_p}")

        # b. each image against its one-image step.
        with torch.no_grad():
            _, aux = proj._loss_batch(state, bs["t255"][:, 0], bs["feats"],
                                      bs["w_noise"], bs["draws"],
                                      targets_warp=bs["imgs"][:, 0])
        per_image = (aux["dist"] + aux["warp"] + aux["noise_reg"]
                     * proj.cfg.regularize_noise_weight)
        groups = ("w", "noise", "pose", "translation")

        def one_image(b, move=0.0):
            """Image b's one-image step; ``move``: its w moved by that
            share of itself."""
            w = state["w"][b].detach() * (1 + move)
            one = {"w": w.clone().requires_grad_(True),
                   "noise": {k: v[b].detach().clone().requires_grad_(True)
                             for k, v in state["noise"].items()},
                   "translation": state["translation"][b].detach().clone()
                   .requires_grad_(True),
                   "pose": _map_detach(take_image(state["pose"], b))}
            for t in _leaves(one["pose"]):
                t.requires_grad_(True)
            l1, _ = proj._loss(one, bs["t255"][b], bs["feats"][b:b + 1],
                               bs["w_noise"][b],
                               draws=tuple(_lane_draws(d, b, M)
                                           for d in bs["draws"]),
                               target_warp=bs["imgs"][b])
            l1.backward()
            return l1.item(), {k: t.grad for k, t in _named_leaves(one)}

        lane = {}
        for b in range(BATCH):
            l1, single = one_image(b)
            _, moved = one_image(b, BATCH_LANE_MOVE)
            lane[b] = {"loss_rel": abs(per_image[b].item() - l1) / abs(l1)}
            for g in groups:
                lane[b][g] = _lane_err(torch, kernel, single, b, g)[0]
                lane[b][g + "_moved"] = _group_err(torch, moved, single,
                                                   g)[0]
        log(f"batched stage-1 step, image b vs its one-image step (and the "
            f"one-image step with w moved by {BATCH_LANE_MOVE} of itself, "
            f"'_moved'): {lane}")
        tol = {g: BATCH_CAMERA_TOL if g in ("pose", "translation")
               else BATCH_LANE_TOL for g in groups}
        check(all(v["loss_rel"] <= BATCH_LANE_LOSS_TOL and all(
            v[g] <= tol[g] for g in groups) for v in lane.values()),
              f"a batched stage-1 image parts from its one-image step: "
              f"{lane}")
        out["stage1"]["image_vs_one_image"] = lane
        out["stage1"]["launches"] = {"default": n_kernel, "mxu": n_mxu}

        # The tuning step: B generator copies.
        params_b = _map_detach(stack_params(params, BATCH))
        for t in _leaves(params_b):
            t.requires_grad_(True)
        tl, tk, tn, trec = _tune_batch_grads(torch, gs, bs, params_b)
        tl2, tk2, _, _ = _tune_batch_grads(torch, gs, bs, params_b)
        tlp, tp, tnp, _ = _tune_batch_grads(
            torch, gs, bs, params_b, sampler=gs.sample_triplanes_plain)
        tlm, tm, tnm, trec_m = _tune_batch_grads(torch, gs, bs, params_b,
                                                 "mxu")
        check(tn == {"triplane_gather": 2, "triplane_splat": 2,
                     "triplane_splat_sorted": 0, "triplane_splat_keys": 0,
                     "triplane_splat_offsets": 0}
              and tnp["triplane_gather"] == 0
              and tnm["triplane_gather"] == 2
              and tnm["triplane_splat_sorted"] == 2
              and tnm["triplane_splat"] == 0,
              f"batched tuning step launches {tn}, plain {tnp}, mxu {tnm}")
        check({p.shape[0] for p, _, _ in trec.gathers} == {BATCH},
              "the batched tuning step's passes did not run at N = 4")
        log(f"batched tuning step (N = {BATCH}): launches {tn}, mxu {tnm}; "
            f"losses kernels {tl.tolist()}, plain {tlp.tolist()}")
        check(((tl - tlp).abs() <= 1e-5 * tlp.abs()).all().item(),
              f"batched tuning losses {tl.tolist()} vs plain {tlp.tolist()}")
        for group in TUNE_GROUPS:
            err, scale = _group_err(torch, tk, tp, group)
            err2, _ = _group_err(torch, tk2, tk, group)
            err_m, _ = _group_err(torch, tm, tk, group)
            log(f"batched tuning gradient of {group}: norm {scale:.4g}; "
                f"kernels vs plain {err:.3g}; twice {err2:.3g}; mxu vs "
                f"default {err_m:.3g}")
            check(scale > 0 and err <= GRAD_TOL and err_m <= GRAD_TOL,
                  f"batched tuning, {group}: kernels vs plain {err}, mxu "
                  f"{err_m} > {GRAD_TOL}")
            out["tuning"][group] = {"kernels_vs_plain": err, "twice": err2,
                                    "mxu_vs_default": err_m}
        def one_tune(b, move=0.0):
            one = _map_detach(params)
            for t in _leaves(one):
                t.requires_grad_(True)
            l1, _ = bs["coach"]._loss(one, bs["ws"][b:b + 1] * (1 + move),
                                      bs["cams"][b:b + 1], bs["imgs"][b],
                                      **_lane_draws(bs["tune_draws"], b, M))
            l1.backward()
            return l1.item(), {k: t.grad for k, t in _named_leaves(one)
                               if t.grad is not None}

        lane = {}
        for b in range(BATCH):
            l1, single = one_tune(b)
            _, moved = one_tune(b, BATCH_LANE_MOVE)
            lane[b] = {"loss_rel": abs(tl[b].item() - l1) / abs(l1)}
            for g in TUNE_GROUPS:
                lane[b][g] = _lane_err(torch, tk, single, b, g)[0]
                lane[b][g + "_moved"] = _group_err(torch, moved, single,
                                                   g)[0]
        log(f"batched tuning step, image b vs its one-image step (and "
            f"'_moved'): {lane}")
        check(all(v["loss_rel"] <= BATCH_LANE_LOSS_TOL and all(
            v[g] <= BATCH_LANE_TOL for g in TUNE_GROUPS)
            for v in lane.values()),
              f"a batched tuning image parts from its one-image step: "
              f"{lane}")
        out["tuning"]["image_vs_one_image"] = lane
        out["tuning"]["launches"] = {"default": tn, "mxu": tnm}
    finally:
        torch.backends.cudnn.deterministic = False

    # The kernels against their plain versions on what the batched steps
    # handed them: every gather pass, every splat (with and without
    # d_coords), every sorted splat (N·3·M keys up to 4·3·786,432).
    with torch.no_grad():
        errs = _batched_kernels_vs_plain(torch, gs, rec, trec, rec_m,
                                         trec_m)
    out["kernels_vs_plain"] = errs
    out["n4_inputs"] = {"gather": trec.gathers[-1],
                        "splat": trec.splats[-1][0]}
    return out


def _batched_kernels_vs_plain(torch, gs, rec, trec, rec_m, trec_m):
    gerr = serr = srel = oerr = orel = 0.0
    for planes, coords, bw_ in rec.gathers + trec.gathers:
        got = gs.sample_triplanes_cuda(planes, coords, bw_)
        want = gs.sample_triplanes_plain(planes, coords, bw_)
        gerr = max(gerr, (got - want).abs().max().item())
    for args, kw in rec.splats + trec.splats:
        got = gs.triplane_splat_cuda(*args, **kw)
        want = gs.triplane_splat_plain(*args, **kw)
        for a, w in zip(got, want):
            if w is not None:
                e = (a - w).abs().max().item()
                scale = max(1.0, w.abs().max().item())
                serr, srel = max(serr, e), max(srel, e / scale)
    keys = 0
    for args in rec_m.sorted + trec_m.sorted:
        got = gs.triplane_splat_sorted_cuda(*args)
        want = gs.triplane_splat_sorted_plain(*args)
        e = (got - want).abs().max().item()
        oerr = max(oerr, e)
        orel = max(orel, e / max(1.0, want.abs().max().item()))
        keys = max(keys, args[0].shape[0] * 3 * args[0].shape[1])
    torch.cuda.synchronize()
    log(f"kernels vs plain on the batched steps' inputs (N = {BATCH}): "
        f"gather max abs err {gerr:.3g} over "
        f"{len(rec.gathers) + len(trec.gathers)} passes; splat {serr:.3g} "
        f"(relative {srel:.3g}) over {len(rec.splats) + len(trec.splats)}; "
        f"sorted splat {oerr:.3g} (relative {orel:.3g}) over "
        f"{len(rec_m.sorted) + len(trec_m.sorted)}, up to {keys} keys")
    check(gerr <= KERNEL_TOL, f"gather at N = {BATCH}: {gerr} > {KERNEL_TOL}")
    check(srel <= SPLAT_TOL and orel <= SPLAT_TOL,
          f"splat at N = {BATCH}: {srel}, sorted {orel} > {SPLAT_TOL}")
    check(keys == BATCH * 3 * 128 * 128 * 48,
          f"the sorted splat saw at most {keys} keys")
    return {"gather_max_abs_err": gerr, "splat_max_abs_err": serr,
            "splat_max_rel_err": srel, "sorted_max_abs_err": oerr,
            "sorted_max_rel_err": orel, "sorted_keys": keys}


def phase_batched_kernel_times(torch, gs, inputs, bw):
    """The gather and the fused splat per pass at N = 4 (the tuning
    step's fine pass) beside their plain versions, F.grid_sample /
    grid_sampler_2d_backward at N = 4 and the card's bound."""
    import torch.nn.functional as F
    planes, coords, bwarp = inputs["gather"]
    N, _, C, H, W = planes.shape
    M = coords.shape[1]
    nchw = planes.contiguous().reshape(N * 3, C, H, W)
    grid = gs.project_onto_planes((2.0 / bwarp) * coords).reshape(
        N * 3, 1, M, 2)
    nbytes = 4 * (N * 3 * C * H * W + N * M * 3 + N * 3 * M * C)
    out = {}
    for name, fn, plain, lib, flops in (
            ("triplane_gather",
             lambda: gs.sample_triplanes_cuda(planes, coords, bwarp),
             lambda: gs.sample_triplanes_plain(planes, coords, bwarp),
             lambda: F.grid_sample(nchw, grid, mode="bilinear",
                                   padding_mode="zeros",
                                   align_corners=False),
             N * 3 * M * (C * 9 + 20)),
            ("triplane_splat",) + _splat_fns(torch, gs, inputs["splat"])
            + (N * 3 * M * (8 * C + 20),)):
        t = cuda_ms(torch, fn, iters=10)
        tp = cuda_ms(torch, plain, iters=3, warmup=1)
        tl = cuda_ms(torch, lib, iters=10)
        bound = max(nbytes / bw, flops / FP32_FLOPS) * 1e3
        by = "bytes" if nbytes / bw >= flops / FP32_FLOPS else "operations"
        log(f"times at N = {N}, {name}, fine pass (M = {M}): kernel {t:.4f}"
            f" ms, plain {tp:.4f} ms, library {tl:.4f} ms, bound "
            f"{bound:.4f} ms ({by}: {nbytes / 1e6:.1f} MB at "
            f"{bw / 1e12:.2f} TB/s); share of the bound "
            f"{100 * bound / t:.1f} %, kernel / library {t / tl:.3f}")
        out[name] = {"ms": t, "plain_ms": tp, "library_ms": tl,
                     "bound_ms": bound, "bound_by": by}
    return out


def _splat_fns(torch, gs, args):
    """(kernel, plain, grid_sampler_2d_backward) on one splat's inputs,
    without d_coords."""
    planes_cl, coords, g, bwarp = args[:4]
    N, _, H, W, C = planes_cl.shape
    M = coords.shape[1]
    nchw = planes_cl.permute(0, 1, 4, 2, 3).reshape(N * 3, C, H,
                                                    W).contiguous()
    grid = gs.project_onto_planes((2.0 / bwarp) * coords).reshape(
        N * 3, 1, M, 2)
    g_lib = g.reshape(N * 3, M, C).permute(0, 2, 1).reshape(
        N * 3, C, 1, M).contiguous()
    return (lambda: gs.triplane_splat_cuda(planes_cl, coords, g, bwarp,
                                           False),
            lambda: gs.triplane_splat_plain(planes_cl, coords, g, bwarp,
                                            False),
            lambda: torch.ops.aten.grid_sampler_2d_backward(
                g_lib, nchw, grid, 0, 0, False, [True, False]))


def phase_batched_run_pti(torch, gs, G, params, bs, tmp):
    """17d: ``run_pti(batch=4)`` over 5 images (a chunk of 4 and a ragged
    one of 1) at BATCH_RUN_PTI_STEPS, with every count set to 0 before
    and read after: every image's pivots, tuned generator and results
    entry, each render pass at N = 4 or 1."""
    import numpy as np
    from tgi_torch.apps.run_pti import run_pti
    img_dir = os.path.join(tmp, "batch_images")
    out_dir = os.path.join(tmp, "batch_out")
    os.makedirs(img_dir, exist_ok=True)
    imgs, _ = batch_targets(torch, G, params, BATCH_RUN_PTI_IMAGES, seed=3)
    names = [f"img{i}" for i in range(BATCH_RUN_PTI_IMAGES)]
    for name, img in zip(names, imgs):
        np.save(os.path.join(img_dir, f"{name}.npy"), img[0].cpu().numpy())
    s1, s2 = BATCH_RUN_PTI_STEPS
    torch.cuda.synchronize()
    zero_counts(gs)
    t0 = time.perf_counter()
    with _recorder(gs, keep=False) as rec:
        results = run_pti(img_dir, out_dir, G=G, gen_params=params,
                          pose_params=bs["nets"][0], vgg_params=bs["vgg"],
                          lpips_head=bs["head"], first_inv_steps=s1,
                          max_pti_steps=s2, gen_video=False, batch=BATCH,
                          device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts(gs)
    Ns = sorted(set(rec.Ns))
    log(f"run_pti(batch={BATCH}) over {len(names)} images, {s1} + {s2} "
        f"steps: {wall:.1f} s, launches {launched}, render passes at N = "
        f"{Ns}; results {results}")
    check([r["image"] for r in results] == names,
          f"results for {[r['image'] for r in results]}")
    with open(os.path.join(out_dir, "results.json")) as f:
        check(json.load(f) == results, "results.json differs")
    for r in results:
        check(math.isfinite(r["final_lpips"]) and 0 <= r["pti_steps"] <= s2,
              f"entry {r}")
        ws = np.load(os.path.join(out_dir, f"{r['image']}_ws.npy"))
        cam = np.load(os.path.join(out_dir, f"{r['image']}_cam.npy"))
        check(ws.shape == (1, G.cfg.num_ws, G.cfg.w_dim)
              and cam.shape == (1, 25) and np.isfinite(ws).all()
              and np.isfinite(cam).all(), f"{r['image']}'s pivots")
        check(os.path.getsize(os.path.join(out_dir, f"{r['image']}_G.pt"))
              > 0, f"no {r['image']}_G.pt")
    check(Ns == [1, BATCH] and launched["triplane_gather"] > 0
          and launched["triplane_splat"] > 0,
          f"run_pti(batch={BATCH}) passes at N = {Ns}, launches {launched}")
    return {"wall_s": wall, "launches": launched, "results": results}


def phase_batched_step_times(torch, gs, G, params, bs, steps=2, warmup=1,
                             sizes=BATCH_TIMING_SIZES):
    """17e: ms per image of a stage-1 joint step and of a tuning step at
    B = 1, 2, 4 (``sizes``), with and without remat (CUDA events, median
    of ``steps`` after ``warmup``), and the peak memory each takes above
    what was allocated before it."""
    import dataclasses as dc
    from tgi_torch.invert.coach import (CoachConfig, MaskedAdam, PTICoach,
                                        render_draws)
    from tgi_torch.invert.projector import Projector
    from tgi_torch.models.generator import stack_params
    from tgi_torch.models.pose_resnet import stack_nets
    out = {}
    for B in sizes:
        for remat in (False, True):
            proj = Projector(G, params, bs["vgg"], bs["head"], bs["nets"][0],
                             dc.replace(bs["proj"].cfg, remat_render=remat))
            gens = [torch.Generator(device=DEVICE).manual_seed(50 + b)
                    for b in range(B)]
            t255, imgs = bs["t255"][:B, 0], bs["imgs"][:B, 0]
            feats = bs["feats"][:B]
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            state, opts, w_std = proj.init_state_batch(
                B, generators=gens, pose_params_b=stack_nets(bs["nets"][:B]))

            def s1_step():
                proj.step_batch(state, opts, bs["step"], w_std, t255, feats,
                                targets_warp=imgs, generators=gens)

            ms1 = cuda_ms(torch, s1_step, iters=steps, warmup=warmup)
            peak1 = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            del state, opts
            coach = PTICoach(G, bs["coach"].lpips,
                             CoachConfig(lpips_threshold=0.0, remat=remat))
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            params_b = _map_detach(stack_params(params, B))
            for t in _leaves(params_b):
                t.requires_grad_(True)
            opt = MaskedAdam(_leaves(params_b), 3e-4)

            def s2_step():
                losses, aux = coach._loss_batch(params_b, bs["ws"][:B],
                                                bs["cams"][:B], imgs,
                                                render_draws(G, gens, DEVICE))
                aux["lpips"].tolist()      # the threshold's read-back
                opt.zero_grad()
                losses.sum().backward()
                opt.step([True] * B)

            ms2 = cuda_ms(torch, s2_step, iters=steps, warmup=warmup)
            peak2 = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            del params_b, opt
            key = f"B{B}{'_remat' if remat else ''}"
            out[key] = {"stage1_ms_per_image": ms1 / B,
                        "tuning_ms_per_image": ms2 / B,
                        "stage1_step_ms": ms1, "tuning_step_ms": ms2,
                        "stage1_peak_gib": peak1, "tuning_peak_gib": peak2}
            log(f"batched step times {key}: stage 1 {ms1:.1f} ms a step "
                f"({ms1 / B:.1f} a image), peak +{peak1:.2f} GiB; tuning "
                f"{ms2:.1f} ms ({ms2 / B:.1f} a image), peak +{peak2:.2f} "
                f"GiB")
    return out


def phase_batched_gate(gate):
    """17f: the batched gate phase 12 ran beside the single one (same
    bootstrapped nets, seed and budget): every image finite, its final
    MSE at most 1.05 x its pivot's, the aimed nets 3 degrees off; image 0
    against the single gate; the launches: one gather a render pass and
    one splat a backward pass at N = 4, each render's forward run twice
    under remat."""
    qb, q = gate["batch_gate"], gate["gate"]
    per = qb["per_image"]
    log(f"batched gate (B = {BATCH}, {GATE_STAGE1} + {GATE_STAGE2} steps): "
        f"{per}; mean final MS-SSIM {qb['mean_final_ms_ssim']:.4f}; "
        f"seconds a image {qb['seconds_per_image']:.2f} (single gate "
        f"{gate['seconds']['per_image']:.2f}); image 0 final MS-SSIM "
        f"{per[0]['final_ms_ssim']:.4f} vs the single gate's "
        f"{q['final_ms_ssim']:.4f}; launches {gate['launches']['batch_gate']}")
    for p in per:
        check(all(math.isfinite(v) for v in p.values()), f"batched gate {p}")
        check(p["final_mse"] <= 1.05 * p["pivot_mse"],
              f"batched gate: final MSE {p['final_mse']} vs pivot "
              f"{p['pivot_mse']}")
        check(abs(p["init_pose_err_deg"] - 3.0) < 0.1
              and p["pti_steps"] == GATE_STAGE2, f"batched gate {p}")
    check(abs(per[0]["final_ms_ssim"] - q["final_ms_ssim"]) <= 0.01,
          "the batched gate's image 0 parts from the single gate")
    s1, s2 = GATE_STAGE1, GATE_STAGE2
    want = {"triplane_gather": 2 * BATCH + 8 * s1 + 4 * s2 + 4 * BATCH,
            "triplane_splat": 4 * s1 + 2 * s2, "triplane_splat_sorted": 0}
    check(gate["launches"]["batch_gate"] == want,
          f"batched gate launches {gate['launches']['batch_gate']}, "
          f"expected {want}")
    return {k: v for k, v in qb.items()}


def phase_batched(torch, gs, gate, tmp, bw):
    """Phase 17, batched inversion on the gate's generator: a-c
    ``phase_batched_steps``, the kernels' times at N = 4, d
    ``phase_batched_run_pti``, e ``phase_batched_step_times``, f
    ``phase_batched_gate``."""
    from tgi_torch.scripts import selfinv_gate
    t0 = time.perf_counter()
    G, params = selfinv_gate.full_width_generator(
        DEVICE, seed=selfinv_gate.GENERATOR_SEED)
    bs = batch_setup(torch, G, params)
    steps = phase_batched_steps(torch, gs, G, params, bs)
    with torch.no_grad():
        times = phase_batched_kernel_times(torch, gs,
                                           steps.pop("n4_inputs"), bw)
    run = phase_batched_run_pti(torch, gs, G, params, bs, tmp)
    step_times = phase_batched_step_times(torch, gs, G, params, bs)
    gate_b = phase_batched_gate(gate)
    seconds = time.perf_counter() - t0
    log(f"phase 17 (batched inversion) in {seconds:.1f} s")
    return {"steps": steps, "kernel_times_n4": times, "run_pti": run,
            "step_times": step_times, "gate": gate_b, "seconds": seconds}


# Phase 18: the last modules. The mesh: data-parallel training over the
# one card's process group and the ray split; CLIP and its loss; the
# visualizer.
MESH_STEPS = 2             # training_loop steps with and without the mesh
CLIP_BATCH = 4             # images and prompts of the card-vs-CPU check
CLIP_CONTEXT = 77          # tokens a prompt
# ViT-B/32 logits, card vs CPU (fp32, TF32 off): of the largest |logit|.
CLIP_CPU_TOL = 1e-4
VIZ_FRAMES = 4             # frames timed with the plane cache hit, missed
CLIP_PROMPTS = ("a photo of a face", "a smiling woman with red hair",
                "an old man with a grey beard, wearing glasses",
                "a child laughing at the camera")


def _merges_file(tmp):
    """A small BPE merges file (the published one cannot be fetched):
    merges of the prompts' commonest pairs, in the published format."""
    path = os.path.join(tmp, "merges.txt")
    lines = ["#version: small", "t h", "th e</w>", "a n", "i n", "e r",
             "a r", "o r", "e n", "r e", "s m", "sm i", "l i", "n g</w>",
             "f a", "fa c", "fac e</w>", "h a", "i r</w>", "g l", "gl a"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _init_group(torch, tmp):
    """A process group of world size 1 on NCCL, its store a file in
    ``tmp``."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method="file://" + os.path.join(tmp, "nccl_store"),
        rank=0, world_size=1)
    return dist


def _group_norm_err(torch, a, b, paths, group):
    """||a - b||_2 / ||b||_2 over the gradients whose path starts with
    ``group`` (every one for None)."""
    sel = [i for i, p in enumerate(paths) if group is None
           or p[0] == group]
    da = torch.cat([(a[i] - b[i]).reshape(-1) for i in sel])
    nb = torch.cat([b[i].reshape(-1) for i in sel])
    return (da.norm() / nb.norm()).item()


def _step_diffs(torch, a, b, g_paths, d_paths):
    """Per step of two training runs: the metrics' largest relative
    difference, and the applied gradients' per-group norm errors (G:
    mapping, backbone, decoder, SR; D whole)."""
    out = []
    for step, (ra, rb) in enumerate(zip(a["records"], b["records"])):
        m = max(abs(ra["metrics"][k] - rb["metrics"][k])
                / max(1.0, abs(rb["metrics"][k])) for k in rb["metrics"])
        grads = {}
        for phase, paths, groups in (
                (0, g_paths, ("mapping", "backbone", "decoder",
                              "superresolution")), (1, d_paths, (None,))):
            ga, gb = a["grads"][2 * step + phase], b["grads"][2 * step + phase]
            for group in groups:
                grads[group or "D"] = _group_norm_err(torch, ga, gb, paths,
                                                      group)
        out.append({"metrics": m, "grads": grads})
    return out


def phase_mesh_training(torch, gs, tmp):
    """a. ``training_loop(mesh=make_mesh())`` over a process group of
    world size 1 on NCCL against ``mesh=None`` (twice), each MESH_STEPS
    steps of phase 14's configuration from seed 0 on phase 14's dataset
    (R1 and the density regulariser on the first step). On one rank every
    collective runs and moves nothing: this shows the code path on
    the card, not a speed-up. Only step 0's G phase has the same inputs
    in every run: two unsharded runs on the card part after the first
    Adam update (the splat's and cuDNN's atomics, the augment pipe's
    ``grid_sample`` backward, and Adam's first step of b1 = 0 moving
    every weight by about lr whatever the size of its gradient). So step
    0's G phase is held to phase 14's tolerances (g_loss and g_reg
    within TRAIN_CPU_TOL relative, the applied gradients per group
    within BF16_GRAD_TOL of the norm) and step 0's d_loss within
    BF16_GRAD_TOL relative; every later difference is logged beside the
    unsharded run's against its repeat."""
    from tgi_torch.apps.train_gan import training_configs
    from tgi_torch.parallel import make_mesh
    from tgi_torch.train import gan
    from tgi_torch.train.loop import training_loop
    G, d_cfg, cfg = training_configs(batch_size=TRAIN_BATCH)
    kimg = MESH_STEPS * TRAIN_BATCH / 1000
    common = dict(G=G, d_cfg=d_cfg, data_path=os.path.join(tmp, "train_data"),
                  cfg=cfg, total_kimg=kimg, kimg_per_tick=kimg,
                  snapshot_ticks=0, image_snapshot_ticks=0, augment_p=0.2,
                  seed=0, device=DEVICE)
    dist = _init_group(torch, tmp)
    runs = {}
    real_apply = gan._apply
    try:
        mesh = make_mesh()
        check(mesh.shape == {"data": 1, "rays": 1} and mesh.group is not None,
              f"make_mesh() in a group of one: {mesh}")
        for name, m in (("mesh", mesh), ("no_mesh", None),
                        ("no_mesh_again", None)):
            applied = []

            def record(opt, params, grads):
                applied.append([gan._sanitize(g).detach().clone()
                                for g in grads])
                return real_apply(opt, params, grads)

            gan._apply = record
            zero_counts(gs)
            with step_recorder(torch, gs) as records:
                state = training_loop(
                    mesh=m, run_dir=os.path.join(tmp, f"mesh_run_{name}"),
                    **common)
            gan._apply = real_apply
            runs[name] = dict(records=list(records), grads=applied,
                              launches=counts(gs))
            paths = {k: [p for p, _ in gan._leaves(state[k])]
                     for k in ("g_params", "d_params")}
            del state
    finally:
        gan._apply = real_apply
        dist.destroy_process_group()
    a, b = runs["mesh"], runs["no_mesh"]
    for name, r in runs.items():
        for i, rec in enumerate(r["records"]):
            log(f"  {name} step {i}: greg {rec['greg']} R1 {rec['r1']}: "
                f"{rec['ms']:.1f} ms, {rec['gathers']} gathers, "
                f"{rec['splats']} splats, {rec['collectives']} collectives, "
                f"{rec['metrics']}")
    check(all(len(r["records"]) == MESH_STEPS for r in runs.values()),
          "a run took another number of steps")
    check(all(r["collectives"] > 0 for r in a["records"])
          and all(r["collectives"] == 0 for n, run in runs.items()
                  if n != "mesh" for r in run["records"]),
          "collectives: the mesh's steps run them, the others none")
    for ra, rb in zip(a["records"], b["records"]):
        want = STEP_LAUNCHES["greg" if rb["greg"] else "plain"]
        check((ra["gathers"], ra["splats"]) == (rb["gathers"], rb["splats"])
              == want, f"launches {ra['gathers']}, {ra['splats']} with the "
              f"mesh, {rb['gathers']}, {rb['splats']} without; expected "
              f"{want}")
        check(all(math.isfinite(v) for v in ra["metrics"].values()),
              f"a loss with the mesh is not finite: {ra['metrics']}")
    diffs = _step_diffs(torch, a, b, paths["g_params"], paths["d_params"])
    spread = _step_diffs(torch, runs["no_mesh_again"], b, paths["g_params"],
                         paths["d_params"])
    for step, (d, s) in enumerate(zip(diffs, spread)):
        log(f"  step {step}: mesh vs no mesh: metrics {d['metrics']:.3g}, "
            f"gradient norm errors {d['grads']}; no mesh vs its repeat: "
            f"metrics {s['metrics']:.3g}, {s['grads']}")
    m0, r0 = a["records"][0]["metrics"], b["records"][0]["metrics"]
    for k, tol in (("g_loss", TRAIN_CPU_TOL), ("g_reg", TRAIN_CPU_TOL),
                   ("d_loss", BF16_GRAD_TOL)):
        check(abs(m0[k] - r0[k]) <= tol * max(1.0, abs(r0[k])),
              f"step 0 {k} with vs without the mesh {m0[k]} vs {r0[k]}")
    g0 = {k: v for k, v in diffs[0]["grads"].items() if k != "D"}
    check(max(g0.values()) <= BF16_GRAD_TOL, f"step 0's G phase gradients "
          f"with vs without the mesh {g0} > {BF16_GRAD_TOL}")
    per_step = [r["collectives"] for r in a["records"]]
    log(f"collectives a step (world size 1: they move nothing; the code "
        f"path on the card, not a speed-up): {per_step}")
    return {"collectives_per_step": per_step,
            "step_ms_mesh": [r["ms"] for r in a["records"]],
            "step_ms_no_mesh": [r["ms"] for r in b["records"]],
            "step_ms_no_mesh_again": [r["ms"] for r in
                                      runs["no_mesh_again"]["records"]],
            "launches": a["launches"], "mesh_vs_no_mesh": diffs,
            "no_mesh_vs_repeat": spread}


def phase_ray_split(torch, gs, G, params):
    """b. ``synthesis`` at full width under ``ray_constrained`` of a mesh
    that names the card twice (rays = 2) against the unsharded render:
    the image, image_raw and depth within SWAP_TOL; one backward of a
    fixed scalar loss to ws with deterministic cuDNN within GRAD_TOL of
    the norm; the gather once per shard per pass (4 a render), the splat
    once per shard per backward pass (4); the forward of each timed."""
    import tgi_torch.render.renderer as renderer
    from tgi_torch.apps.gen_samples import seed_z
    from tgi_torch.parallel import make_mesh, ray_constrained
    mesh = make_mesh(devices=[DEVICE + ":0"] * 2, rays=2)
    check(mesh.shape == {"data": 1, "rays": 2}, f"ray mesh {mesh.shape}")
    with torch.no_grad():
        ws0 = G.mapping(params, seed_z(0, G.cfg.z_dim, DEVICE),
                        _camera(torch, 0.0), truncation_psi=0.7,
                        truncation_cutoff=14)
    cam = _camera(torch, 0.3)
    weights = [w.to(DEVICE) for w in _loss_weights(torch, G)]

    def run(split):
        ws = ws0.clone().requires_grad_(True)
        zero_counts(gs)
        with ray_constrained(mesh) if split else contextlib.nullcontext():
            out = G.synthesis(params, ws, cam, det=True)
            fwd = (gs.LAUNCHES, gs.SPLAT_LAUNCHES)
            _scalar_loss(out, weights).backward()
        torch.cuda.synchronize()
        return ({k: out[k].detach() for k in ("image", "image_raw",
                                              "image_depth")},
                ws.grad, fwd, (gs.LAUNCHES, gs.SPLAT_LAUNCHES))

    check(renderer.sample_triplanes is gs.sample_triplanes,
          "the renderer does not sample through the kernels")
    torch.backends.cudnn.deterministic = True
    try:
        whole, g_whole, fwd_w, all_w = run(False)
        split, g_split, fwd_s, all_s = run(True)
    finally:
        torch.backends.cudnn.deterministic = False
    errs = {k: (split[k] - whole[k]).abs().max().item() for k in whole}
    g_err = _norm_err(g_split, g_whole)
    log(f"ray split (2 shards on one card) vs unsharded render: max abs "
        f"{errs}; gradient to ws norm err {g_err:.3g}; launches (gather, "
        f"splat) forward {fwd_s} vs {fwd_w}, with the backward {all_s} vs "
        f"{all_w}")
    check(all(e <= SWAP_TOL for e in errs.values()),
          f"ray split vs unsharded render {errs} > {SWAP_TOL}")
    check(g_err <= GRAD_TOL, f"ray split gradient {g_err} > {GRAD_TOL}")
    check(fwd_w == (2, 0) and fwd_s == (4, 0) and all_w == (2, 2)
          and all_s == (4, 4), f"launches split {fwd_s}, {all_s}, whole "
          f"{fwd_w}, {all_w}")
    with torch.no_grad():
        ms_whole = cuda_ms(torch, lambda: G.synthesis(params, ws0, cam,
                                                      det=True), iters=10)
        with ray_constrained(mesh):
            ms_split = cuda_ms(torch, lambda: G.synthesis(
                params, ws0, cam, det=True), iters=10)
    log(f"512² render forward (CUDA events, median of 10): unsharded "
        f"{ms_whole:.2f} ms, split in 2 on one card {ms_split:.2f} ms")
    return {"max_abs_err": errs, "grad_norm_err": g_err,
            "launches_forward": fwd_s[0], "launches_backward": all_s[1],
            "render_ms_unsharded": ms_whole, "render_ms_split2": ms_split}


def phase_clip(torch, gs, G, params, tmp):
    """c. CLIP ViT-B/32 with drawn weights (seed 9), fp32, TF32 off: (1)
    ``clip_apply`` on the card against its CPU run at batch CLIP_BATCH,
    224² pixels and CLIP_CONTEXT-token prompts from the BPE tokenizer on
    a small merges file, logits within CLIP_CPU_TOL of the largest; (2)
    ``clip_loss`` of a 512² render against a prompt, its gradient to ws
    through the gather and the splat against the plain sampler with
    deterministic cuDNN (the loss within SWAP_TOL, the gradient within
    GRAD_TOL of the norm), 2 gathers and 2 splats; (3) the times of
    ``clip_apply`` at batch 4, and of the loss from ws forward and
    forward + backward (CUDA events)."""
    import tgi_torch.render.renderer as renderer
    from tgi_torch.apps.gen_samples import seed_z
    from tgi_torch.losses import clip_loss
    from tgi_torch.models import clip
    cfg = clip.ClipConfig()
    cp_cpu = clip.clip_init(torch.Generator().manual_seed(9), cfg,
                            device="cpu")
    cp = _to(cp_cpu, DEVICE)
    tok = clip.SimpleTokenizer(_merges_file(tmp))
    ids = tok.tokenize(list(CLIP_PROMPTS), context_length=CLIP_CONTEXT)
    check(tuple(ids.shape) == (CLIP_BATCH, CLIP_CONTEXT)
          and int(ids.max()) == tok.encoder["<|endoftext|>"],
          f"tokens {tuple(ids.shape)}, max id {int(ids.max())}")
    px = torch.rand(CLIP_BATCH, 3, 224, 224,
                    generator=torch.Generator().manual_seed(10)) * 2 - 1
    with torch.no_grad():
        card = clip.clip_apply(cp, px.to(DEVICE), ids.to(DEVICE), cfg)[0]
        cpu = clip.clip_apply(cp_cpu, px, ids, cfg)[0]
    c_err = _rel_err(card.cpu(), cpu)
    log(f"CLIP ViT-B/32 card vs CPU at batch {CLIP_BATCH}: logits "
        f"{cpu.flatten()[:4].tolist()}..., worst element {c_err:.3g} of "
        f"the largest")
    check(math.isfinite(c_err) and c_err <= CLIP_CPU_TOL,
          f"CLIP card vs CPU {c_err} > {CLIP_CPU_TOL}")
    with torch.no_grad():
        ws0 = G.mapping(params, seed_z(1, G.cfg.z_dim, DEVICE),
                        _camera(torch, 0.0), truncation_psi=0.7,
                        truncation_cutoff=14)
    cam = _camera(torch, -0.2)
    prompt = ids[:1].to(DEVICE)

    def loss_grad(sampler):
        renderer.sample_triplanes = sampler
        try:
            ws = ws0.clone().requires_grad_(True)
            loss = clip_loss(cp, G.synthesis(params, ws, cam,
                                             det=True)["image"], prompt, cfg)
            loss.sum().backward()
            torch.cuda.synchronize()
            return loss.detach(), ws.grad
        finally:
            renderer.sample_triplanes = gs.sample_triplanes

    torch.backends.cudnn.deterministic = True
    try:
        zero_counts(gs)
        k_loss, k_grad = loss_grad(gs.sample_triplanes)
        launches = (gs.LAUNCHES, gs.SPLAT_LAUNCHES)
        p_loss, p_grad = loss_grad(gs.sample_triplanes_plain)
        check((gs.LAUNCHES, gs.SPLAT_LAUNCHES) == launches,
              "the plain sampler launched a kernel")
    finally:
        torch.backends.cudnn.deterministic = False
    l_err = (k_loss - p_loss).abs().max().item()
    g_err = _norm_err(k_grad, p_grad)
    log(f"clip_loss of a 512² render: {k_loss.item():.6g} (plain "
        f"{p_loss.item():.6g}); gradient to ws max |g| "
        f"{k_grad.abs().max().item():.4g}, kernels vs plain norm err "
        f"{g_err:.3g}; launches (gather, splat) {launches}")
    check(l_err <= SWAP_TOL, f"clip_loss kernels vs plain {l_err}")
    check(k_grad.abs().max().item() > 0 and g_err <= GRAD_TOL,
          f"clip_loss gradient kernels vs plain {g_err} > {GRAD_TOL}")
    check(launches == (2, 2), f"(gather, splat) {launches}, expected (2, 2)")
    ws_t = ws0.clone().requires_grad_(True)

    def fwd_bwd():
        clip_loss(cp, G.synthesis(params, ws_t, cam, det=True)["image"],
                  prompt, cfg).sum().backward()

    with torch.no_grad():
        apply_ms = cuda_ms(torch, lambda: clip.clip_apply(
            cp, px.to(DEVICE), ids.to(DEVICE), cfg), iters=10)
        fwd_ms = cuda_ms(torch, lambda: clip_loss(
            cp, G.synthesis(params, ws0, cam, det=True)["image"], prompt,
            cfg), iters=10)
    fb_ms = cuda_ms(torch, fwd_bwd, iters=10)
    log(f"CUDA events, median of 10: clip_apply at batch {CLIP_BATCH} "
        f"{apply_ms:.2f} ms; the CLIP loss of a 512² render from ws "
        f"forward {fwd_ms:.2f} ms, forward + backward {fb_ms:.2f} ms")
    return {"card_vs_cpu_rel_err": c_err, "loss_err": l_err,
            "grad_norm_err": g_err, "launches": launches,
            "clip_apply_ms_b4": apply_ms, "loss_fwd_ms": fwd_ms,
            "loss_fwd_bwd_ms": fb_ms}


def phase_visualizer(torch, gs, G, params, tmp):
    """d. ``VisualizerState`` on the seed-0 full-width generator served on
    127.0.0.1 in a thread: GET /, /render (image at mult 1 and 2,
    image_depth, planes, style mixing), /stats and /capture (into
    ``tmp``); the PNG sizes, one served frame equal to the direct call's
    (deterministic cuDNN; within one level of 255, a value that rounds
    on a half level), the captured file likewise; 2 gathers a rendered
    frame (none
    for the planes view); then ms a frame (host clock; the frame comes
    back to the host) with the plane cache hit (camera moves) and missed
    (new seeds), VIZ_FRAMES each."""
    import io
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    from PIL import Image
    from tgi_torch.apps.visualizer import (VisualizerState, make_handler,
                                           render_kwargs)
    from tgi_torch.utils.image import to_uint8
    state = VisualizerState(G, params, capture_dir=os.path.join(tmp, "shots"))
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    img, rays, planes = (G.cfg.img_resolution,
                         G.cfg.neural_rendering_resolution,
                         G.cfg.backbone_resolution)
    queries = (("seed=1&mult=1&yaw=0.2", img), ("seed=1&mult=2", img),
               ("seed=1&mult=2&rtype=image_depth", rays),
               ("seed=1&mult=2&rtype=planes&layerch=37", planes),
               ("seed=1&mult=2&mixseed=3&mixlayer=7&pitch=0.1", img))
    # Deterministic cuDNN algorithms while frames are compared: cuDNN's
    # default backbone forward does not repeat bit for bit (PERF.md §7).
    torch.backends.cudnn.deterministic = True
    zero_counts(gs)
    try:
        html = urllib.request.urlopen(base + "/", timeout=120).read().decode()
        check("stylemix" in html and "cond yaw" in html, "the page")
        frames = []
        for q, size in queries:
            png = urllib.request.urlopen(f"{base}/render?{q}",
                                         timeout=300).read()
            img = np.asarray(Image.open(io.BytesIO(png)))
            check(img.shape == (size, size, 3), f"/render?{q}: {img.shape}")
            frames.append(img)
        launches = (gs.LAUNCHES, gs.SPLAT_LAUNCHES)
        stats = json.loads(urllib.request.urlopen(base + "/stats",
                                                  timeout=60).read())
        cap = json.loads(urllib.request.urlopen(
            f"{base}/capture?{queries[0][0]}", timeout=300).read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "the server thread did not stop")
    try:
        direct = to_uint8(state.render(**render_kwargs(
            {k: [v] for k, v in (p.split("=")
                                 for p in queries[0][0].split("&"))})))
    finally:
        torch.backends.cudnn.deterministic = False
    captured = np.asarray(Image.open(cap["path"]))
    diff = {name: int(np.abs(f.astype(int) - direct).max())
            for name, f in (("served", frames[0]), ("captured", captured))}
    log(f"visualizer: {len(queries)} frames served, stats {stats}, launches "
        f"(gather, splat) {launches}; served and captured frames against "
        f"the direct call, max |Δ| in levels of 255: {diff}")
    check(stats["frames"] == len(queries) and stats["avg_ms"] > 0,
          f"stats {stats}")
    check(launches == (2 * (len(queries) - 1), 0),
          f"(gather, splat) {launches} for {len(queries) - 1} rendered "
          f"frames and one planes view")
    check(max(diff.values()) <= 1, f"a served or captured frame differs "
          f"from the direct call by more than one level: {diff}")
    check(all(f.std() > 0 for f in frames), "a served frame is flat")

    def frame_ms(kws):
        out = []
        for kw in kws:
            t0 = time.perf_counter()
            state.render(**kw)
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    state.render(seed=20)
    hit = frame_ms([dict(seed=20, yaw=0.05 * i) for i in range(VIZ_FRAMES)])
    miss = frame_ms([dict(seed=21 + i) for i in range(VIZ_FRAMES)])
    log(f"visualizer ms a frame at mult 2 (96 + 96 samples), median of "
        f"{VIZ_FRAMES}, host clock: plane cache hit {hit:.1f}, missed "
        f"{miss:.1f}")
    return {"frames": len(queries), "launches": launches,
            "frame_ms_cache_hit": hit, "frame_ms_cache_miss": miss}


def phase_last_modules(torch, gs, G, params, tmp):
    """Phase 18: a ``phase_mesh_training``, b ``phase_ray_split``, c
    ``phase_clip``, d ``phase_visualizer``."""
    t0 = time.perf_counter()
    out = {"mesh_training": phase_mesh_training(torch, gs, tmp),
           "ray_split": phase_ray_split(torch, gs, G, params),
           "clip": phase_clip(torch, gs, G, params, tmp),
           "visualizer": phase_visualizer(torch, gs, G, params, tmp)}
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 18 (mesh, ray split, CLIP, visualizer) in "
        f"{out['seconds']:.1f} s")
    return out


# Phase 19: the last refusals. Managed training snapshots (the
# counterpart of tgi's orbax backend) at phase 14's configuration, and
# density noise with random SR noise through batched inversion.
SNAPSHOT_TICKS = 4         # ticks of 19a's first run
SNAPSHOT_TICK_STEPS = 2    # training steps a tick
SNAPSHOT_KEEP = 2          # training_loop's snapshot_keep
NOISE_OPTIONS = dict(density_noise=1.0, superresolution_noise_mode="random")


class save_recorder:
    """Inside the block, every ``SnapshotManager.save`` records its
    step, the seconds it waited for the save before it and the seconds
    it then held the caller (the copy to host memory), and keeps a CPU
    copy of the last state it was handed, taken when it returned."""

    def __init__(self):
        self.saves, self.last = [], None

    def __enter__(self):
        from tgi_torch.io.orbax_io import SnapshotManager
        self.real = real = SnapshotManager.save
        rec = self

        def save(manager, step, state):
            t0 = time.perf_counter()
            manager.wait_until_finished()
            t1 = time.perf_counter()
            out = real(manager, step, state)
            t2 = time.perf_counter()
            rec.saves.append({"step": step, "wait_s": t1 - t0,
                              "copy_s": t2 - t1})
            rec.last = (step, {k: t.detach().cpu().clone() for k, t in
                               _named_leaves(state["params"])})
            return out

        SnapshotManager.save = save
        return self

    def __exit__(self, *exc):
        from tgi_torch.io.orbax_io import SnapshotManager
        SnapshotManager.save = self.real


def phase_snapshots(torch, gs, tmp):
    """19a: ``train_gan`` at phase 14's configuration on phase 14's
    dataset with ``checkpoint_backend="orbax"``, ``snapshot_keep=2`` and
    a snapshot every tick of SNAPSHOT_TICK_STEPS steps, for
    SNAPSHOT_TICKS ticks: two finished steps kept, the newest with the
    loop's cur_nimg, restored bit for bit against the host copy taken
    when it was saved; then a resume from the run's snapshots (a
    left-over temporary step beside them) for one more tick, which
    starts at that cur_nimg, writes a later step and keeps two. Every
    count is set to 0 before the two runs and read after them; each step
    launches phase 14's gathers and splats. Logged: the bytes of a
    snapshot, the seconds the loop was held for each async save beside a
    synchronous save of the same state, and the seconds of a restore."""
    import shutil
    from tgi_torch.apps.train_gan import train_gan
    from tgi_torch.io.orbax_io import STATE_FILE, make_manager, restore_latest
    from tgi_torch.train.gan import train_state_tree
    t_phase = time.perf_counter()
    data = os.path.join(tmp, "train_data")
    run = os.path.join(tmp, "snapshot_run")
    snaps = os.path.join(run, "snapshots")
    tick = SNAPSHOT_TICK_STEPS * TRAIN_BATCH
    common = dict(batch_size=TRAIN_BATCH, kimg_per_tick=tick / 1000,
                  snapshot_ticks=1, image_snapshot_ticks=0, augment_p=0.2,
                  seed=0, checkpoint_backend="orbax",
                  snapshot_keep=SNAPSHOT_KEEP)
    zero_counts(gs)
    with step_recorder(torch, gs) as records, save_recorder() as saved:
        state = train_gan(data, run, total_kimg=SNAPSHOT_TICKS * tick / 1000,
                          **common)
        first = len(records)
        steps = make_manager(snaps).all_steps()
        last_step, host = saved.last
        t0 = time.perf_counter()
        data_r, step = restore_latest(make_manager(snaps),
                                      {"params": train_state_tree(state)})
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restored_cur = data_r["cur_nimg"]
        nbytes = os.path.getsize(os.path.join(snaps, str(step), STATE_FILE))
        restored = dict(_named_leaves(data_r["params"]))
        live = dict(_named_leaves(train_state_tree(state)))
        bitwise = (restored.keys() == host.keys() == live.keys() and all(
            torch.equal(restored[k].cpu(), host[k])
            and torch.equal(live[k].cpu(), host[k]) for k in host))
        # A synchronous save of the same state, for the async one's cost.
        sync = make_manager(os.path.join(tmp, "sync_snapshot"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saved.real(sync, step, {"params": train_state_tree(state),
                                "cur_nimg": step})     # not recorded
        sync.wait_until_finished()
        sync_s = time.perf_counter() - t0
        shutil.rmtree(sync.directory)
        del data_r, restored, live, host, state
        stray = os.path.join(snaps, f"{SNAPSHOT_TICKS * tick * 2}.tmp-0")
        os.makedirs(stray)
        train_gan(data, run, resume_ckpt=snaps,
                  total_kimg=(SNAPSHOT_TICKS + 1) * tick / 1000, **common)
    torch.cuda.synchronize()
    launches = counts(gs)
    after = make_manager(snaps).all_steps()
    end = SNAPSHOT_TICKS * tick
    async_s = [r["wait_s"] + r["copy_s"] for r in saved.saves]
    log(f"snapshots: steps {steps} after {first} steps ({SNAPSHOT_TICKS} "
        f"ticks), {after} after the resumed tick (a temporary step "
        f"{os.path.basename(stray)} beside them); the newest "
        f"{nbytes} bytes; restore {restore_s:.3f} s (to the card); a save "
        f"held the loop {[round(x, 4) for x in async_s]} s (waiting for "
        f"the save before it {[round(r['wait_s'], 4) for r in saved.saves]}"
        f", copying to host memory "
        f"{[round(r['copy_s'], 4) for r in saved.saves]}) beside "
        f"{sync_s:.3f} s for a synchronous save of the same state; "
        f"launches {launches}")
    for i, r in enumerate(records):
        log(f"  step {i}: cur_nimg {r['cur_nimg']} greg {r['greg']} R1 "
            f"{r['r1']}: {r['ms']:.1f} ms, {r['gathers']} gathers, "
            f"{r['splats']} splats")
    check(first == SNAPSHOT_TICKS * SNAPSHOT_TICK_STEPS
          and len(records) == first + SNAPSHOT_TICK_STEPS,
          f"{first} steps, then {len(records) - first}")
    check(steps == [end - tick, end] and step == last_step == end
          and restored_cur == end,
          f"kept steps {steps}, newest {step} (cur_nimg {restored_cur}), "
          f"last saved {last_step}; expected [{end - tick}, {end}] and "
          f"cur_nimg {end}")
    check(bitwise, "the restored snapshot is not the state saved, bit for "
          "bit")
    check(records[first]["cur_nimg"] == end,
          f"the resumed run started at cur_nimg "
          f"{records[first]['cur_nimg']}, not the newest step's {end}")
    check(after == [end, end + tick] and os.path.isdir(stray),
          f"after the resume the kept steps are {after}")
    for i, r in enumerate(records):
        want = STEP_LAUNCHES["greg" if r["greg"] else "plain"]
        check((r["gathers"], r["splats"]) == want
              and all(math.isfinite(v) for v in r["metrics"].values()),
              f"step {i}: {r['gathers']} gathers and {r['splats']} splats "
              f"(expected {want}), metrics {r['metrics']}")
    check(launches["triplane_gather"] == sum(r["gathers"] for r in records)
          and launches["triplane_splat"] == sum(r["splats"] for r in records)
          and launches["triplane_splat_sorted"] == 0,
          f"launches {launches}")
    return {"steps_kept": steps, "steps_kept_after_resume": after,
            "snapshot_bytes": nbytes, "restore_s": restore_s,
            "async_save_held_s": async_s,
            "async_save_wait_s": [r["wait_s"] for r in saved.saves],
            "async_save_copy_s": [r["copy_s"] for r in saved.saves],
            "sync_save_s": sync_s,
            "step_ms": [r["ms"] for r in records], "launches": launches,
            "seconds": time.perf_counter() - t_phase}


def _batched_remat(torch, gs, G, params, bs):
    """19b: the batched stage-1 and tuning steps under remat against the
    same steps without (deterministic cuDNN, TF32 off): losses within
    BATCH_LANE_LOSS_TOL relative, each group within STAGE1_GRAD_TOL /
    GRAD_TOL; every draw taken before the recomputed render, which
    launches each render's gather again in its backward."""
    import dataclasses as dc
    from tgi_torch.invert.coach import PTICoach
    from tgi_torch.invert.projector import Projector
    from tgi_torch.models.generator import stack_params
    bs_r = dict(bs, proj=Projector(
        G, params, bs["vgg"], bs["head"], bs["nets"][0],
        dc.replace(bs["proj"].cfg, remat_render=True)), coach=PTICoach(
        G, bs["coach"].lpips, dc.replace(bs["coach"].cfg, remat=True)))
    out = {"stage1": {}, "tuning": {}}
    torch.backends.cudnn.deterministic = True
    try:
        loss, _, plain, n, _ = _stage1_batch_grads(torch, gs, bs)
        loss_r, _, remat, n_r, _ = _stage1_batch_grads(torch, gs, bs_r)
        params_b = _map_detach(stack_params(params, BATCH))
        for t in _leaves(params_b):
            t.requires_grad_(True)
        tl, tg, tn, _ = _tune_batch_grads(torch, gs, bs, params_b)
        tl_r, tg_r, tn_r, _ = _tune_batch_grads(torch, gs, bs_r, params_b)
    finally:
        torch.backends.cudnn.deterministic = False
    pairs = (("stage1", ("w", "noise", "pose", "translation"), plain, remat,
              STAGE1_GRAD_TOL), ("tuning", TUNE_GROUPS, tg, tg_r, GRAD_TOL))
    for name, groups, a, b, tol in pairs:
        for g in groups:
            out[name][g] = _group_err(torch, b, a, g)[0]
            check(out[name][g] <= tol, f"batched {name} step with the "
                  f"options, remat vs none, {g}: {out[name][g]} > {tol}")
    out["stage1"]["loss_rel"] = abs(loss_r - loss) / abs(loss)
    out["tuning"]["loss_rel"] = ((tl_r - tl).abs() / tl.abs()).max().item()
    out["launches"] = {"stage1": n, "stage1_remat": n_r, "tuning": tn,
                       "tuning_remat": tn_r}
    log(f"batched steps with the options, remat vs none: {out}")
    check(out["stage1"]["loss_rel"] <= BATCH_LANE_LOSS_TOL
          and out["tuning"]["loss_rel"] <= BATCH_LANE_LOSS_TOL,
          f"remat moves the losses: {out}")
    check(n_r["triplane_gather"] == 2 * n["triplane_gather"] == 8
          and n_r["triplane_splat"] == n["triplane_splat"] == 4
          and tn_r["triplane_gather"] == 2 * tn["triplane_gather"] == 4
          and tn_r["triplane_splat"] == tn["triplane_splat"] == 2,
          f"launches with the options: {out['launches']}")
    return out


def phase_batched_noise(torch, gs, step_times_17):
    """19b: phase 17a-c on the gate's generator (seed 2) with
    NOISE_OPTIONS, as 16b sets them, and phase 17's targets (rendered
    without them): one batched stage-1 joint step and one batched tuning
    step at N = 4 through the kernels, again, through the plain sampler
    and under TGI_SPLAT=mxu, image b against its one-image step on its
    own generator's draws, the kernels against their plain versions;
    the same steps under remat (``_batched_remat``); then the step
    times at B = 4 with and without remat beside phase 17's."""
    from tgi_torch.models.generator import TriPlaneGenerator
    from tgi_torch.scripts import selfinv_gate
    G, params = selfinv_gate.full_width_generator(
        DEVICE, seed=selfinv_gate.GENERATOR_SEED)
    Go = TriPlaneGenerator(G.cfg.with_rendering(**NOISE_OPTIONS))
    bs = batch_setup(torch, Go, params, targets_G=G)
    rk = Go.cfg.rendering_kwargs
    M = Go.cfg.neural_rendering_resolution ** 2
    d = bs["draws"][0]
    check(set(d) == {"jitter", "u", "sigma_noise", "sr_noise"}
          and tuple(d["sigma_noise"][0].shape) == (
              BATCH, M * rk["depth_resolution"], 1),
          f"the batch's draws: {sorted(d)}")
    steps = phase_batched_steps(torch, gs, Go, params, bs)
    steps.pop("n4_inputs")
    steps["remat"] = _batched_remat(torch, gs, Go, params, bs)
    times = phase_batched_step_times(torch, gs, Go, params, bs,
                                     sizes=(BATCH,))
    for key, t in times.items():
        before = step_times_17[key]
        log(f"batched step times {key} with the options: stage 1 "
            f"{t['stage1_step_ms']:.1f} ms, tuning {t['tuning_step_ms']:.1f}"
            f" ms; phase 17 without them {before['stage1_step_ms']:.1f} and "
            f"{before['tuning_step_ms']:.1f} ms")
    return {"steps": steps, "step_times": times,
            "step_times_without_options": {k: step_times_17[k]
                                           for k in times}}


def phase_last_refusals(torch, gs, tmp, step_times_17):
    """Phase 19: a ``phase_snapshots``, b ``phase_batched_noise``."""
    t0 = time.perf_counter()
    out = {"snapshots": phase_snapshots(torch, gs, tmp),
           "batched_noise": phase_batched_noise(torch, gs, step_times_17)}
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 19 (snapshots, batched noise) in {out['seconds']:.1f} s")
    return out


# The kernels of tgi's two kernel benches, at the benches' shapes: 3
# planes of 256², the points of a frustum march of Ry x Rx rays and S
# samples. The render pass's point count first, then the scripts'.
BENCH_LAYOUTS = ((128, 128, 48), (64, 64, 48))
BENCH_RES = 256


def main_points():
    """P of the render pass, the first layout."""
    return math.prod(BENCH_LAYOUTS[0])


def bench_point_counts():
    """P of every layout: the render pass's, then the scripts'."""
    return [math.prod(layout) for layout in BENCH_LAYOUTS]


def bench_inputs(torch):
    """The benches' tensors on the card at both point counts:
    {("gather" | "splat", P): tensors}."""
    from tgi_torch.scripts import bench_gather_vmem as bgv
    from tgi_torch.scripts import bench_splat_sched as bss
    out = {}
    for Ry, Rx, S in BENCH_LAYOUTS:
        P = Ry * Rx * S
        out["gather", P] = bgv.make_inputs(DEVICE, Ry, Rx, S, BENCH_RES)
        out["splat", P] = bss.make_inputs(DEVICE, Ry, Rx, S, BENCH_RES)
        out["gather", P]["cells_tiled_long"] = {
            k: out["gather", P][k].long()
            for k in ("cells_tiled", "cells_tiled_blocked")}
    return out


def _local_cells(torch, gen, H, W, P):
    """Tile-numbered cells of random walks (spatially local), with an
    out-of-range cell at each end."""
    from tgi_torch.ops.pack import tiled_cell
    y = (torch.randint(-1, 2, (3, P), generator=gen).cumsum(1)
         + H // 2).clamp(0, H - 1)
    x = (torch.randint(-1, 2, (3, P), generator=gen).cumsum(1)
         + W // 2).clamp(0, W - 1)
    cells = tiled_cell(y, x, W).int()
    cells[:, 3] = -1
    cells[:, -2] = H * W
    return cells


def phase_row_fetch_vs_plain(torch, inputs):
    """a. gather_rows.cu bitwise against its plain version: fp32 and bf16
    at both bench point counts (786,432 and 196,608), and at a ragged
    P = 1037 with rows of 128 and 64 and cells out of range."""
    from tgi_torch.ops import gather_rows as gr
    cases = []
    for P in bench_point_counts():
        t = inputs["gather", P]
        cases += [(f"fp32 P={P}", t["exp32"], t["cells"]),
                  (f"bf16 P={P}", t["exp16"], t["cells"])]
    gen = torch.Generator().manual_seed(21)
    for L in (128, 64):
        exp = torch.randn(3, 1024, L, generator=gen)
        cells = torch.randint(-2, 1026, (3, 1037), generator=gen).int()
        for dt in (torch.float32, torch.bfloat16):
            cases.append((f"{str(dt)[6:]} P=1037 L={L}",
                          exp.to(DEVICE, dt), cells.to(DEVICE)))
    worst = 0.0
    for name, exp, cells in cases:
        got = gr.gather_rows_cuda(exp, cells)
        want = gr.gather_rows_plain(exp, cells)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        same = torch.equal(got, want)
        log(f"gather_rows vs plain, {name}: bitwise equal {same}, max abs "
            f"err {err}")
        check(same, f"gather_rows differs from its plain version ({name})")
        worst = max(worst, err)
    return worst


def phase_tilewalk_vs_plain(torch, inputs):
    """b. gather_tilewalk.cu bitwise against its plain version, bf16 and
    fp32, block-local and ray-major order, at both bench point counts
    (786,432 and 196,608) and at a ragged P = 1037: on a 32² plane with
    rows of 128 and 64, there with the first cell of two blocks out of
    range, on a 16² plane (one window) and on a 512² plane (1,024
    windows, cells drawn uniformly, so a block names hundreds of them,
    and again the first cell of two blocks out of range); its passes
    per block equal to the plain count. Returns (max abs err, mean
    passes per block by order and P)."""
    from tgi_torch.ops import gather_rows as gr
    cases = []
    for P in bench_point_counts():
        t = inputs["gather", P]
        for dt, exp in (("bf16", t["exp16_t"]), ("fp32", t["exp32_t"])):
            for order, key in (("block-local", "cells_tiled_blocked"),
                               ("ray-major", "cells_tiled")):
                cases.append((f"{dt} {order} P={P}", f"{order} P={P}",
                              exp, t[key]))
    gen = torch.Generator().manual_seed(22)
    cells = _local_cells(torch, gen, 32, 32, 1037).to(DEVICE)
    first_out = cells.clone()
    first_out[:, 0] = -1
    first_out[:, 512] = 1024
    one = _local_cells(torch, gen, 16, 16, 1037).to(DEVICE)
    wide = torch.randint(0, 512 * 512, (3, 1037), generator=gen).int()
    wide[:, 0] = 512 * 512
    wide[:, 512] = -1
    wide = wide.to(DEVICE)
    small = [(f"P=1037 L={L}", 1024, L, cells) for L in (128, 64)]
    small += [("P=1037 L=128, first cells out of range", 1024, 128,
               first_out),
              ("P=1037 L=128, one window (16x16)", 256, 128, one),
              ("P=1037 L=64, 1,024 windows (512x512), first cells out of "
               "range", 512 * 512, 64, wide)]
    for name, HW, L, c in small:
        exp = torch.randn(3, HW, L, generator=gen)
        for dt in (torch.bfloat16, torch.float32):
            cases.append((f"{str(dt)[6:]} {name}", None, exp.to(DEVICE, dt),
                          c))
    worst, passes = 0.0, {}
    for name, order, exp, cells in cases:
        got, n = gr.gather_rows_tilewalk_cuda(exp, cells, return_passes=True)
        want = gr.gather_rows_plain(exp, cells)
        n_want = gr.tilewalk_passes_plain(cells, exp.shape[1])
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        same = torch.equal(got, want)
        mean = n.float().mean().item()
        log(f"gather_tilewalk vs plain, {name}: bitwise equal {same}, max "
            f"abs err {err}; passes per block {mean:.3f} (plain count "
            f"equal {torch.equal(n, n_want)})")
        check(same, f"gather_tilewalk differs from its plain version "
              f"({name})")
        check(torch.equal(n, n_want), f"gather_tilewalk's passes differ "
              f"from the plain count ({name})")
        if order is not None:
            passes.setdefault(order, mean)
        worst = max(worst, err)
    return worst, passes


def phase_splat_sched_vs_plain(torch, inputs):
    """c. splat_sched.cu against plain: walk and nbhd against the full
    ``index_add_`` sum, static9 against its own masked sum, max|d| <=
    SPLAT_TOL * max(1, max|plain|), at both bench point counts (786,432
    and 196,608, block-local order) and at ragged 64x64 and 64x128 shapes
    (the latter leaves nbhd a residual walk). Returns (max abs, max
    relative) error."""
    from tgi_torch.ops import splat_sched as ss
    cases = [(f"P={P} {BENCH_RES}x{BENCH_RES}", inputs["splat", P]["rows"],
              inputs["splat", P]["wg"], BENCH_RES, BENCH_RES)
             for P in bench_point_counts()]
    gen = torch.Generator().manual_seed(23)
    for H, W in ((64, 64), (64, 128)):
        rows = torch.randint(-1, H * W + 1, (3, 1037), generator=gen).int()
        wg = torch.randn(3, 1037, 128, generator=gen).bfloat16()
        cases.append((f"E=1037 {H}x{W}", rows.to(DEVICE), wg.to(DEVICE),
                      H, W))
    worst_abs = worst_rel = 0.0
    for name, rows, wg, H, W in cases:
        full = ss.splat_sched_plain(rows, wg, H, W, "walk")
        for schedule in ss.SCHEDULES:
            got = ss.splat_sched_cuda(rows, wg, H, W, schedule)
            want = (ss.splat_sched_plain(rows, wg, H, W, schedule)
                    if schedule == "static9" else full)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = max(1.0, want.abs().max().item())
            log(f"splat_sched {schedule} vs plain, {name}: max abs err "
                f"{err:.3g} (max |plain| {scale:.4g}, relative "
                f"{err / scale:.3g})")
            check(err <= SPLAT_TOL * scale, f"splat_sched {schedule} "
                  f"disagrees with its plain version ({name}): {err} > "
                  f"{SPLAT_TOL} * {scale}")
            worst_abs = max(worst_abs, err)
            worst_rel = max(worst_rel, err / scale)
    return worst_abs, worst_rel


def phase_benches(torch, gs):
    """e. The port's twins of tgi's two kernel benches through their
    ``main`` at their default shapes, on the card: the slice's main path.
    Every count is 0 before each and read after. Returns {bench:
    launches}."""
    from tgi_torch.scripts import bench_gather_vmem as bgv
    from tgi_torch.scripts import bench_splat_sched as bss
    launches = {}
    for name, mod in (("bench_gather_vmem", bgv),
                      ("bench_splat_sched", bss)):
        torch.cuda.synchronize()
        zero_counts(gs)
        t0 = time.perf_counter()
        res = mod.main(["--device", DEVICE])
        torch.cuda.synchronize()
        launches[name] = {**counts(gs), **bench_counts()}
        log(f"{name}.main: {time.perf_counter() - t0:.1f} s, launches "
            f"{launches[name]}")
        check(all(math.isfinite(v) and v > 0 for v in res["ms"].values()),
              f"{name}: a time is not a positive number: {res['ms']}")
        if mod is bgv:
            check(len(res["ms"]) == 8 and set(res["max_abs"].values())
                  == {0.0}, f"{name}: {res}")
            kernels = ("gather_rows", "gather_tilewalk", "triplane_gather")
        else:
            err = max(res["max_abs"].values())
            check(len(res["ms"]) == 5 and err <= SPLAT_TOL * res["scale"],
                  f"{name}: {res}")
            kernels = ("splat_sched", "triplane_splat")
        for k in kernels:
            check(launches[name][k] > 0, f"{name} launched no {k}")
    return launches


def _time_row(torch, fn, plain, library, nbytes, flops, bw, **extra):
    """One kernel's times on one input beside its bound."""
    row = {"ms": cuda_ms(torch, fn), "plain_ms": cuda_ms(torch, plain,
                                                         iters=10),
           "library_ms": cuda_ms(torch, library),
           "bound_ms": max(nbytes / bw, flops / FP32_FLOPS) * 1e3,
           "bound_by": ("bytes" if nbytes / bw >= flops / FP32_FLOPS
                        else "operations"),
           "bound_bytes": nbytes, **extra}
    return row


def phase_bench_kernel_times(torch, inputs, bw):
    """d. Each bench kernel at P = 786,432 and 196,608 beside its plain
    version, the library call (torch indexing; ``index_add_`` of the
    upcast payload) and the bound: each input read once, each output
    written once. Returns {kernel: {case: row}}."""
    from tgi_torch.ops import gather_rows as gr
    from tgi_torch.ops import splat_sched as ss
    from tgi_torch.scripts import bench_gather_vmem as bgv
    from tgi_torch.scripts import bench_splat_sched as bss
    out = {"gather_rows": {}, "gather_tilewalk": {}, "splat_sched": {}}
    for Ry, Rx, S in BENCH_LAYOUTS:
        P = Ry * Rx * S
        t = inputs["gather", P]
        G, HW, L = t["exp32"].shape
        for dt, exp, exp_t in (("bf16", t["exp16"], t["exp16_t"]),
                               ("fp32", t["exp32"], t["exp32_t"])):
            # out + plane + int32 cells; no arithmetic
            nbytes = exp.element_size() * L * (G * P + G * HW) + 4 * G * P
            out["gather_rows"][f"{dt} P={P}"] = _time_row(
                torch, lambda: gr.gather_rows_cuda(exp, t["cells"]),
                lambda: gr.gather_rows_plain(exp, t["cells"]),
                lambda: bgv.index_rows(t, exp), nbytes, 0, bw)
            for order, key in (("block-local", "cells_tiled_blocked"),
                               ("ray-major", "cells_tiled")):
                cells, idx = t[key], t["cells_tiled_long"][key]
                _, n = gr.gather_rows_tilewalk_cuda(exp_t, cells, True)
                out["gather_tilewalk"][f"{dt} {order} P={P}"] = _time_row(
                    torch, lambda: gr.gather_rows_tilewalk_cuda(exp_t, cells),
                    lambda: gr.gather_rows_plain(exp_t, cells),
                    lambda: exp_t[t["plane_idx"], idx], nbytes, 0, bw,
                    passes_per_block=n.float().mean().item())
        s = inputs["splat", P]
        rows, wg = s["rows"], s["wg"]
        for schedule in ss.SCHEDULES:
            # The payloads the schedule adds (static9 drops some), all
            # rows, the accumulator written once; one add per element.
            R = BENCH_RES
            kept = ss.schedule_mask(rows, R, R, schedule).sum().item()
            nbytes = 2 * 128 * kept + 4 * G * P + 4 * 128 * G * HW
            out["splat_sched"][f"{schedule} P={P}"] = _time_row(
                torch, lambda: ss.splat_sched_cuda(rows, wg, R, R, schedule),
                lambda: ss.splat_sched_plain(rows, wg, R, R, schedule),
                lambda: bss.index_add(s), nbytes, 128 * kept, bw)
    for kernel, rows in out.items():
        for case, r in rows.items():
            log(f"times, {kernel} {case}: " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in r.items())
                + f" (bound: {r['bound_bytes'] / 1e6:.1f} MB at "
                f"{bw / 1e12:.2f} TB/s)")
    return out


def bench_kernel_entries(times, errs, launches, check_launches, runs):
    """The three bench kernels' entries of the ``kernels`` line: the
    numbers at the render pass's P = 786,432 (bf16, block-local order,
    the walk), every measured case under ``cases``."""
    P = main_points()
    spec = (("gather_rows", "gather_rows.cu",
             "tgi/ops/pallas/gather_vmem.py:98", f"bf16 P={P}"),
            ("gather_tilewalk", "gather_tilewalk.cu",
             "tgi/ops/pallas/gather_vmem.py:160", f"bf16 block-local P={P}"),
            ("splat_sched", "splat_sched.cu", "scripts/bench_splat_sched.py"
             ":118", f"walk P={P}"))
    entries = []
    for name, src, replaces, main_case in spec:
        by_path = {path: n[name] for path, n in launches.items()}
        entry = {"name": name, "route": "cuda",
                 "source": f"tgi_torch/csrc/{src}", "replaces": replaces,
                 "launches": sum(by_path.values()),
                 "launches_by_path": {**by_path, "run_pti": sum(
                     r["bench_kernels"][name] for r in runs.values()),
                                      "chip_smoke_check":
                                          check_launches[name]},
                 **errs[name], **times[name][main_case],
                 "case": main_case, "cases": times[name]}
        if name == "gather_rows":
            entry["also_replaces"] = "tgi/ops/pallas/gather_vmem.py:62"
        entries.append(entry)
    return entries


def path_launches(refusals, kernel):
    """Phase 19's launches of ``kernel`` by path: the snapshot runs (the
    default splat: no sorted splat) and the batched steps with the
    options (the sorted splat's under TGI_SPLAT=mxu)."""
    steps = refusals["batched_noise"]["steps"]
    route = "mxu" if kernel == "triplane_splat_sorted" else "default"
    out = {} if route == "mxu" else {
        "snapshots_train_gan_10_steps": refusals["snapshots"]["launches"][
            kernel],
        "batched_options_stage1_step_n4_remat": steps["remat"]["launches"][
            "stage1_remat"][kernel],
        "batched_options_tuning_step_n4_remat": steps["remat"]["launches"][
            "tuning_remat"][kernel]}
    out["batched_options_stage1_step_n4"] = steps["stage1"]["launches"][
        route][kernel]
    out["batched_options_tuning_step_n4"] = steps["tuning"]["launches"][
        route][kernel]
    return out


def main():
    t_start = time.perf_counter()
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
    sorted_err, sorted_rel = phase_sorted_vs_plain(torch, gs)
    G, params = full_width_generator(torch)
    with tempfile.TemporaryDirectory(prefix="tgi_chip_smoke_") as tmp:
        res, gen_launches = phase_generate(torch, gs, G, params, tmp)
        phase_plain_swap(torch, gs, G, params, res)
        phase_small_vs_cpu(torch)
        phase_generator_grads(torch, gs, G, params)
        phase_small_grads_vs_cpu(torch)
        pti_launches, st = phase_stage2(torch, gs, G, params, tmp)
        nets = stage1_nets(torch, stage1_target(torch, G, params)[1])
        st1 = stage1_setup(torch, G, params, nets)
        per_step, sorted_seen = phase_stage1_grads(torch, gs, st1)
        runs = {label: phase_stage1_stage2(torch, gs, G, params, nets, tmp,
                                           label.split("_")[0], label)
                for label in ("pack", "pack_again", "mxu", "mxu_again")}
        phase_route_spread(runs)
        phase_forward_repeat(torch, G, params, st1)
        pkl = phase_pkl_bf16(torch, gs, G, params, nets, tmp)
        gate = phase_selfinv_gate(torch, gs)
        enc, arc, face_errs = phase_faces_vs_cpu(torch)
        pti_eval = phase_run_pti_eval(torch, gs, G, params, enc, arc, tmp)
        del enc, arc
        outputs = phase_outputs(torch, gs, G, params, st, tmp)
        training = phase_training(torch, gs, tmp)
        metrics = phase_metrics(torch, gs, card, tmp)
        photo = phase_photo_and_tf(torch, gs, G, params, card, tmp)
        batched = phase_batched(torch, gs, gate, tmp, bw)
        last = phase_last_modules(torch, gs, G, params, tmp)
        refusals = phase_last_refusals(torch, gs, tmp,
                                       batched["step_times"])
    gather_times = phase_times(torch, gs, G, params, bw)
    _, seen = phase_step_times(torch, gs, params, st)
    splat_times = phase_splat_times(torch, gs, seen, bw)
    small_splat = phase_small_splat_times(torch, gs, bw)
    step1 = {mode: phase_stage1_step_times(torch, gs, st1, mode)
             for mode in ("pack", "mxu")}
    sorted_times = phase_sorted_times(torch, gs, sorted_seen, bw)
    inputs = bench_inputs(torch)
    zero_counts(gs)
    fetch_err = phase_row_fetch_vs_plain(torch, inputs)
    walk_err, walk_passes = phase_tilewalk_vs_plain(torch, inputs)
    sched_err, sched_rel = phase_splat_sched_vs_plain(torch, inputs)
    check_launches = bench_counts()
    bench_launches = phase_benches(torch, gs)
    bench_times = phase_bench_kernel_times(torch, inputs, bw)
    bench_entries = bench_kernel_entries(bench_times, {
        "gather_rows": {"max_abs_err": fetch_err},
        "gather_tilewalk": {"max_abs_err": walk_err,
                            "passes_per_block_check": walk_passes},
        "splat_sched": {"max_abs_err": sched_err,
                        "max_rel_err": sched_rel}},
        bench_launches, check_launches, runs)

    def total(run, kernel):
        return run["stage1"][kernel] + run["stage2"][kernel]

    pack, mxu = runs["pack"], runs["mxu"]
    noise_kernels = refusals["batched_noise"]["steps"]["kernels_vs_plain"]
    log(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": [{
        "name": "triplane_gather", "route": "cuda",
        "source": "tgi_torch/csrc/triplane_gather.cu",
        "replaces": "tgi/ops/pallas/gather_vmem.py:62",
        "launches": total(pack, "triplane_gather"),
        "launches_by_path": {"generate_samples": gen_launches,
                             "run_pti_stage2": pti_launches[
                                 "triplane_gather"],
                             "run_pti_stage1": pack["stage1"][
                                 "triplane_gather"],
                             "run_pti_stage1_mxu": mxu["stage1"][
                                 "triplane_gather"],
                             "bench_gather_vmem": bench_launches[
                                 "bench_gather_vmem"]["triplane_gather"],
                             "pkl_bf16_render": pkl["render"][
                                 "triplane_gather"],
                             "run_pti_pkl_bf16_stage1": pkl["stage1"][
                                 "triplane_gather"],
                             "run_pti_pkl_bf16_stage2": pkl["stage2"][
                                 "triplane_gather"],
                             "selfinv_bootstrap": gate["launches"][
                                 "bootstrap"]["triplane_gather"],
                             "selfinv_gate": gate["launches"]["gate"][
                                 "triplane_gather"],
                             "run_pti_eval": pti_eval["launches"][
                                 "triplane_gather"],
                             "sample_mixed_chunk": outputs["sample_mixed"][
                                 "launches"],
                             "extract_mesh_256": outputs["mesh"]["launches"],
                             "render_orbit_8_frames": outputs["orbit"][
                                 "launches"],
                             "run_pti_outputs": outputs["run_pti"][
                                 "launches"]["triplane_gather"],
                             "ganspace_edit": outputs["ganspace"][
                                 "launches"],
                             "train_gan": training["launches"][
                                 "triplane_gather"],
                             **{f"calc_metrics_cli_{k}": v["launches"][
                                 "triplane_gather"]
                                for k, v in metrics["cli"].items()},
                             "is50k_renders": metrics["is_ppl"][
                                 "is_gathers"],
                             "ppl2_wend": metrics["is_ppl"]["ppl_gathers"],
                             "render_options": photo["render_options"][
                                 "launches"]["triplane_gather"],
                             "render_options_step": photo[
                                 "render_options"]["grad_launches"][
                                 "triplane_gather"],
                             "photo_run_pti": photo["photo"]["launches"][
                                 "triplane_gather"],
                             "batched_stage1_step_n4": batched["steps"][
                                 "stage1"]["launches"]["default"][
                                 "triplane_gather"],
                             "batched_tuning_step_n4": batched["steps"][
                                 "tuning"]["launches"]["default"][
                                 "triplane_gather"],
                             "run_pti_batch4": batched["run_pti"][
                                 "launches"]["triplane_gather"],
                             "selfinv_gate_batch4": gate["launches"][
                                 "batch_gate"]["triplane_gather"],
                             "training_loop_mesh_2_steps": last[
                                 "mesh_training"]["launches"][
                                 "triplane_gather"],
                             "ray_split_render_2_shards": last["ray_split"][
                                 "launches_forward"],
                             "clip_loss_step": last["clip"]["launches"][0],
                             "visualizer_5_frames": last["visualizer"][
                                 "launches"][0],
                             **path_launches(refusals, "triplane_gather")},
        "max_abs_err": gather_err,
        "n4_max_abs_err": batched["steps"]["kernels_vs_plain"][
            "gather_max_abs_err"],
        "n4_fine_pass": batched["kernel_times_n4"]["triplane_gather"],
        "sample_mixed_chunk_max_abs_err": outputs["sample_mixed"][
            "max_abs_err"],
        "render_orbit_batch_max_abs_err": outputs["orbit"]["max_abs_err"],
        "calc_metrics_batch_max_abs_err": metrics["batch_max_abs_err"],
        "n4_options_max_abs_err": noise_kernels["gather_max_abs_err"],
        **gather_times}, {
        "name": "triplane_splat", "route": "cuda",
        "source": "tgi_torch/csrc/triplane_splat.cu",
        "replaces": "tgi/ops/pallas/splat_pack.py:192",
        "also_replaces": "tgi/ops/pallas/splat.py:97",
        "launches": total(pack, "triplane_splat"),
        "launches_by_path": {"run_pti_stage2": pti_launches[
                                 "triplane_splat"],
                             "run_pti_stage1": pack["stage1"][
                                 "triplane_splat"],
                             "run_pti_stage1_mxu": mxu["stage1"][
                                 "triplane_splat"],
                             "bench_splat_sched": bench_launches[
                                 "bench_splat_sched"]["triplane_splat"],
                             "run_pti_pkl_bf16_stage1": pkl["stage1"][
                                 "triplane_splat"],
                             "run_pti_pkl_bf16_stage2": pkl["stage2"][
                                 "triplane_splat"],
                             "selfinv_gate": gate["launches"]["gate"][
                                 "triplane_splat"],
                             "run_pti_eval": pti_eval["launches"][
                                 "triplane_splat"],
                             "run_pti_outputs": outputs["run_pti"][
                                 "launches"]["triplane_splat"],
                             "train_gan": training["launches"][
                                 "triplane_splat"],
                             "render_options_step": photo[
                                 "render_options"]["grad_launches"][
                                 "triplane_splat"],
                             "photo_run_pti": photo["photo"]["launches"][
                                 "triplane_splat"],
                             "batched_stage1_step_n4": batched["steps"][
                                 "stage1"]["launches"]["default"][
                                 "triplane_splat"],
                             "batched_tuning_step_n4": batched["steps"][
                                 "tuning"]["launches"]["default"][
                                 "triplane_splat"],
                             "run_pti_batch4": batched["run_pti"][
                                 "launches"]["triplane_splat"],
                             "selfinv_gate_batch4": gate["launches"][
                                 "batch_gate"]["triplane_splat"],
                             "training_loop_mesh_2_steps": last[
                                 "mesh_training"]["launches"][
                                 "triplane_splat"],
                             "ray_split_backward_2_shards": last[
                                 "ray_split"]["launches_backward"],
                             "clip_loss_step": last["clip"]["launches"][1],
                             **path_launches(refusals, "triplane_splat")},
        "max_abs_err": splat_err, "max_rel_err": splat_rel,
        "n4_max_abs_err": batched["steps"]["kernels_vs_plain"][
            "splat_max_abs_err"],
        "n4_max_rel_err": batched["steps"]["kernels_vs_plain"][
            "splat_max_rel_err"],
        "n4_options_max_rel_err": noise_kernels["splat_max_rel_err"],
        "n4_fine_pass": batched["kernel_times_n4"]["triplane_splat"],
        **splat_times, "check_shape_c16": small_splat}, {
        "name": "triplane_splat_sorted", "route": "cuda",
        "source": "tgi_torch/csrc/triplane_splat_sorted.cu",
        "replaces": "tgi/ops/pallas/splat_mxu.py:112",
        "launches": total(mxu, "triplane_splat_sorted"),
        "keys_launches": total(mxu, "triplane_splat_keys"),
        "offsets_launches": total(mxu, "triplane_splat_offsets"),
        "launches_by_path": {"run_pti_stage1": mxu["stage1"][
                                 "triplane_splat_sorted"],
                             "run_pti_stage2": mxu["stage2"][
                                 "triplane_splat_sorted"],
                             "selfinv_gate": gate["launches"]["gate"][
                                 "triplane_splat_sorted"],
                             "batched_stage1_step_n4": batched["steps"][
                                 "stage1"]["launches"]["mxu"][
                                 "triplane_splat_sorted"],
                             "batched_tuning_step_n4": batched["steps"][
                                 "tuning"]["launches"]["mxu"][
                                 "triplane_splat_sorted"],
                             **path_launches(refusals,
                                             "triplane_splat_sorted")},
        "max_abs_err": sorted_err, "max_rel_err": sorted_rel,
        "n4_max_abs_err": batched["steps"]["kernels_vs_plain"][
            "sorted_max_abs_err"],
        "n4_max_rel_err": batched["steps"]["kernels_vs_plain"][
            "sorted_max_rel_err"],
        "n4_keys": batched["steps"]["kernels_vs_plain"]["sorted_keys"],
        "n4_options_max_rel_err": noise_kernels["sorted_max_rel_err"],
        **sorted_times}, *bench_entries],
        "stage1_step_ms": {m: v["step"] for m, v in step1.items()},
        "stage1_launches_per_step": per_step,
        "stage1_stage2_wall_s": {m: r["wall"] for m, r in runs.items()},
        "pkl_bf16": {"tuning_step_ms": pkl["step_ms"],
                     "render_ms_host": pkl["render_ms"],
                     "render_psnr_bf16_vs_fp32": pkl["render_psnr"],
                     "grad_norm_err_kernels_vs_plain": pkl["grad_worst"],
                     "invert_one_wall_s": pkl["wall"]},
        "selfinv_gate": {"seconds": gate["seconds"],
                         "bootstrap_pose_val_rot_deg": gate["bootstrap"][
                             "pose_val_rot_deg"],
                         "metrics": {k: v for k, v in gate["gate"].items()
                                     if not k.endswith("_trace")}},
        "face_nets_card_vs_cpu_rel_err": face_errs,
        "run_pti_eval": {"wall_s": pti_eval["wall"],
                         "metrics": pti_eval["entry"]},
        "outputs": {
            "mesh_256": {k: outputs["mesh"][k] for k in
                         ("sigma_grid_s", "marching_s", "build_s",
                          "extract_mesh_s", "verts", "faces")},
            "render_orbit": {k: outputs["orbit"][k] for k in
                             ("ms_per_frame", "peak_gib")},
            "run_pti": {k: outputs["run_pti"][k] for k in
                        ("wall_s", "video", "step_ms_locality", "step_ms")},
            "pca_s": outputs["ganspace"]["pca_s"]},
        "train_gan": {"steps": training["times"],
                      "warm_steps_ms": training["warm"],
                      "image_grid": training["grids"],
                      "launches_per_step": [
                          [r["gathers"], r["splats"]]
                          for r in training["records"]],
                      "grad_norm_err_kernels_vs_plain": training["grads"],
                      "density_points": training["density"],
                      "tiny_step_card_vs_cpu": training["tiny"],
                      "phase_s": training["seconds"]},
        "metrics": metrics,
        "photo_tf_options": photo,
        "batched": {"steps": batched["steps"],
                    "step_times": batched["step_times"],
                    "run_pti_wall_s": batched["run_pti"]["wall_s"],
                    "gate": batched["gate"],
                    "phase_s": batched["seconds"]},
        "last_modules": last, "last_refusals": refusals}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
