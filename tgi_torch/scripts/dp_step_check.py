"""Data-parallel training steps over several cards against one card.

    python -m torch.distributed.run --nproc_per_node 4 \\
        -m tgi_torch.scripts.dp_step_check --out dp.json

Every rank joins the group ``torch.distributed.run`` describes (NCCL, its
card ``cuda:LOCAL_RANK``) and builds ``train_gan``'s configuration (EG3D
FFHQ 512: the bf16 generator, the dual discriminator, the augment pipe
at p = 0.2) with weights from seed 0 and one global batch from seed 1
(the same on every rank). Then:

1. ``--steps`` sharded ``GANTrainer.train_step`` calls, each rank on its
   rows (``shard_batch``), the density regulariser and R1 on the first,
   draws from a card generator of seed 5;
2. on rank 0 alone, the same steps unsharded from the same weights,
   batch and draws (the other ranks wait);
3. rank 0 runs the unsharded steps again, holds step 0's G phase (the
   one part whose inputs are the same in every run) as ``chip_smoke.py``
   phase 18a does (g_loss and g_reg within 1e-4 relative, the applied
   gradients per group within 2e-3 of the norm; d_loss within 2e-3),
   and prints one JSON line with every step's differences sharded vs
   unsharded beside unsharded vs its repeat, the step times (CUDA
   events; the first step, with both regularisers, apart), the
   collectives a step and the card's name and power limit.

It exits non-zero where a check fails. With ``--nproc_per_node 1`` it
runs the same code on one card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys

import torch

METRIC_TOL = 1e-4
GRAD_TOL = 2e-3
G_GROUPS = ("mapping", "backbone", "decoder", "superresolution")


def _batch(G, n, device):
    """(z, c, real images) of the global batch from a CPU generator of
    seed 1: cameras at n yaws around the FFHQ pivot."""
    from tgi_torch.render.cameras import (fov_to_intrinsics, look_at_pose,
                                          pack_camera)
    gen = torch.Generator().manual_seed(1)
    z = torch.randn(n, G.cfg.z_dim, generator=gen)
    real = torch.rand(n, 3, G.cfg.img_resolution, G.cfg.img_resolution,
                      generator=gen) * 2 - 1
    yaws = torch.linspace(-0.4, 0.4, n)
    cam = look_at_pose(math.pi / 2 + yaws, torch.full((n,), math.pi / 2),
                       torch.tensor([0.0, 0.0, 0.2]), radius=2.7,
                       device="cpu")
    c = pack_camera(cam, fov_to_intrinsics(18.837, device="cpu"))
    return z.to(device), c.to(device), real.to(device)


def run_steps(trainer, G, d_cfg, batch, steps, device, mesh=None):
    """``steps`` train steps from seed-0 weights; returns (state, [per
    step: metrics, ms, collectives, applied gradients])."""
    from tgi_torch.parallel import collectives, shard_batch
    from tgi_torch.train import gan
    state = gan.init_train_state(torch.Generator().manual_seed(0), G, d_cfg,
                                 trainer, device=device)
    if mesh is not None:
        batch = shard_batch(mesh, batch)
    gen = torch.Generator(device=device).manual_seed(5)
    real_apply, applied, out = gan._apply, [], []

    def record(opt, params, grads):
        applied.append([gan._sanitize(g).detach().clone() for g in grads])
        return real_apply(opt, params, grads)

    gan._apply = record
    try:
        for k in range(steps):
            applied.clear()
            calls = collectives.CALLS
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            state, m = trainer.train_step(
                state, *batch, gen, cur_nimg=k * trainer.cfg.batch_size,
                do_greg=k % trainer.cfg.g_reg_interval == 0,
                do_dreg=k % trainer.cfg.d_reg_interval == 0, ada_p=0.2)
            ev[1].record()
            ev[1].synchronize()
            out.append({"metrics": {n: float(v) for n, v in m.items()},
                        "ms": ev[0].elapsed_time(ev[1]),
                        "collectives": collectives.CALLS - calls,
                        "grads": list(applied)})
    finally:
        gan._apply = real_apply
    return state, out


def _group_err(a, b, paths, group):
    sel = [i for i, p in enumerate(paths) if group is None or p[0] == group]
    d = torch.cat([(a[i] - b[i]).reshape(-1) for i in sel])
    ref = torch.cat([b[i].reshape(-1) for i in sel])
    return (d.norm() / ref.norm()).item()


def diffs(paths, run, ref):
    """Per step: the metrics' largest relative difference and the applied
    gradients' norm error per group (G's four, D whole)."""
    out = []
    for s, u in zip(run, ref):
        grads = {}
        for phase, name, groups in ((0, "g_params", G_GROUPS),
                                    (1, "d_params", (None,))):
            for group in groups:
                grads[group or "D"] = _group_err(
                    s["grads"][phase], u["grads"][phase], paths[name], group)
        out.append({"metrics": max(
            abs(s["metrics"][n] - u["metrics"][n])
            / max(1.0, abs(u["metrics"][n])) for n in u["metrics"]),
            "grads": grads})
    return out


def compare(paths, sharded, unsharded):
    """The failures of ``chip_smoke.py`` phase 18a's holds: step 0's G
    phase (the one part whose inputs are the same in every run) within
    the tolerances, step 0's d_loss within GRAD_TOL relative. Two
    unsharded runs on the card part after the first Adam update (atomics
    in the splat, cuDNN and the augment pipe's backward; Adam's first
    step of b1 = 0 moves every weight by about lr), so later steps are
    reported, not held."""
    fails = []
    m0, r0 = sharded[0]["metrics"], unsharded[0]["metrics"]
    for k, tol in (("g_loss", METRIC_TOL), ("g_reg", METRIC_TOL),
                   ("d_loss", GRAD_TOL)):
        if k in r0 and not abs(m0[k] - r0[k]) <= tol * max(1.0, abs(r0[k])):
            fails.append(f"step 0 {k}: {m0[k]} vs {r0[k]}")
    g0 = diffs(paths, sharded[:1], unsharded[:1])[0]["grads"]
    for group in G_GROUPS:
        if not g0[group] <= GRAD_TOL:
            fails.append(f"step 0 G {group}: gradient norm err "
                         f"{g0[group]}")
    return fails


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=4,
                        help="the global batch")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--out", default=None, help="JSON file (rank 0)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("dp_step_check: no CUDA card")
    from tgi_torch.apps.train_gan import training_configs
    from tgi_torch.parallel import init_from_env, make_mesh
    from tgi_torch.train.augment import AugmentPipe
    from tgi_torch.train.gan import GANTrainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device, joined = init_from_env("cuda")
    dist = torch.distributed
    try:
        mesh = make_mesh(devices=[device])
        G, d_cfg, cfg = training_configs(batch_size=args.batch)
        batch = _batch(G, args.batch, device)
        trainer = GANTrainer(G, d_cfg, cfg, augment_fn=AugmentPipe(),
                             mesh=mesh)
        sharded = run_steps(trainer, G, d_cfg, batch, args.steps, device,
                            mesh)
        fails = []
        if mesh.rank == 0:
            from tgi_torch.train.gan import _leaves
            plain = GANTrainer(G, d_cfg, cfg, augment_fn=AugmentPipe())
            unsharded = run_steps(plain, G, d_cfg, batch, args.steps, device)
            again = run_steps(plain, G, d_cfg, batch, args.steps, device)
            paths = {k: [p for p, _ in _leaves(sharded[0][k])]
                     for k in ("g_params", "d_params")}
            fails = compare(paths, sharded[1], unsharded[1])
            report = {
                "sharded_vs_unsharded": diffs(paths, sharded[1],
                                              unsharded[1]),
                "unsharded_vs_repeat": diffs(paths, again[1], unsharded[1])}
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip().splitlines()
            report.update(
                card=smi[mesh.rank] if smi else None, ranks=mesh.data,
                global_batch=args.batch,
                sharded_step_ms=[s["ms"] for s in sharded[1]],
                unsharded_step_ms=[s["ms"] for s in unsharded[1]],
                collectives_per_step=[s["collectives"] for s in sharded[1]],
                sharded_plain_median_ms=statistics.median(
                    s["ms"] for s in sharded[1][1:]) if args.steps > 1
                else None,
                unsharded_plain_median_ms=statistics.median(
                    s["ms"] for s in unsharded[1][1:]) if args.steps > 1
                else None,
                ok=not fails, failures=fails)
            line = json.dumps(report)
            print(line, flush=True)
            if args.out:
                os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                            exist_ok=True)
                with open(args.out, "w") as f:
                    f.write(line + "\n")
        if dist.is_initialized():
            flag = torch.tensor([float(bool(fails))], device=device)
            dist.broadcast(flag, src=0)
            fails = fails or (["rank 0 failed"] if flag.item() else [])
    finally:
        if joined:
            dist.destroy_process_group()
    if fails:
        sys.exit(1)


if __name__ == "__main__":
    main()
