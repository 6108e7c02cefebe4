"""Where one full-width render's time goes, on a CUDA card.

    python -m tgi_torch.apps.profile_render [--render-res 128] [--iters 5]

Builds the FFHQ-rebalanced 512 generator with weights drawn from a seed,
then times its stages with CUDA events (median of ``--iters``): mapping,
backbone, the two-pass volume render (rays, both gather passes, decoder,
importance sampling, merged march) and super-resolution. Then it traces
one render with ``torch.profiler`` and prints the device time by kernel
and the card's busy share of the render's wall time. TF32 is off, as in
the comparisons of ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import math
import statistics
import subprocess
import time

import torch


def _median_ms(fn, iters):
    times = []
    for _ in range(iters + 1):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times[1:])


@torch.no_grad()
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--render-res", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_render needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tgi_torch.apps.gen_samples import seed_z
    from tgi_torch.models.generator import GeneratorConfig, TriPlaneGenerator
    from tgi_torch.nn.superres import superresolution_apply
    from tgi_torch.render.cameras import (fov_to_intrinsics, look_at_pose,
                                          pack_camera)
    from tgi_torch.render.rays import ray_sampler
    from tgi_torch.render.renderer import importance_render

    dev = "cuda"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}")
    G = TriPlaneGenerator(GeneratorConfig(
        neural_rendering_resolution=args.render_res))
    params = G.init(torch.Generator().manual_seed(0), device=dev)
    pivot = torch.tensor([0, 0, 0.2], device=dev)
    intr = fov_to_intrinsics(18.837, device=dev)
    c = pack_camera(look_at_pose(math.pi / 2 + 0.35, math.pi / 2, pivot,
                                 radius=2.7, device=dev)[None], intr)
    z = seed_z(0, G.cfg.z_dim, dev)
    rk = G.cfg.rendering_kwargs
    res = args.render_res

    ws = G.mapping(params, z, c, truncation_psi=0.7, truncation_cutoff=14)
    planes = G.backbone_planes(params, ws)

    def render():
        o, d = ray_sampler(c[:, :16].reshape(1, 4, 4),
                           c[:, 16:].reshape(1, 3, 3), res)
        return importance_render(planes, params["decoder"], o, d, rk,
                                 det=True)

    feats, _, _ = render()
    fimg = feats.permute(0, 2, 1).reshape(1, -1, res, res)
    stages = {
        "mapping": lambda: G.mapping(params, z, c, 0.7, 14),
        "backbone": lambda: G.backbone_planes(params, ws),
        "render (2 passes)": render,
        "superresolution": lambda: superresolution_apply(
            params["superresolution"], fimg[:, :3], fimg, ws, G.cfg.sr_cfg),
        "whole (mapping + synthesis)": lambda: G.synthesis(
            params, G.mapping(params, z, c, 0.7, 14), c),
    }
    for name, fn in stages.items():
        print(f"stage {name}: {_median_ms(fn, args.iters):.3f} ms")

    whole = stages["whole (mapping + synthesis)"]
    whole()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        whole()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernel rows only: an operator's row repeats its kernels' time.
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profiled render: wall {wall_ms:.3f} ms (profiler on), kernels "
          f"{busy_ms:.3f} ms = {100 * busy_ms / wall_ms:.1f} % busy; "
          f"{sum(e.count for e in events)} kernel launches")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:4d}x  "
              f"{e.key[:90]}")


if __name__ == "__main__":
    main()
