"""What the self-inversion gate can tell apart on the seeded generator.

    python -m tgi_torch.scripts.selfinv_probe [--generator-seed 0|auto]
        [--out F.json]

On the CUDA card, with ``selfinv_gate``'s generator (EG3D's
``ffhqrebalanced512-128``, weights from a seed), TF32 off. First
``survey``: the gate's target for each generator seed in
``SURVEY_SEEDS`` (:func:`generator_survey`). Then, for the generator
seed ``--generator-seed`` (0 by default; ``auto`` takes the first
surveyed seed whose target is :func:`informative`), four parts:

1. ``phase12``: ``chip_smoke.py`` phase 12's gate (64 images, 100 pose
   and 50 VGG bootstrap steps, 20 inversion steps of which 10 preheat)
   with stage 2 run for 300 steps, its MSE traced every 10: how many
   tuning steps take the final MSE back under the pivot's.
2. ``sensitivity``: the gate's target (seed 42, as ``selfinv_gate``
   draws it) against renders at other latents and cameras: w* moved by a
   random direction of each length in ``RADII``, the projector's w_avg,
   another z's w, and the camera turned by each angle in ``ANGLES_DEG``;
   MSE and MS-SSIM each, and the target's contrast. Then the same in
   bf16 (``fused_dtype="bfloat16"``, as ``bench.py`` runs ``tgi``), with
   the bf16 target against the fp32 one.
3. ``gate_fp32``: ``selfinv_gate``'s full-budget run, traced every 10
   steps (the stage-1 loss, pose and w error; stage 2's MSE and
   MS-SSIM).
4. ``gate_bf16``: the same run on the bf16 generator.

Writes the JSON object to ``--out`` after each part and prints a line
per part.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from tgi_torch.scripts.selfinv_gate import (GATE_SEED, full_width_generator,
                                            run_gate)

SURVEY_SEEDS = range(16)
RADII = (1.0, 3.0, 9.4, 16.0)
ANGLES_DEG = (1.0, 3.0, 7.0)
DIRECTIONS = 2


@torch.no_grad()
def sensitivity(G, params, *, device, seed=GATE_SEED, reference=None,
                radii=RADII, angles_deg=ANGLES_DEG, directions=DIRECTIONS,
                w_avg=True):
    """{"target_std", "vs_fp32" (with ``reference``, an fp32 target),
    "renders": {label: {"mse", "ms_ssim"}}} for the gate's target."""
    from tgi_torch.invert.projector import (CANONICAL_EXTRINSIC,
                                            DEFAULT_INTRINSIC)
    from tgi_torch.invert.selfinv import gate_camera, gate_target
    from tgi_torch.metrics import ms_ssim
    from tgi_torch.render.cameras import axis_angle_rotmat

    canon = torch.cat([torch.tensor(CANONICAL_EXTRINSIC).reshape(1, 16),
                       torch.tensor(DEFAULT_INTRINSIC).reshape(1, 9)],
                      dim=-1).float().to(device)
    cpu = torch.Generator().manual_seed(seed)

    def mapping(z, psi=0.7):
        return G.mapping(params, z.to(device), canon.expand(len(z), 25),
                         truncation_psi=psi, truncation_cutoff=14)

    ws_star = mapping(torch.randn((1, G.cfg.z_dim), generator=cpu))
    cam_pose, cam_star = gate_camera(device=device)
    target = gate_target(G, params, ws_star, cam_star)[0]

    def score(ws, cam):
        img = torch.clamp(G.synthesis(params, ws, cam, det=True)["image"]
                          .float(), -1.0, 1.0)
        return {"mse": float(torch.mean(torch.square(img - target))),
                "ms_ssim": float(ms_ssim((img + 1) / 2,
                                         (target + 1) / 2).mean())}

    draws = torch.Generator().manual_seed(7)
    renders = {}
    for r in radii:
        for d in range(directions):
            u = torch.randn((1, 1, G.cfg.w_dim), generator=draws).to(device)
            renders[f"w*+{r}u{d}"] = score(ws_star + r * u / u.norm(),
                                           cam_star)
    if w_avg:
        w_mean = mapping(torch.randn((512, G.cfg.z_dim), generator=draws),
                         1.0).mean(dim=0, keepdim=True)
        renders["w_avg"] = score(w_mean, cam_star)
        renders["w_avg_dist"] = float(torch.linalg.norm(w_mean[:, 0]
                                                        - ws_star[:, 0]))
        renders["other_z"] = score(mapping(torch.randn(
            (1, G.cfg.z_dim), generator=draws)), cam_star)
    for deg in angles_deg:
        R = torch.eye(4, device=device)
        R[:3, :3] = axis_angle_rotmat(torch.randn((3,), generator=draws),
                                      math.radians(deg)).to(device)
        cam = torch.cat([(R @ cam_pose).reshape(1, 16), cam_star[:, 16:]],
                        dim=-1)
        renders[f"cam+{deg}deg"] = score(ws_star, cam)
    out = {"target_std": float(target.std(dim=(2, 3)).mean()),
           "target_mean": float(target.mean()), "renders": renders}
    if reference is not None:
        out["vs_fp32"] = {
            "mse": float(torch.mean(torch.square(target - reference))),
            "ms_ssim": float(ms_ssim((target + 1) / 2,
                                     (reference + 1) / 2).mean())}
    return out, target


@torch.no_grad()
def generator_survey(seeds, *, device, seed=GATE_SEED):
    """For each generator seed, the gate's target (as :func:`sensitivity`
    draws it): its mean, contrast (``target_std``), share of pixels
    clamped at -1 or 1, and the MSE of the render at w* moved by 3 along
    a random direction (``w3_mse``) and at the camera turned by 3 degrees
    (``cam3_mse``)."""
    out = {}
    for g in seeds:
        G, params = full_width_generator(device, seed=g)
        s, target = sensitivity(G, params, device=device, seed=seed,
                                radii=(3.0,), angles_deg=(3.0,),
                                directions=1, w_avg=False)
        out[g] = {"target_mean": s["target_mean"],
                  "target_std": s["target_std"],
                  "clamped": float((target.abs() >= 1.0).float().mean()),
                  "w3_mse": s["renders"]["w*+3.0u0"]["mse"],
                  "cam3_mse": s["renders"]["cam+3.0deg"]["mse"]}
        del G, params
    return out


def informative(row):
    """A target the gate can read: at most half its pixels clamped, and a
    w step of 3 moves the image by an MSE of at least 1e-3 (tgi's gate
    record reads a final MSE of ~1e-3). The camera is not asked for: a
    random generator's image barely turns with it."""
    return row["clamped"] <= 0.5 and row["w3_mse"] >= 1e-3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--generator-seed", default="0",
                    help="the generator's seed, or 'auto': the first of "
                    "the surveyed seeds whose target is informative")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"device": torch.cuda.get_device_name(0)}

    def done(part, value):
        out[part] = value
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f)
        print(part, json.dumps(value), flush=True)

    survey = generator_survey(SURVEY_SEEDS, device="cuda")
    done("survey", survey)
    if args.generator_seed == "auto":
        seed = next((g for g, row in survey.items() if informative(row)),
                    None)
        if seed is None:
            raise SystemExit("no surveyed generator seed gives an "
                             "informative target")
    else:
        seed = int(args.generator_seed)
    done("generator_seed", seed)
    G, params = full_width_generator("cuda", seed=seed)
    G16, _ = full_width_generator("cuda", seed=seed,
                                  fused_dtype="bfloat16")
    done("phase12", run_gate(G, params, device="cuda", num_images=64,
                             pose_steps=100, vgg_steps=50, stage1=20,
                             stage2=300, preheat=10, trace_every=10))
    s32, target = sensitivity(G, params, device="cuda")
    s16, _ = sensitivity(G16, params, device="cuda", reference=target)
    done("sensitivity", {"fp32": s32, "bf16": s16})
    done("gate_fp32", run_gate(G, params, device="cuda", trace_every=10))
    done("gate_bf16", run_gate(G16, params, device="cuda", trace_every=10))


if __name__ == "__main__":
    main()
