"""Inversion entry point: images -> tuned generator (twin of
``tgi/apps/run_pti.py``), stage 2 only.

Behavioral parity target: scripts/run_pti.py:16-60 +
training/coaches/single_id_coach.py:25-117. Per image ``tgi`` runs

  stage 1  joint w + camera projection (tgi.invert.Projector)
  stage 2  pivotal tuning of the generator (tgi.invert.PTICoach)

This port runs the resume path of ``tgi`` (``use_last_w_pivots``,
base_coach.py:69-77): the pivots ``{name}_ws.npy`` and ``{name}_cam.npy``
saved in the output directory are reloaded and only stage 2 runs. It
writes ``{name}_G.pt`` (the tuned generator), ``{name}.png`` and
``{name}_pivot.png`` (where Pillow is installed) and ``results.json``.

Not ported yet, and refused with ``NotImplementedError`` rather than
skipped: stage 1 (ROADMAP Queue A item 7), orbit videos, meshes and
metrics (items 9, 11, 15), the locality regulariser (item 8), batched
inversion (item 18), tensorboard and wandb (item 9), and reference
``.pkl`` generators (item 9). ``click`` and ``PIL`` are imported only
where they are used.
"""

from __future__ import annotations

import importlib.util
import json
import os
import time

import numpy as np
import torch

from tgi_torch import default_device
from tgi_torch.apps.gen_samples import parse_range  # noqa: F401 (tgi's API)

STAGE1 = "stage 1 (projection) is ROADMAP Queue A item 7"


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported yet "
                               f"(ROADMAP Queue A item {item})")


def list_images(directory):
    exts = (".png", ".jpg", ".jpeg")
    return sorted(os.path.join(directory, f) for f in os.listdir(directory)
                  if f.lower().endswith(exts))


def pivot_files(out_dir, name):
    return (os.path.join(out_dir, f"{name}_ws.npy"),
            os.path.join(out_dir, f"{name}_cam.npy"))


def load_generator(path, device):
    """The port's ``.pt`` checkpoint -> (TriPlaneGenerator, params)."""
    from tgi_torch.io.checkpoints import load_checkpoint
    from tgi_torch.models.generator import GeneratorConfig, TriPlaneGenerator
    if path.endswith(".pkl"):
        raise _not_ported("reading a reference .pkl (io/pickle_import.py)",
                          9)
    data = load_checkpoint(path, device=device)
    cfg = GeneratorConfig(**(data["config"] or {}))
    return TriPlaneGenerator(cfg), data["params"]


def invert_one(name, img, *, G, gen_params, coach, out_dir,
               use_last_w_pivots=True, save_pivot=True, generator=None):
    """Stage 2 for one target ``img`` ([1, 3, R, R] in [-1, 1], on the
    generator's device) named ``name``, from its saved pivots.

    Returns (results entry, tuned params, the coach's info dict).
    """
    from tgi_torch.io.checkpoints import save_checkpoint
    t0 = time.time()
    ws_file, cam_file = pivot_files(out_dir, name)
    if not (use_last_w_pivots and os.path.exists(ws_file)
            and os.path.exists(cam_file)):
        raise NotImplementedError(STAGE1)
    dev = img.device
    ws = torch.from_numpy(np.load(ws_file)).float().to(dev)
    cam = torch.from_numpy(np.load(cam_file)).float().to(dev)

    tuned, info = coach.tune(gen_params, ws, cam, img, generator=generator)

    if importlib.util.find_spec("PIL") is not None:
        from tgi_torch.utils.image import save_image_grid
        with torch.no_grad():
            if save_pivot:
                pivot = G.synthesis(gen_params, ws, cam, det=True)["image"]
                save_image_grid(os.path.join(out_dir, f"{name}_pivot.png"),
                                torch.cat([img, pivot]))
            final = G.synthesis(tuned, ws, cam, det=True)["image"]
            save_image_grid(os.path.join(out_dir, f"{name}.png"),
                            torch.cat([img, final]))
    save_checkpoint(os.path.join(out_dir, f"{name}_G.pt"), tuned,
                    config=G.cfg)
    entry = {"image": name, "pti_steps": int(info["steps"]),
             "final_lpips": float(info["final_lpips"]),
             "sec": round(time.time() - t0, 2)}
    return entry, tuned, info


def run_pti(image_dir, out_dir, *, G, gen_params, alex_params=None,
            alex_head=None, lpips_type="alex", use_locality_reg=False,
            max_pti_steps=400, gen_video=False, gen_mesh=False,
            do_evaluation=False, save_pivot=True, use_last_w_pivots=False,
            visualize_opt=False, tensorboard=False, use_wandb=False,
            seed=0, batch=1, device=None):
    """Invert every image in ``image_dir`` from its saved pivots. Returns
    the per-image results (also written to ``results.json``).

    ``alex_params`` / ``alex_head``: LPIPS weights, tensors on
    ``device``; absent, they are drawn from ``seed``. The
    render's draws come from a ``torch.Generator`` seeded with ``seed``.
    """
    from tgi_torch.invert.coach import CoachConfig, PTICoach
    from tgi_torch.losses.lpips import make_lpips
    from tgi_torch.utils.image import load_image

    device = device or default_device()
    for flag, what, item in ((gen_video, "gen_video (orbit videos)", 11),
                             (gen_mesh, "gen_mesh (apps/shape.py)", 11),
                             (do_evaluation, "do_evaluation (metrics)", 9),
                             (use_locality_reg, "losses/locality.py", 8),
                             (visualize_opt, "visualize_opt (stage 1)", 7),
                             (tensorboard, "tensorboard", 9),
                             (use_wandb, "wandb", 9),
                             (batch > 1, "batch > 1 (tune_batch)", 18)):
        if flag:
            raise _not_ported(what, item)
    os.makedirs(out_dir, exist_ok=True)
    lp = make_lpips(lpips_type, alex_params=alex_params, alex_head=alex_head,
                    generator=torch.Generator().manual_seed(seed),
                    device=device)
    coach = PTICoach(G, lp, CoachConfig(max_pti_steps=max_pti_steps))
    generator = torch.Generator(device=device).manual_seed(seed)

    results = []
    for path in list_images(image_dir):
        name = os.path.splitext(os.path.basename(path))[0]
        img = torch.from_numpy(load_image(path, size=G.cfg.img_resolution))
        entry, _, _ = invert_one(
            name, img.to(device), G=G, gen_params=gen_params, coach=coach,
            out_dir=out_dir, use_last_w_pivots=use_last_w_pivots,
            save_pivot=save_pivot, generator=generator)
        results.append(entry)
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    return results


def main(argv=None):
    """Command line: ``python -m tgi_torch.apps.run_pti --network G.pt
    --images DIR --outdir DIR --use-last-w-pivots``. The options mirror
    ``tgi``'s; those of parts not ported yet raise when set."""
    import click

    @click.command()
    @click.option("--network", required=True,
                  help="the port's .pt generator checkpoint")
    @click.option("--images", "image_dir", required=True)
    @click.option("--outdir", "out_dir", required=True)
    @click.option("--pose-weights", default=None,
                  help="pose_estimator .pt (stage 1)")
    @click.option("--e4e-weights", default=None, help="(stage 1)")
    @click.option("--vgg-weights", default=None, help="(stage 1)")
    @click.option("--arcface-weights", default=None, help="(--eval)")
    @click.option("--lpips-weights", default=None,
                  help="lpips-package LPIPS(net='alex') state dict .pt")
    @click.option("--lpips-type", default="alex",
                  type=click.Choice(["alex", "vgg"]),
                  help="stage-2 tuning loss backbone (hyperparameters.py:2)")
    @click.option("--use-locality-reg/--no-locality-reg", default=False)
    @click.option("--allow-random-init", is_flag=True, default=False,
                  help="permit random init when weight files are absent "
                       "(smoke tests only — outputs are garbage)")
    @click.option("--camera-mode", default="quat",
                  type=click.Choice(["2d", "quat", "6d"]), help="(stage 1)")
    @click.option("--first-inv-steps", default=400, help="(stage 1)")
    @click.option("--max-pti-steps", default=400)
    @click.option("--batch", default=1)
    @click.option("--use-last-w-pivots/--no-use-last-w-pivots",
                  default=False,
                  help="reload saved (ws, cam) pivots instead of running "
                       "stage 1 (base_coach.py:69-77); stage 1 is not "
                       "ported, so this is required")
    @click.option("--video/--no-video", "gen_video", default=False)
    @click.option("--mesh/--no-mesh", "gen_mesh", default=False)
    @click.option("--eval/--no-eval", "do_evaluation", default=False)
    @click.option("--visualize-opt/--no-visualize-opt", default=False)
    @click.option("--tensorboard/--no-tensorboard", default=False)
    @click.option("--wandb/--no-wandb", "use_wandb", default=False)
    @click.option("--device", default=default_device())
    def cli(network, image_dir, out_dir, pose_weights, e4e_weights,
            vgg_weights, arcface_weights, lpips_weights, lpips_type,
            use_locality_reg, allow_random_init, camera_mode,
            first_inv_steps, max_pti_steps, batch, use_last_w_pivots,
            gen_video, gen_mesh, do_evaluation, visualize_opt, tensorboard,
            use_wandb, device):
        from tgi_torch.io.from_jax import params_from_numpy
        from tgi_torch.models.alexnet import convert_lpips_alex

        for path, flag in ((pose_weights, "--pose-weights"),
                           (e4e_weights, "--e4e-weights"),
                           (vgg_weights, "--vgg-weights"),
                           (arcface_weights, "--arcface-weights")):
            if path:
                click.echo(f"WARNING: {flag} is read by a part not ported "
                           f"yet ({STAGE1}; metrics: item 15); ignored")
        G, gen_params = load_generator(network, device)

        alex_params = alex_head = None
        if lpips_type == "alex":
            if lpips_weights:
                if not os.path.exists(lpips_weights):
                    raise click.ClickException(
                        f"--lpips-weights: file not found: {lpips_weights}")
                sd = torch.load(lpips_weights, map_location="cpu",
                                weights_only=True)
                alex_params, alex_head = (
                    params_from_numpy(t, device)
                    for t in convert_lpips_alex(sd.get("state_dict", sd)))
            elif not allow_random_init:
                raise click.ClickException(
                    "--lpips-weights is required (or pass "
                    "--allow-random-init for a smoke run with random "
                    "weights)")
            else:
                click.echo("WARNING: random-init alex-LPIPS "
                           "(no --lpips-weights)")

        for r in run_pti(image_dir, out_dir, G=G, gen_params=gen_params,
                         alex_params=alex_params, alex_head=alex_head,
                         lpips_type=lpips_type,
                         use_locality_reg=use_locality_reg,
                         max_pti_steps=max_pti_steps, gen_video=gen_video,
                         gen_mesh=gen_mesh, do_evaluation=do_evaluation,
                         use_last_w_pivots=use_last_w_pivots,
                         visualize_opt=visualize_opt,
                         tensorboard=tensorboard, use_wandb=use_wandb,
                         batch=batch, device=device):
            click.echo(json.dumps(r))

    cli.main(args=argv, standalone_mode=True)


if __name__ == "__main__":
    main()
