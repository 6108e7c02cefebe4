"""Inversion entry point: images -> latents and cameras -> tuned generator
(twin of ``tgi/apps/run_pti.py``).

Behavioral parity target: scripts/run_pti.py:16-60 +
training/coaches/single_id_coach.py:25-117. Per image:

  stage 1  joint w + camera projection (``tgi_torch.invert.projector``),
           which writes the pivots ``{name}_ws.npy`` and ``{name}_cam.npy``;
  stage 2  pivotal tuning of the generator (``tgi_torch.invert.coach``).

With ``use_last_w_pivots`` and both pivot files in the output directory,
stage 1 is skipped and the pivots are reloaded (base_coach.py:69-77).
With an e4e encoder, stage 1 starts from ``w_avg`` plus its output for the
target (w_projector.py:99-115). With ``use_locality_reg``, stage 2 adds
the locality regulariser (``losses/locality.py``). It writes
``{name}_G.pt`` (the tuned generator), ``{name}.png`` and
``{name}_pivot.png`` (where Pillow is installed), orbit videos of the
pivot and of the tuned generator (``{name}_pivot.mp4`` and
``{name}.mp4``, or GIFs where mp4 writing fails; on by default, as in
``tgi``), with ``gen_mesh`` ``{name}.ply`` (a 256³ sigma grid through
marching tetrahedra), with ``visualize_opt`` stage 1's snapshots under
``<outdir>_pivot/<name>/``, with ``do_evaluation`` ``{name}metrics.txt``
(MSE, LPIPS, MS-SSIM and, with ArcFace weights, the ID similarity;
single_id_coach.py:87-106), and ``results.json``; ``tensorboard`` and
``use_wandb`` mirror the metrics (``utils/opt_viz.py``). Images are PNG
or JPEG files, or ``.npy`` arrays in [-1, 1] where Pillow is absent
(``tgi_torch.utils.image.load_image``).

The generator comes from a reference EG3D ``.pkl`` (read by
``tgi_torch.io.pickle_import``, no code from the pickle runs) or from the
port's own ``.pt``. A ``.pkl`` runs in ``tgi``'s mixed precision: its
generator gets ``fused_dtype="bfloat16"``, stage 1 still renders in
float32 (``ProjectorConfig.render_fp32``) and stage 2 tunes in the
generator's bf16 blocks. A ``.pt`` keeps the config stored with it.

With ``batch`` > 1 the images go through in chunks of that many
(``tgi``'s ``_run_batched``, tgi/apps/run_pti.py:252-302): stage 1 by
``Projector.project_batch`` and stage 2 by ``PTICoach.tune_batch``, each
step rendering the whole chunk in one synthesis call, with every render
recomputed in the backward pass (``remat_render`` / ``remat``, as
``tgi`` sets them for a batch); then each image's outputs as above. A
chunk reuses saved pivots only when every image of it has them.
``click``, ``PIL`` and ``imageio`` are imported only where they are
used.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import time

import numpy as np
import torch

from tgi_torch import default_device
from tgi_torch.apps.gen_samples import parse_range  # noqa: F401 (tgi's API)

CAMERA_DIMS = {"2d": 2, "quat": 4, "6d": 6}   # the pose head's outputs


def list_images(directory):
    exts = (".png", ".jpg", ".jpeg", ".npy")
    return sorted(os.path.join(directory, f) for f in os.listdir(directory)
                  if f.lower().endswith(exts))


def pivot_files(out_dir, name):
    return (os.path.join(out_dir, f"{name}_ws.npy"),
            os.path.join(out_dir, f"{name}_cam.npy"))


def load_any_generator(path, fused_dtype="bfloat16", device=None):
    """A reference ``.pkl`` or the port's ``.pt`` -> (TriPlaneGenerator,
    params on ``device``).

    A ``.pkl`` gets ``fused_dtype`` (bf16 by default, as in ``tgi``); a
    ``.pt`` takes the config stored with it."""
    from tgi_torch.io.checkpoints import load_checkpoint
    from tgi_torch.io.pickle_import import load_generator
    from tgi_torch.models.generator import GeneratorConfig, TriPlaneGenerator
    device = device or default_device()
    if path.endswith(".pkl"):
        cfg, params = load_generator(path, device=device)
        return (TriPlaneGenerator(dataclasses.replace(
            cfg, fused_dtype=fused_dtype)), params)
    data = load_checkpoint(path, device=device)
    cfg = GeneratorConfig(**(data["config"] or {}))
    return TriPlaneGenerator(cfg), data["params"]


def evaluate_reconstruction(gen_img, real_img, lpips_loss, arcface_params):
    """Per-image MSE / LPIPS / MS-SSIM / ID (single_id_coach.py:87-106);
    images [1, 3, R, R] in [-1, 1]. The ID similarity needs
    ``arcface_params``."""
    from tgi_torch.metrics import ms_ssim
    with torch.no_grad():
        out = {
            "mse": float(torch.mean(torch.square(gen_img - real_img))),
            "lpips": float(lpips_loss.from_unit(gen_img, real_img).sum()),
            "ms_ssim": float(ms_ssim((gen_img + 1) / 2,
                                     (real_img + 1) / 2).mean()),
        }
        if arcface_params is not None:
            from tgi_torch.losses.id_loss import id_loss
            from tgi_torch.models.arcface import arcface_apply
            out["id_similarity"] = 1.0 - float(id_loss(
                lambda x: arcface_apply(arcface_params, x), gen_img,
                real_img))
    return out


def invert_one(name, img, *, G, gen_params, coach, out_dir, projector=None,
               target_255=None, use_last_w_pivots=True, save_pivot=True,
               generator=None, evaluate=None, gen_video=False,
               gen_mesh=False, snapshot_fn=None, tb=None, step=0):
    """Both stages for one target ``img`` ([1, 3, R, R] in [-1, 1], on the
    generator's device) named ``name``, then its outputs.

    With ``use_last_w_pivots`` and both pivot files saved in ``out_dir``,
    stage 2 starts from them. Otherwise ``projector`` runs stage 1 on
    ``target_255`` ([1, 3, 256, 256] in [0, 255], the pose net's and
    LPIPS's input), with ``img`` as the warping loss's target and
    ``snapshot_fn`` as its snapshot hook, and the pivots it finds are
    written as ``tgi`` writes them. The draws of both stages come from
    ``generator``.

    Outputs in ``tgi``'s order (single_id_coach.py:57-62, 80-116): the
    pivot grid, the pivot's orbit video (``gen_video``: 60 frames in
    batches of 4), the result grid, ``{name}_G.pt``, the tuned orbit
    video, the mesh (``gen_mesh``, at 256³). ``tb``
    (a writer of ``utils/opt_viz.py``) gets the projection losses and the
    entry's numbers at ``step``. ``evaluate(final, img) -> dict`` (see
    :func:`evaluate_reconstruction`) adds its metrics to the entry, which
    is then also written to ``{name}metrics.txt``.

    Returns (results entry, tuned params, the coach's info dict, with the
    projection's per-step metrics under ``"projection"`` when stage 1
    ran).
    """
    t0 = time.time()
    ws_file, cam_file = pivot_files(out_dir, name)
    dev = img.device
    projection = None
    if use_last_w_pivots and os.path.exists(ws_file) \
            and os.path.exists(cam_file):
        ws = torch.from_numpy(np.load(ws_file)).float().to(dev)
        cam = torch.from_numpy(np.load(cam_file)).float().to(dev)
    else:
        if projector is None or target_255 is None:
            raise ValueError(f"{name}: no saved pivots, and stage 1 needs "
                             f"a projector and target_255")
        ws, cam, _, projection = projector.project(
            target_255, generator=generator, target_full=img,
            snapshot_fn=snapshot_fn)
        if tb is not None:
            for s, v in enumerate(projection["loss"]):
                tb.scalar(f"{name}/projection_loss", v, s)
        np.save(ws_file, ws.cpu().numpy())
        np.save(cam_file, cam.cpu().numpy())

    tuned, info = coach.tune(gen_params, ws, cam, img, generator=generator)
    if projection is not None:
        info["projection"] = projection
    entry = write_outputs(name, img, G=G, gen_params=gen_params, ws=ws,
                          cam=cam, tuned=tuned, info=info, out_dir=out_dir,
                          save_pivot=save_pivot, evaluate=evaluate,
                          gen_video=gen_video, gen_mesh=gen_mesh, tb=tb,
                          step=step, t0=t0)
    return entry, tuned, info


def write_outputs(name, img, *, G, gen_params, ws, cam, tuned, info,
                  out_dir, save_pivot=True, evaluate=None, gen_video=False,
                  gen_mesh=False, tb=None, step=0, t0=None):
    """One image's outputs after stage 2 (see :func:`invert_one`) and its
    results entry, whose ``sec`` counts from ``t0``."""
    from tgi_torch.io.checkpoints import save_checkpoint
    pil = importlib.util.find_spec("PIL") is not None
    if pil:
        from tgi_torch.utils.image import save_image_grid
    if gen_video:
        from tgi_torch.apps.gen_videos import gen_interp_video
    final = None
    with torch.no_grad():
        if pil and save_pivot:
            pivot = G.synthesis(gen_params, ws, cam, det=True)["image"]
            save_image_grid(os.path.join(out_dir, f"{name}_pivot.png"),
                            torch.cat([img, pivot.float()]))
        if gen_video:
            # The pivot's orbit, before tuning (single_id_coach.py:57-62).
            gen_interp_video(G, gen_params, ws,
                             os.path.join(out_dir, f"{name}_pivot.mp4"),
                             num_frames=60, batch=4)
        if pil or evaluate is not None:
            final = G.synthesis(tuned, ws, cam, det=True)["image"].float()
        if pil:
            save_image_grid(os.path.join(out_dir, f"{name}.png"),
                            torch.cat([img, final]))
    save_checkpoint(os.path.join(out_dir, f"{name}_G.pt"), tuned,
                    config=G.cfg)
    if gen_video:
        gen_interp_video(G, tuned, ws, os.path.join(out_dir, f"{name}.mp4"),
                         num_frames=60, batch=4)
    if gen_mesh:
        from tgi_torch.apps.shape import extract_mesh
        extract_mesh(G, tuned, ws, resolution=256,
                     out_ply=os.path.join(out_dir, f"{name}.ply"))
    entry = {"image": name, "pti_steps": int(info["steps"]),
             "final_lpips": float(info["final_lpips"]),
             "sec": round(time.time() - t0, 2)}
    if tb is not None:
        tb.scalars({k: v for k, v in entry.items() if k != "image"}, step,
                   prefix=f"{name}/")
        tb.flush()
    if evaluate is not None:
        entry.update(evaluate(final, img))
        with open(os.path.join(out_dir, f"{name}metrics.txt"), "w") as f:
            json.dump(entry, f, indent=1)
    return entry


def run_pti(image_dir, out_dir, *, G, gen_params, pose_params=None,
            vgg_params=None, lpips_head=None, e4e_params=None,
            arcface_params=None,
            alex_params=None, alex_head=None, lpips_type="alex",
            use_locality_reg=False, camera_mode="quat", first_inv_steps=400,
            max_pti_steps=400, gen_video=True, gen_mesh=False,
            do_evaluation=False, save_pivot=True, use_last_w_pivots=False,
            visualize_opt=False, tensorboard=False, use_wandb=False,
            seed=0, batch=1, device=None):
    """Invert every image in ``image_dir``: stage 1, or its saved pivots
    with ``use_last_w_pivots``, then stage 2. Returns the per-image
    results (also written to ``results.json``).

    ``pose_params`` (the ResNet-34 pose estimator, its head sized for
    ``camera_mode``), ``vgg_params`` / ``lpips_head`` (VGG16 and its LPIPS
    head, stage 1's distance and warp features) and ``alex_params`` /
    ``alex_head`` (stage 2's AlexNet-LPIPS) are trees of tensors on
    ``device``; each absent one is drawn at full width from a CPU
    ``torch.Generator`` seeded with ``seed``. The draws of both stages come
    from a ``torch.Generator`` on ``device`` seeded with ``seed``.

    ``e4e_params`` (``models/e4e.py``'s tree) starts stage 1 at ``w_avg``
    plus the encoder's first code for the target; its ``latent_avg`` is
    not used, as pSp2.forward never adds it (e4e/psp.py:47-64).
    ``do_evaluation`` writes each image's metrics
    (:func:`evaluate_reconstruction`), the ID similarity with
    ``arcface_params``. ``gen_video`` (on by default, as in ``tgi``;
    it needs imageio), ``gen_mesh`` and ``visualize_opt`` add those
    outputs (:func:`invert_one`); ``use_locality_reg`` tunes
    with the locality regulariser, its z drawn with the render's draws;
    ``tensorboard`` and ``use_wandb`` mirror the metrics.

    ``batch`` > 1 inverts the images ``batch`` at a time
    (:func:`_run_batched`); each image of a chunk draws both stages from
    its own generator, seeded from the run's. ``visualize_opt`` needs a
    batch of 1 and raises ``ValueError`` otherwise, as in ``tgi``.
    """
    from tgi_torch.invert.coach import CoachConfig, PTICoach
    from tgi_torch.invert.projector import Projector, ProjectorConfig
    from tgi_torch.losses.lpips import make_lpips
    from tgi_torch.models.pose_resnet import resnet34_init
    from tgi_torch.models.vgg import lpips_head_init, vgg16_init

    device = device or default_device()
    if batch > 1 and visualize_opt:
        raise ValueError("--visualize-opt needs per-image snapshot "
                         "callbacks; run with batch=1")
    if gen_video and importlib.util.find_spec("imageio") is None:
        # tgi would find out after both stages, at the first video.
        raise ImportError("gen_video writes orbit videos with imageio, "
                          "which is not installed: install it, or pass "
                          "gen_video=False (--no-video)")
    os.makedirs(out_dir, exist_ok=True)
    weights = torch.Generator().manual_seed(seed)
    if pose_params is None:
        pose_params = resnet34_init(
            weights, output_dims=CAMERA_DIMS[camera_mode],
            device=device)
    if vgg_params is None:
        vgg_params = vgg16_init(weights, device)
    if lpips_head is None:
        lpips_head = lpips_head_init(weights, device)
    e4e_encode = None
    if e4e_params is not None:
        from tgi_torch.models.e4e import e4e_encode_w0

        def e4e_encode(target_255):
            return e4e_encode_w0(e4e_params, target_255)

    projector = Projector(G, gen_params, vgg_params, lpips_head, pose_params,
                          ProjectorConfig(num_steps=first_inv_steps,
                                          camera_mode=camera_mode,
                                          remat_render=batch > 1),
                          e4e_encode=e4e_encode)
    lp = make_lpips(lpips_type, vgg_params=vgg_params, vgg_head=lpips_head,
                    alex_params=alex_params, alex_head=alex_head,
                    generator=weights, device=device)
    locality = None
    if use_locality_reg:
        # hyperparameters.py:9 use_locality_regularization; the coach
        # passes each image's pivot camera.
        from tgi_torch.losses.locality import SpaceRegularizer
        locality = SpaceRegularizer(G, gen_params, lp)
    coach = PTICoach(G, lp, CoachConfig(max_pti_steps=max_pti_steps,
                                        remat=batch > 1),
                     locality_regularizer=locality)
    tb = None
    if tensorboard:
        from tgi_torch.utils.opt_viz import TBWriter
        tb = TBWriter(os.path.join(out_dir, "tb"))
    if use_wandb:
        # base_coach.py:107-115 / log_utils.py:9-21 (offline by default).
        from tgi_torch.utils.opt_viz import FanoutWriter, WandbWriter
        wb = WandbWriter(project="tgi-pti",
                         config=dict(first_inv_steps=first_inv_steps,
                                     max_pti_steps=max_pti_steps,
                                     camera_mode=camera_mode))
        tb = wb if tb is None else FanoutWriter([tb, wb])
    generator = torch.Generator(device=device).manual_seed(seed)
    evaluate = None
    if do_evaluation:
        def evaluate(final, img):
            return evaluate_reconstruction(final, img, lp, arcface_params)

    results = []
    try:
        if batch > 1:
            results = _run_batched(
                list_images(image_dir), out_dir, batch=batch, G=G,
                gen_params=gen_params, projector=projector, coach=coach,
                generator=generator, use_last_w_pivots=use_last_w_pivots,
                save_pivot=save_pivot, evaluate=evaluate,
                gen_video=gen_video, gen_mesh=gen_mesh, tb=tb)
        else:
            for path in list_images(image_dir):
                name = os.path.splitext(os.path.basename(path))[0]
                img, target_255 = _load_targets(path, G)
                snapshot_fn = None
                if visualize_opt:
                    from tgi_torch.utils.opt_viz import (
                        make_projection_snapshotter)
                    snapshot_fn = make_projection_snapshotter(
                        projector, out_dir, name, tb=tb)
                entry, _, _ = invert_one(
                    name, img.to(device), G=G, gen_params=gen_params,
                    coach=coach, out_dir=out_dir, projector=projector,
                    target_255=target_255.to(device),
                    use_last_w_pivots=use_last_w_pivots,
                    save_pivot=save_pivot, generator=generator,
                    evaluate=evaluate, gen_video=gen_video,
                    gen_mesh=gen_mesh, snapshot_fn=snapshot_fn, tb=tb,
                    step=len(results))
                results.append(entry)
    finally:
        if tb is not None:
            tb.close()
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    return results


def _load_targets(path, G):
    """(image [1, 3, R, R] in [-1, 1], its 256² [0, 255] version) of one
    file. ``load_image`` gives a transposed (channels-last) view;
    contiguous NCHW tensors keep the CPU convolutions on their plain
    path."""
    from tgi_torch.utils.image import load_image
    img = torch.from_numpy(np.ascontiguousarray(
        load_image(path, size=G.cfg.img_resolution)))
    target_255 = torch.from_numpy(np.ascontiguousarray(
        (load_image(path, size=256) + 1) * 127.5))
    return img, target_255


def _run_batched(paths, out_dir, *, batch, G, gen_params, projector, coach,
                 generator, use_last_w_pivots, save_pivot, evaluate,
                 gen_video, gen_mesh, tb):
    """Inversion ``batch`` images at a time (tgi/apps/run_pti.py:252-302):
    per chunk (the last may be shorter) ``project_batch`` then
    ``tune_batch``, or the chunk's saved pivots when every image of it
    has them; then each image's outputs through :func:`write_outputs`,
    its ``sec`` the image's share of the batched stages plus its own
    outputs' time. Image b of a chunk draws both stages from its own
    ``torch.Generator``, seeded from ``generator``. Returns the
    results entries."""
    results = []
    dev = projector.device
    for lo in range(0, len(paths), batch):
        chunk = paths[lo:lo + batch]
        names = [os.path.splitext(os.path.basename(p))[0] for p in chunk]
        t0 = time.time()
        seeds = torch.randint(0, 2 ** 62, (len(chunk),), generator=generator,
                              device=generator.device).tolist()
        gens = [torch.Generator(device=dev).manual_seed(s) for s in seeds]
        loaded = [_load_targets(p, G) for p in chunk]
        imgs = torch.stack([i for i, _ in loaded]).to(dev)      # [B,1,3,R,R]
        t255s = torch.stack([t for _, t in loaded]).to(dev)
        files = [pivot_files(out_dir, n) for n in names]
        projections = [None] * len(chunk)
        if use_last_w_pivots and all(os.path.exists(f) for pair in files
                                     for f in pair):
            ws_b = torch.stack([torch.from_numpy(np.load(wf)).float()
                                for wf, _ in files]).to(dev)
            cams_b = torch.stack([torch.from_numpy(np.load(cf)).float()
                                  for _, cf in files]).to(dev)
        else:
            ws_b, cams_b, _, metrics = projector.project_batch(
                t255s, targets_warp=imgs, generators=gens)
            projections = [{k: v[:, b].tolist() for k, v in metrics.items()}
                           for b in range(len(chunk))]
            for b, (name, (wf, cf)) in enumerate(zip(names, files)):
                if tb is not None:
                    for st, v in enumerate(projections[b]["loss"]):
                        tb.scalar(f"{name}/projection_loss", v, st)
                np.save(wf, ws_b[b].cpu().numpy())
                np.save(cf, cams_b[b].cpu().numpy())
        tuned_b, info_b = coach.tune_batch(gen_params, ws_b, cams_b, imgs,
                                           generators=gens)
        share = (time.time() - t0) / len(chunk)
        from tgi_torch.models.generator import take_image
        for b, name in enumerate(names):
            losses = info_b["losses"][:, b]
            info = {"steps": info_b["steps"][b],
                    "final_lpips": info_b["final_lpips"][b],
                    "losses": losses[~torch.isnan(losses)].tolist()}
            if projections[b] is not None:
                info["projection"] = projections[b]
            results.append(write_outputs(
                name, imgs[b], G=G, gen_params=gen_params, ws=ws_b[b],
                cam=cams_b[b], tuned=take_image(tuned_b, b), info=info,
                out_dir=out_dir, save_pivot=save_pivot, evaluate=evaluate,
                gen_video=gen_video, gen_mesh=gen_mesh, tb=tb,
                step=len(results), t0=time.time() - share))
    return results


def load_state_dict(path):
    """A torch state dict saved with ``torch.save`` (a module's, or one
    under ``"state_dict"``), read with ``weights_only=True``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.get("state_dict", sd)


def load_e4e_weights(path, device="cpu"):
    """An e4e/pSp checkpoint in any published layout (see
    ``models/e4e.py::convert_psp_checkpoint``) -> (params, latent_avg or
    None) on ``device``, unvalidated (:func:`validate_aux` checks it).
    Read with ``weights_only=True``: the whole checkpoint, so that
    ``latent_avg`` beside ``state_dict`` is found."""
    from tgi_torch.models.e4e import convert_psp_checkpoint
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return convert_psp_checkpoint(ckpt, validate=False, device=device)


def load_arcface_weights(path, device="cpu"):
    """A torch ArcFace ``Backbone`` state dict -> params on ``device``,
    unvalidated (:func:`validate_aux` checks it)."""
    from tgi_torch.models.arcface import convert_torch_state_dict
    return convert_torch_state_dict(load_state_dict(path), device)


def validate_aux(pose_params=None, vgg_params=None, lpips_head=None,
                 alex_params=None, alex_head=None, e4e_params=None,
                 arcface_params=None, camera_dims=4, width_mult=1.0,
                 pose_blocks=None, face_width_mult=1.0):
    """Check each converted weight tree against its init's tree of names
    and shapes, as ``tgi/apps/run_pti.py:388-449`` does; raises ValueError
    with the difference.

    The command line checks at full width: ResNet-34's blocks, 64-channel
    stems, IR-SE50's 512 channels. ``width_mult`` and ``pose_blocks`` name
    a scaled pose net and VGG, ``face_width_mult`` a scaled e4e and
    ArcFace (the tests' small nets); AlexNet and its LPIPS head are always
    full width."""
    from tgi_torch.io.validate import (arcface_spec, e4e_spec, expected_spec,
                                       validate_tree)
    from tgi_torch.models.alexnet import alex_head_init, alexnet_init
    from tgi_torch.models.pose_resnet import BLOCKS_34, resnet34_init
    from tgi_torch.models.vgg import lpips_head_init, vgg16_init
    gen = torch.Generator()
    if pose_params is not None:
        validate_tree(pose_params, expected_spec(
            resnet34_init, gen, output_dims=camera_dims,
            blocks=pose_blocks or BLOCKS_34, width_mult=width_mult),
            "pose estimator")
    if vgg_params is not None:
        validate_tree(vgg_params, expected_spec(
            vgg16_init, gen, width_mult=width_mult), "vgg16")
    if lpips_head is not None:
        validate_tree(lpips_head, expected_spec(
            lpips_head_init, gen, width_mult=width_mult), "lpips-vgg head")
    if alex_params is not None:
        validate_tree(alex_params, expected_spec(alexnet_init, gen),
                      "alexnet trunk")
    if alex_head is not None:
        validate_tree(alex_head, expected_spec(alex_head_init, gen),
                      "lpips-alex head")
    if e4e_params is not None:
        validate_tree(e4e_params, e4e_spec(face_width_mult), "e4e encoder")
    if arcface_params is not None:
        validate_tree(arcface_params, arcface_spec(face_width_mult),
                      "arcface")


def main(argv=None):
    """Command line: ``python -m tgi_torch.apps.run_pti --network G.pt
    --images DIR --outdir DIR``. The options mirror ``tgi``'s."""
    import click

    @click.command()
    @click.option("--network", required=True,
                  help="a reference EG3D .pkl, which runs in bf16 mixed "
                       "precision as tgi's does (stage 1 still renders in "
                       "float32, stage 2 tunes in the bf16 blocks), or the "
                       "port's .pt checkpoint, which keeps its stored "
                       "config")
    @click.option("--images", "image_dir", required=True)
    @click.option("--outdir", "out_dir", required=True)
    @click.option("--pose-weights", default=None,
                  help="pose_estimator state dict .pt (stage 1)")
    @click.option("--e4e-weights", default=None,
                  help="e4e/pSp checkpoint .pt (any published layout): "
                       "stage 1 starts at w_avg + its code for the target")
    @click.option("--vgg-weights", default=None,
                  help="torchvision vgg16 state dict .pt, with the lpips "
                       "head's lin{i} weights where it has them (stage 1)")
    @click.option("--arcface-weights", default=None,
                  help="ArcFace IR-SE50 state dict .pt: --eval's ID "
                       "similarity")
    @click.option("--lpips-weights", default=None,
                  help="lpips-package LPIPS(net='alex') state dict .pt")
    @click.option("--lpips-type", default="alex",
                  type=click.Choice(["alex", "vgg"]),
                  help="stage-2 tuning loss backbone (hyperparameters.py:2)")
    @click.option("--use-locality-reg/--no-locality-reg", default=False,
                  help="Space_Regulizer during tuning (hyperparameters.py:9)")
    @click.option("--allow-random-init", is_flag=True, default=False,
                  help="permit random init when weight files are absent "
                       "(smoke tests only — outputs are garbage)")
    @click.option("--camera-mode", default="quat",
                  type=click.Choice(["2d", "quat", "6d"]),
                  help="the pose head's rotation parameterization")
    @click.option("--first-inv-steps", default=400,
                  help="stage-1 projection steps")
    @click.option("--max-pti-steps", default=400)
    @click.option("--batch", default=1,
                  help="invert N images at once (project_batch + "
                       "tune_batch; each image's own inversion, one render "
                       "of all N per step)")
    @click.option("--use-last-w-pivots/--no-use-last-w-pivots",
                  default=False,
                  help="reload saved (ws, cam) pivots instead of running "
                       "stage 1 (base_coach.py:69-77)")
    @click.option("--video/--no-video", "gen_video", default=True,
                  help="orbit videos of the pivot and the tuned generator")
    @click.option("--mesh/--no-mesh", "gen_mesh", default=False,
                  help="the tuned generator's mesh at 256³, {name}.ply")
    @click.option("--eval/--no-eval", "do_evaluation", default=False)
    @click.option("--visualize-opt/--no-visualize-opt", default=False,
                  help="reconstruction and warp PNGs every 10 projection "
                       "steps (w_projector.py:193-212)")
    @click.option("--tensorboard/--no-tensorboard", default=False,
                  help="mirror metrics and images to <outdir>/tb")
    @click.option("--wandb/--no-wandb", "use_wandb", default=False,
                  help="mirror metrics and images to wandb (offline mode)")
    @click.option("--seed", default=0,
                  help="draws of both stages, and the weights of every "
                       "network without a weight file")
    @click.option("--device", default=default_device())
    def cli(network, image_dir, out_dir, pose_weights, e4e_weights,
            vgg_weights, arcface_weights, lpips_weights, lpips_type,
            use_locality_reg, allow_random_init, camera_mode,
            first_inv_steps, max_pti_steps, batch, use_last_w_pivots,
            gen_video, gen_mesh, do_evaluation, visualize_opt, tensorboard,
            use_wandb, seed, device):
        from tgi_torch.io.from_jax import params_from_numpy
        from tgi_torch.models.alexnet import convert_lpips_alex
        from tgi_torch.models.pose_resnet import convert_torch_state_dict
        from tgi_torch.models.vgg import (convert_lpips_head,
                                          convert_torch_features)

        def require(path, flag):
            """A weight file that is named must exist; one that is absent
            needs --allow-random-init."""
            if path and not os.path.exists(path):
                raise click.ClickException(f"{flag}: file not found: {path}")
            if not path and not allow_random_init:
                raise click.ClickException(
                    f"{flag} is required (or pass --allow-random-init for "
                    f"a smoke run with random weights)")
            if not path:
                click.echo(f"WARNING: random-init weights (no {flag}), "
                           f"drawn from --seed {seed}")
            return bool(path)

        G, gen_params = load_any_generator(network, device=device)
        pose_params = vgg_params = lpips_head = None
        if require(pose_weights, "--pose-weights"):
            pose_params = convert_torch_state_dict(
                load_state_dict(pose_weights), device)
        if require(vgg_weights, "--vgg-weights"):
            sd = load_state_dict(vgg_weights)
            vgg_params = convert_torch_features(sd, device)
            lpips_head = convert_lpips_head(sd, device) or None

        alex_params = alex_head = None
        if lpips_type == "alex" and require(lpips_weights,
                                            "--lpips-weights"):
            alex_params, alex_head = (
                params_from_numpy(t, device) for t in
                convert_lpips_alex(load_state_dict(lpips_weights)))
        e4e_params = arcface_params = None
        for path, flag in ((e4e_weights, "--e4e-weights"),
                           (arcface_weights, "--arcface-weights")):
            if path and not os.path.exists(path):
                raise click.ClickException(f"{flag}: file not found: {path}")
        if e4e_weights:
            # latent_avg is not used: pSp2.forward never adds it.
            e4e_params, _ = load_e4e_weights(e4e_weights, device)
        if arcface_weights:
            arcface_params = load_arcface_weights(arcface_weights, device)
        validate_aux(pose_params, vgg_params, lpips_head, alex_params,
                     alex_head, e4e_params, arcface_params,
                     camera_dims=CAMERA_DIMS[camera_mode])

        for r in run_pti(image_dir, out_dir, G=G, gen_params=gen_params,
                         pose_params=pose_params, vgg_params=vgg_params,
                         lpips_head=lpips_head, e4e_params=e4e_params,
                         arcface_params=arcface_params,
                         alex_params=alex_params,
                         alex_head=alex_head, lpips_type=lpips_type,
                         use_locality_reg=use_locality_reg,
                         camera_mode=camera_mode,
                         first_inv_steps=first_inv_steps,
                         max_pti_steps=max_pti_steps, gen_video=gen_video,
                         gen_mesh=gen_mesh, do_evaluation=do_evaluation,
                         use_last_w_pivots=use_last_w_pivots,
                         visualize_opt=visualize_opt,
                         tensorboard=tensorboard, use_wandb=use_wandb,
                         seed=seed, batch=batch, device=device):
            click.echo(json.dumps(r))

    cli.main(args=argv, standalone_mode=True)


if __name__ == "__main__":
    main()
