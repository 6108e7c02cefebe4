"""Self-inversion quality gate (twin of ``tgi/invert/selfinv.py``).

Generates a target from the generator itself at a known (w*, cam*), runs
the real two-stage PTI pipeline (Projector -> PTICoach, the classes
``run_pti`` drives), and reports reconstruction quality plus pose
recovery: closed-loop evidence that the inversion machinery inverts
(reference quality protocol: single_id_coach.py:87-106). It needs no
external weights: the optimum (w*, cam*) exists by construction, and
MS-SSIM, MSE and the pose error are weight-free metrics.

Draws: ``seed`` seeds the target's z and the aim axis (a CPU generator),
stage 1 (a generator on the device seeded ``seed + 1``) and stage 2
(``seed + 2``; the early-stop probe re-runs stage 2 from the same seed,
as ``tgi`` re-uses its key). ``tgi``'s ``dispatch_chunk`` (a TPU-relay
guard) has no counterpart; the quality trace (``qconv``) is taken every
``trace_every`` tuning steps from ``PTICoach.tune``'s ``checkpoint_fn``.

``self_inversion_eval_batch`` (``tgi``'s, selfinv.py:285-420) inverts B
such targets at once through ``Projector.project_batch`` and
``PTICoach.tune_batch``; image 0 takes the single gate's target, camera
and seeds, so its numbers compare with ``self_inversion_eval``'s.
"""

from __future__ import annotations

import math
import time
from dataclasses import replace

import torch

from tgi_torch.apps.run_pti import evaluate_reconstruction
from tgi_torch.invert.coach import CoachConfig, PTICoach, _leaves
from tgi_torch.invert.projector import (Projector, ProjectorConfig,
                                        assemble_camera)
from tgi_torch.losses.warp import area_downsample, bilinear_resize_nchw
from tgi_torch.models.generator import take_image
from tgi_torch.models.pose_resnet import (resnet34_apply, resnet34_calibrate,
                                          stack_nets)
from tgi_torch.render.cameras import (axis_angle_rotmat, fov_to_intrinsics,
                                      look_at_pose, pack_camera,
                                      rotmat_to_quat, rotmat_to_rot6d)


def rotation_error_deg(cam_a, cam_b):
    """Geodesic angle (degrees) between the extrinsic rotations of two
    packed [N, 25] cameras."""
    Ra = cam_a[:, :16].reshape(-1, 4, 4)[:, :3, :3]
    Rb = cam_b[:, :16].reshape(-1, 4, 4)[:, :3, :3]
    tr = torch.einsum("nij,nij->n", Ra, Rb)
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos))


@torch.no_grad()
def aim_pose_net(pose_params, target_255, true_rotmat, *, err_deg=3.0,
                 camera_mode="quat", generator=None, axis=None,
                 calibrate=True):
    """Pose-net params whose prediction for this target is
    ``true_rotmat`` turned by ``err_deg`` about a random axis (``axis``
    [3], or a unit normal from ``generator``, a CPU torch.Generator).

    The reference's estimator is pretrained (run_pti.py:36-45) and stage
    1 only refines it at a quat camera lr of 6e-7. Two repairs restore
    that operating point without external weights:

      1. ``calibrate``: every BatchNorm's running statistics from a real
         forward pass (``resnet34_calibrate``); identity statistics
         saturate tanh for every input;
      2. the final layer's bias shifted so tanh(fc3(...)) equals the
         desired parameterization at this input.

    Every weight stays real and gradients flow through the whole net as
    in the reference. The caller's params are not changed."""
    if calibrate:
        pose_params = resnet34_calibrate(pose_params, target_255)
    if axis is None:
        axis = torch.randn((3,), generator=generator)
    dev = target_255.device
    Rp = true_rotmat.to(dev) @ axis_angle_rotmat(
        axis.to(dev), math.radians(err_deg))
    if camera_mode == "quat":
        desired = rotmat_to_quat(Rp[None])[0]
    elif camera_mode == "6d":
        desired = rotmat_to_rot6d(Rp[None])[0]
    else:
        raise ValueError(f"aim_pose_net: unsupported mode {camera_mode!r}"
                         " (euler '2d' heads aim via angle offsets)")
    y = resnet34_apply(pose_params, target_255, pre_tanh=True)[0]
    y_des = torch.arctanh(torch.clamp(desired, -0.999, 0.999))
    fc3 = pose_params["fc3"]
    return {**pose_params, "fc3": {**fc3, "bias": fc3["bias"]
                                   + (y_des - y)}}


def gate_camera(yaw_offset=0.35, pitch_offset=0.12, device="cuda"):
    """(cam2world [4, 4], packed camera [1, 25]) of the gate's target:
    off-frontal by (yaw, pitch) around the FFHQ pivot."""
    cam_pose = look_at_pose(math.pi / 2 + yaw_offset,
                            math.pi / 2 + pitch_offset,
                            torch.tensor([0.0, 0.0, 0.2]), radius=2.7,
                            device=device)
    return cam_pose, pack_camera(cam_pose[None],
                                 fov_to_intrinsics(18.837, device))


@torch.no_grad()
def gate_target(G, gen_params, ws_star, cam_star):
    """(target [1, 3, R, R] in [-1, 1], its 256² [0, 255] version, the
    pose net's and LPIPS's input): area-shrunk above 256², enlarged as
    ``jax.image.resize(..., "linear")`` below it."""
    target = torch.clamp(G.synthesis(gen_params, ws_star, cam_star,
                                     det=True)["image"].float(), -1.0, 1.0)
    res = target.shape[-1]
    t256 = (area_downsample(target, 256) if res > 256 else
            bilinear_resize_nchw(target, 256) if res < 256 else target)
    return target, (t256 + 1.0) * 127.5


@torch.no_grad()
def reconstruction_quality(G, params, ws, cam, target, lpips_loss):
    """{"mse", "lpips", "ms_ssim"} of the deterministic render of
    ``params`` at (ws, cam) against ``target`` ([-1, 1])."""
    img = torch.clamp(G.synthesis(params, ws, cam, det=True)["image"]
                      .float(), -1.0, 1.0)
    return evaluate_reconstruction(img, target, lpips_loss, None)


def self_inversion_eval(G, gen_params, *, seed=0, vgg_params, lpips_head,
                        pose_params, lpips_loss, first_inv_steps=400,
                        max_pti_steps=400, yaw_offset=0.35,
                        pitch_offset=0.12, camera_mode="quat",
                        truncation_psi=0.7, w_avg_samples=512,
                        render_fp32=False, target_G=None, aim_pose_deg=3.0,
                        pti_lpips_threshold=0.0, proj_overrides=None,
                        early_stop_probe=None, e4e_encode=None,
                        aim_calibrate=True, trace_every=None, log=None):
    """Invert a G-generated target; return quality and pose metrics.

    Mirrors run_pti's per-image path: stage 1 = ``Projector.project``,
    stage 2 = ``PTICoach.tune``.

    ``target_G`` renders the target with another generator config (the
    same params), e.g. full sampling for a reduced-sampling pipeline.
    ``aim_pose_deg`` starts the pose net that many degrees off the true
    rotation (:func:`aim_pose_net`; ``aim_calibrate=False`` for
    bootstrapped nets, whose statistics are already set); None or 0
    leaves the net as it is. ``pti_lpips_threshold`` is stage 2's early
    stop, 0 by default: the production 0.06 is calibrated for pretrained
    AlexNet-LPIPS. ``proj_overrides``: extra ``ProjectorConfig`` fields.
    ``early_stop_probe`` (e.g. 0.06): also run stage 2 from the same
    pivot with that stop and report ``es_*`` (steps and quality at the
    stop). ``trace_every``: every that many tuning steps trace MS-SSIM
    (``quality_trace``, as ``tgi``'s) and MSE (``mse_trace``), and every
    that many stage-1 steps the camera's and w's errors
    (``stage1_trace``: step, the mean stage-1 loss since the last entry,
    the pose error in degrees, the w error);
    ``qconv_steps`` is the first traced tuning step within 0.01 of the
    final MS-SSIM. ``log`` receives a line per stage.

    Beside ``tgi``'s keys the result has the target's contrast
    (``target_std``: each channel's standard deviation over the pixels,
    averaged; a flat target makes every image metric read well), stage
    2's first and last tuning loss (``stage2_first_loss``,
    ``stage2_final_loss``) and each
    stage's host seconds (``stage1_s``, ``stage2_s`` with its quality
    trace, ``es_s``); every step reads its loss back, so the clock sees
    the device's work.
    """
    dev = next(_leaves(gen_params)).device
    cpu = torch.Generator().manual_seed(seed)
    proj_cfg = ProjectorConfig(num_steps=first_inv_steps,
                               camera_mode=camera_mode,
                               w_avg_samples=w_avg_samples,
                               render_fp32=render_fp32)
    if proj_overrides:
        proj_cfg = replace(proj_cfg, **proj_overrides)
    proj = Projector(G, gen_params, vgg_params, lpips_head, pose_params,
                     proj_cfg, e4e_encode=e4e_encode)

    # Known ground truth: w* from a random z at the canonical camera,
    # cam* off-frontal by (yaw, pitch).
    z = torch.randn((1, G.cfg.z_dim), generator=cpu).to(dev)
    with torch.no_grad():
        ws_star = G.mapping(gen_params, z, proj.canonical_cam,
                            truncation_psi=truncation_psi,
                            truncation_cutoff=14)
    cam_pose, cam_star = gate_camera(yaw_offset, pitch_offset, dev)
    target, target_255 = gate_target(target_G or G, gen_params, ws_star,
                                     cam_star)

    def camera_of(pose):
        with torch.no_grad():
            return assemble_camera(resnet34_apply(pose, target_255),
                                   torch.zeros((1, 3), device=dev),
                                   camera_mode, 2.7, proj.intrinsic)[1]

    net_pose_err = None
    if aim_pose_deg:
        # The un-aimed net's own error is recorded as net_pose_err_deg,
        # so the bootstrap's capability stays visible.
        net_pose_err = float(rotation_error_deg(camera_of(pose_params),
                                                cam_star)[0])
        pose_params = aim_pose_net(pose_params, target_255,
                                   cam_pose[:3, :3], err_deg=aim_pose_deg,
                                   camera_mode=camera_mode, generator=cpu,
                                   calibrate=aim_calibrate)
        proj = Projector(G, gen_params, vgg_params, lpips_head, pose_params,
                         proj_cfg, e4e_encode=e4e_encode)
    init_pose_err = float(rotation_error_deg(camera_of(pose_params),
                                             cam_star)[0])

    # Stage 1 (the full-resolution [-1, 1] target for the warp loss, as
    # run_pti).
    s1trace = []

    @torch.no_grad()
    def stage1_ckpt(step, state, t255):
        if step % trace_every == 0 or step == first_inv_steps:
            pred = proj.camera(state["pose"], state["translation"], t255)[1]
            s1trace.append((step, float(rotation_error_deg(pred,
                                                           cam_star)[0]),
                            float(torch.linalg.norm(state["w"][:, 0]
                                                    - ws_star[:, 0]))))

    t0 = time.perf_counter()
    ws, cam, _, metrics = proj.project(
        target_255, target_full=target,
        generator=torch.Generator(device=dev).manual_seed(seed + 1),
        snapshot_fn=stage1_ckpt if trace_every else None,
        snapshot_every=trace_every or 10)
    if log:
        log(f"self-inversion stage 1: {len(metrics['loss'])} steps, loss "
            f"{metrics['loss'][0]:.5g} -> {metrics['loss'][-1]:.5g}")

    def quality(p):
        return reconstruction_quality(G, p, ws, cam, target, lpips_loss)

    # Stage 2, with the quality trace: the reference stops tuning once
    # its (pretrained) LPIPS crosses 0.06, i.e. at quality convergence
    # (single_id_coach.py:69). The weight-free analog is the first traced
    # step whose MS-SSIM is within 0.01 of the full-budget final.
    qtrace = []

    def quality_ckpt(step, p):
        if step % trace_every == 0 or step == max_pti_steps:
            qtrace.append((step, quality(p)))

    def tune(threshold, checkpoint_fn=None):
        coach = PTICoach(G, lpips_loss,
                         CoachConfig(max_pti_steps=max_pti_steps,
                                     lpips_threshold=threshold))
        return coach.tune(
            gen_params, ws, cam, target, checkpoint_fn=checkpoint_fn,
            generator=torch.Generator(device=dev).manual_seed(seed + 2))

    t1 = time.perf_counter()
    tuned, info = tune(pti_lpips_threshold,
                       quality_ckpt if trace_every else None)
    t2 = time.perf_counter()
    if log:
        log(f"self-inversion stage 2: {info['steps']} steps, loss "
            f"{info['losses'][0]:.5g} -> {info['losses'][-1]:.5g}")
    es = tune(early_stop_probe) if early_stop_probe else None
    t3 = time.perf_counter()

    out = {"pivot_" + k: v for k, v in quality(gen_params).items()}
    out.update({"final_" + k: v for k, v in quality(tuned).items()})
    out.update({
        "pose_err_deg": float(rotation_error_deg(cam, cam_star)[0]),
        "pti_steps": int(info["steps"]),
        "pti_final_lpips": float(info["final_lpips"]),
        "stage1_final_loss": float(metrics["loss"][-1]),
        "stage1_first_loss": float(metrics["loss"][0]),
        "stage2_final_loss": float(info["losses"][-1]),
        "stage2_first_loss": float(info["losses"][0]),
        "w_err": float(torch.linalg.norm(ws[:, 0] - ws_star[:, 0])),
        "init_pose_err_deg": init_pose_err,
        "target_std": float(target.std(dim=(2, 3)).mean()),
        "stage1_s": t1 - t0,
        "stage2_s": t2 - t1,
    })
    if net_pose_err is not None:
        out["net_pose_err_deg"] = net_pose_err
    if qtrace:
        bar = out["final_ms_ssim"] - 0.01
        hit = [(s, q["ms_ssim"]) for s, q in qtrace if q["ms_ssim"] >= bar]
        qs, qm = hit[0] if hit else (int(info["steps"]),
                                     out["final_ms_ssim"])
        out["qconv_steps"] = int(qs)
        out["qconv_ms_ssim"] = float(qm)
        out["quality_trace"] = [(s, round(q["ms_ssim"], 4))
                                for s, q in qtrace]
        out["mse_trace"] = [(s, q["mse"]) for s, q in qtrace]
        losses = metrics["loss"]
        out["stage1_trace"] = [
            (s, sum(losses[a:s]) / (s - a), pose, w)
            for (a, _, _), (s, pose, w) in zip([(0, 0, 0)] + s1trace,
                                               s1trace)]
    if es is not None:
        tuned_es, info_es = es
        out.update({"es_" + k: v for k, v in quality(tuned_es).items()})
        out["es_steps"] = int(info_es["steps"])
        out["es_threshold"] = float(early_stop_probe)
        out["es_s"] = t3 - t2
    return out



# Per-image (yaw, pitch) offsets of the batched gate's targets; image 0
# is the single gate's default, so its numbers compare with it.
_BATCH_POSE_OFFSETS = ((0.35, 0.12), (-0.3, 0.08), (0.25, -0.1),
                       (-0.2, -0.15))
# Image i of the batched gate draws from seeds seed + SEED_STRIDE * i
# (target and aim), + 1 (stage 1) and + 2 (stage 2): image 0 from the
# single gate's seeds.
SEED_STRIDE = 10


def self_inversion_eval_batch(G, gen_params, *, seed=0, vgg_params,
                              lpips_head, pose_params, lpips_loss,
                              batch_size=4, first_inv_steps=400,
                              max_pti_steps=400, camera_mode="quat",
                              truncation_psi=0.7, w_avg_samples=512,
                              render_fp32=False, aim_pose_deg=3.0,
                              pti_lpips_threshold=0.0, aim_calibrate=True,
                              proj_overrides=None, e4e_encode=None,
                              log=None):
    """The gate for batched inversion: ``batch_size`` targets with known
    (w*, cam*), the cameras at ``_BATCH_POSE_OFFSETS``, inverted at once
    by ``Projector.project_batch`` (``remat_render`` on, as ``tgi``'s
    batched gate sets it) and ``PTICoach.tune_batch`` (``remat`` on),
    each image with its own aimed pose net. The reference's per-image
    semantics (w_projector.py:62, 120-131) must hold at B > 1: image 0
    takes :func:`self_inversion_eval`'s seeds (``SEED_STRIDE``), so
    ``per_image[0]`` equals that gate's numbers up to reassociation.

    Arguments as :func:`self_inversion_eval`'s; ``e4e_encode`` (which
    ``tgi``'s batched gate does not take) starts each image at its own
    e4e code, so the batched gate can run beside the single gate with
    the same bootstrapped nets. Returns {"per_image": [{"final_mse",
    "final_lpips", "final_ms_ssim", "pivot_mse", "pivot_ms_ssim",
    "pose_err_deg", "pti_steps", "w_err", "init_pose_err_deg"}, ...],
    "mean_final_ms_ssim", "mean_final_mse", "max_pose_err_deg",
    "stage1_s", "stage2_s", "seconds_per_image"}, the seconds by the
    host's clock (each step reads its losses back).
    """
    dev = next(_leaves(gen_params)).device
    B = batch_size
    proj_cfg = ProjectorConfig(num_steps=first_inv_steps,
                               camera_mode=camera_mode,
                               w_avg_samples=w_avg_samples,
                               render_fp32=render_fp32, remat_render=True)
    if proj_overrides:
        proj_cfg = replace(proj_cfg, **proj_overrides)
    proj = Projector(G, gen_params, vgg_params, lpips_head, pose_params,
                     proj_cfg, e4e_encode=e4e_encode)
    targets, t255s, cams_star, ws_stars, nets, init_errs = ([] for _ in
                                                            range(6))
    for i in range(B):
        cpu = torch.Generator().manual_seed(seed + SEED_STRIDE * i)
        z = torch.randn((1, G.cfg.z_dim), generator=cpu).to(dev)
        with torch.no_grad():
            ws_star = G.mapping(gen_params, z, proj.canonical_cam,
                                truncation_psi=truncation_psi,
                                truncation_cutoff=14)
        yaw, pitch = _BATCH_POSE_OFFSETS[i % len(_BATCH_POSE_OFFSETS)]
        cam_pose, cam_star = gate_camera(yaw, pitch, dev)
        target, t255 = gate_target(G, gen_params, ws_star, cam_star)
        net = pose_params
        if aim_pose_deg:
            net = aim_pose_net(pose_params, t255, cam_pose[:3, :3],
                               err_deg=aim_pose_deg, camera_mode=camera_mode,
                               generator=cpu, calibrate=aim_calibrate)
        with torch.no_grad():
            cam0 = assemble_camera(resnet34_apply(net, t255),
                                   torch.zeros((1, 3), device=dev),
                                   camera_mode, 2.7, proj.intrinsic)[1]
        init_errs.append(float(rotation_error_deg(cam0, cam_star)[0]))
        for lst, v in ((targets, target), (t255s, t255),
                       (cams_star, cam_star), (ws_stars, ws_star),
                       (nets, net)):
            lst.append(v)
    targets = torch.stack(targets)                      # [B, 1, 3, R, R]

    def gens(offset):
        return [torch.Generator(device=dev).manual_seed(
            seed + SEED_STRIDE * i + offset) for i in range(B)]

    t0 = time.perf_counter()
    ws, cams, _, metrics = proj.project_batch(
        torch.stack(t255s), targets_warp=targets,
        pose_params_b=stack_nets(nets), generators=gens(1))
    t1 = time.perf_counter()
    if log:
        log(f"batched self-inversion stage 1: {metrics['loss'].shape[0]} "
            f"steps x {B} images, loss {metrics['loss'][0].tolist()} -> "
            f"{metrics['loss'][-1].tolist()}")
    coach = PTICoach(G, lpips_loss,
                     CoachConfig(max_pti_steps=max_pti_steps, remat=True,
                                 lpips_threshold=pti_lpips_threshold))
    tuned_b, info = coach.tune_batch(gen_params, ws, cams, targets,
                                     generators=gens(2))
    t2 = time.perf_counter()
    if log:
        log(f"batched self-inversion stage 2: steps {info['steps']}, loss "
            f"{info['losses'][0].tolist()} -> {info['losses'][-1].tolist()}")
    per_image = []
    for i in range(B):
        final = reconstruction_quality(G, take_image(tuned_b, i), ws[i],
                                       cams[i], targets[i], lpips_loss)
        pivot = reconstruction_quality(G, gen_params, ws[i], cams[i],
                                       targets[i], lpips_loss)
        per_image.append({
            "final_mse": final["mse"], "final_lpips": final["lpips"],
            "final_ms_ssim": final["ms_ssim"],
            "pivot_mse": pivot["mse"], "pivot_ms_ssim": pivot["ms_ssim"],
            "pose_err_deg": float(rotation_error_deg(cams[i],
                                                     cams_star[i])[0]),
            "pti_steps": int(info["steps"][i]),
            "w_err": float(torch.linalg.norm(ws[i][:, 0]
                                             - ws_stars[i][:, 0])),
            "init_pose_err_deg": init_errs[i]})
    return {
        "per_image": per_image,
        "mean_final_ms_ssim": sum(p["final_ms_ssim"] for p in per_image) / B,
        "mean_final_mse": sum(p["final_mse"] for p in per_image) / B,
        "max_pose_err_deg": max(p["pose_err_deg"] for p in per_image),
        "stage1_s": t1 - t0, "stage2_s": t2 - t1,
        "seconds_per_image": (t2 - t0) / B}
