"""The self-inversion gate (``tgi_torch/invert/selfinv.py``) and the
projector's e4e start, on the CPU, at the tiny generator (64² renders)
with small stage-1 nets (``width_mult`` 1/8, one block per pose-net
stage):

* against tgi: ``rotation_error_deg``; ``aim_pose_net`` in both head
  modes, with and without calibration, on tgi's aim axis; the gate's
  target (camera, render, 256² [0, 255] version) and its quality
  formula (MSE, LPIPS, MS-SSIM); ``Projector.init_state``'s start
  ``w_avg + e4e(target_255)`` on tgi's z batch, with the same encoder on
  both sides;
* the gate end to end with bootstrapped nets (8 images, 3 + 3 steps) at
  tgi's own gate-test budget (60 + 60 steps, the 0.06 early-stop probe),
  held to ``tests/test_inversion.py::test_self_inversion_quality_gate``'s
  assertions;
* the gate's output, its traces included, equal to
  ``Projector.project`` + ``PTICoach.tune`` called by hand on the same
  draws.

Tolerances: 1e-5 relative to the largest value per output; the
calibrated pose tree and the quality metrics 1e-4."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tgi.invert import projector as jproj
from tgi.invert import selfinv as jsel
from tgi.losses.lpips import LPIPSLoss as JLPIPSLoss
from tgi.metrics import ms_ssim as jms_ssim
from tgi.render import cameras as jcameras
from tgi_torch.invert import (CoachConfig, PTICoach, Projector,
                              ProjectorConfig, aim_pose_net,
                              rotation_error_deg, self_inversion_eval)
from tgi_torch.invert import selfinv
from tgi_torch.invert.bootstrap import bootstrap_aux_nets
from tgi_torch.losses.lpips import LPIPSLoss

from torch_helpers import (jit_ref, leaves_with_paths, tiny_aux_nets,
                           tiny_pair)


def _j(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), tree)


def _rel(got, want, tol=1e-5, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (name, err)


@pytest.fixture(scope="module")
def setup():
    gj, pj, gt, pt = tiny_pair()
    pose, v, head = tiny_aux_nets(81)
    ws_star = torch.from_numpy(
        0.5 * np.random.RandomState(82).randn(1, gt.cfg.num_ws, 32)
        .astype(np.float32))
    return dict(gj=gj, pj=pj, gt=gt, pt=pt, pose=pose, vgg=v, head=head,
                ws_star=ws_star)


def test_rotation_error_deg():
    rng = np.random.RandomState(83)
    cams = []
    for _ in range(2):
        c = jcameras.look_at_pose(np.pi / 2 + 0.4 * rng.randn(3),
                                  np.pi / 2 + 0.2 * rng.randn(3),
                                  jnp.zeros(3), radius=2.7)
        cams.append(np.asarray(jcameras.pack_camera(
            c, jcameras.fov_to_intrinsics(18.837))))
    got = rotation_error_deg(*(torch.from_numpy(c) for c in cams))
    want = jsel.rotation_error_deg(*(jnp.asarray(c) for c in cams))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    assert float(rotation_error_deg(torch.from_numpy(cams[0]),
                                    torch.from_numpy(cams[0])).max()) < 0.05


def test_gate_target_and_quality(setup):
    """The target camera, render and 256² [0, 255] target, and the
    quality formula, against tgi's (selfinv.py:143-150, 186-194)."""
    cam_pose, cam_star = selfinv.gate_camera(device="cpu")
    want_pose = jcameras.look_at_pose(math.pi / 2 + 0.35,
                                      math.pi / 2 + 0.12,
                                      jnp.asarray([0.0, 0.0, 0.2]),
                                      radius=2.7)
    want_cam = jcameras.pack_camera(want_pose[None],
                                    jcameras.fov_to_intrinsics(18.837))
    _rel(cam_star, want_cam, name="cam*")
    target, t255 = selfinv.gate_target(setup["gt"], setup["pt"],
                                       setup["ws_star"], cam_star)

    def ref(p, w, c):
        t = jnp.clip(setup["gj"].synthesis(p, w, c, det=True)["image"],
                     -1.0, 1.0)
        return t, (jax.image.resize(t, (1, 3, 256, 256), method="linear")
                   + 1.0) * 127.5

    wt, w255 = jit_ref(ref)(setup["pj"], jnp.asarray(setup["ws_star"]
                                                     .numpy()), want_cam)
    _rel(target, wt, name="target")
    _rel(t255, w255, name="target_255")

    lp = LPIPSLoss(setup["vgg"], setup["head"])
    ws = setup["ws_star"] + 0.1
    got = selfinv.reconstruction_quality(setup["gt"], setup["pt"], ws,
                                         cam_star, target, lp)
    jlp = JLPIPSLoss(_j(setup["vgg"]), _j(setup["head"]))

    def quality(p, w, c, t):
        img = jnp.clip(setup["gj"].synthesis(p, w, c, det=True)["image"],
                       -1.0, 1.0)
        return {"mse": jnp.mean(jnp.square(img - t)),
                "lpips": jlp.from_unit(img, t).sum(),
                "ms_ssim": jms_ssim((img + 1) / 2, (t + 1) / 2).mean()}

    want = jit_ref(quality)(setup["pj"], jnp.asarray(ws.numpy()), want_cam,
                            wt)
    for k in ("mse", "lpips", "ms_ssim"):
        assert abs(got[k] - float(want[k])) <= 1e-4 * abs(float(want[k])), k


@pytest.mark.parametrize("mode,calibrate", [("quat", True), ("quat", False),
                                            ("6d", True)])
def test_aim_pose_net(setup, mode, calibrate):
    """The aimed net's tree against tgi's on tgi's axis draw, and its
    prediction err_deg from the true rotation."""
    dims = {"quat": 4, "6d": 6}[mode]
    pose, _, _ = tiny_aux_nets(84, camera_dims=dims)
    if not calibrate:
        pose = aim_pose_net(pose, torch.full((1, 3, 64, 64), 100.0),
                            torch.eye(3), camera_mode=mode,
                            axis=torch.ones(3))
    cam_pose, cam_star = selfinv.gate_camera(device="cpu")
    _, t255 = selfinv.gate_target(setup["gt"], setup["pt"],
                                  setup["ws_star"], cam_star)
    key = jax.random.PRNGKey(85)
    axis = np.asarray(jax.random.normal(key, (3,)))
    got = aim_pose_net(pose, t255, cam_pose[:3, :3], err_deg=3.0,
                       camera_mode=mode, axis=torch.from_numpy(axis),
                       calibrate=calibrate)
    want = jsel.aim_pose_net(_j(pose), jnp.asarray(t255.numpy()),
                             jnp.asarray(cam_pose[:3, :3].numpy()),
                             err_deg=3.0, camera_mode=mode, key=key,
                             calibrate=calibrate)
    w = dict(leaves_with_paths(want))
    for path, t in leaves_with_paths(got):
        _rel(t, w[path], 1e-4, ".".join(path))
    from tgi_torch.invert.projector import assemble_camera
    from tgi_torch.models.pose_resnet import resnet34_apply
    with torch.no_grad():
        _, cam0 = assemble_camera(resnet34_apply(got, t255),
                                  torch.zeros(1, 3), mode, 2.7,
                                  torch.tensor(jproj.DEFAULT_INTRINSIC))
    err = float(rotation_error_deg(cam0, cam_star)[0])
    assert abs(err - 3.0) < 0.1, err
    # The caller's tree is untouched.
    assert not torch.equal(got["fc3"]["bias"], pose["fc3"]["bias"])
    with pytest.raises(ValueError, match="unsupported mode"):
        aim_pose_net(pose, t255, cam_pose[:3, :3], camera_mode="2d")


def test_projector_e4e_start_matches_tgi(setup):
    """init_state's w = w_avg + e4e(target_255), on tgi's z batch, the
    encoder fed the [0, 255] target (w_projector.py:73, 99-115)."""
    m = np.random.RandomState(86).randn(3, 32).astype(np.float32)
    seen = {}

    def enc_t(img):
        seen["max"] = float(img.max())
        return img.mean(dim=(2, 3)) @ torch.from_numpy(m) / 100

    def enc_j(img):
        return img.mean(axis=(2, 3)) @ jnp.asarray(m) / 100

    _, t255 = selfinv.gate_target(setup["gt"], setup["pt"], setup["ws_star"],
                                  selfinv.gate_camera(device="cpu")[1])
    cfg = dict(w_avg_samples=16)
    pj = jproj.Projector(setup["gj"], setup["pj"], _j(setup["vgg"]),
                         _j(setup["head"]), _j(setup["pose"]),
                         jproj.ProjectorConfig(**cfg), e4e_encode=enc_j)
    key = jax.random.PRNGKey(87)
    state_j, _, _ = pj.init_state(key, jnp.asarray(t255.numpy()))
    k_stats, _ = jax.random.split(key)
    z = torch.from_numpy(np.asarray(jax.random.normal(k_stats, (16, 32))))
    pt = Projector(setup["gt"], setup["pt"], setup["vgg"], setup["head"],
                   setup["pose"], ProjectorConfig(**cfg), e4e_encode=enc_t)
    state_t, _, _ = pt.init_state(z=z, target_255=t255)
    _rel(state_t["w"], state_j["w"], name="start w")
    assert seen["max"] > 2.0
    # Without the encoder the start is w_avg.
    w_avg, _ = pt.compute_w_stats(z=z)
    state_0, _, _ = Projector(setup["gt"], setup["pt"], setup["vgg"],
                              setup["head"], setup["pose"],
                              ProjectorConfig(**cfg)).init_state(z=z)
    assert torch.equal(state_0["w"].detach(), w_avg)
    with pytest.raises(ValueError, match="target_255"):
        pt.init_state(z=z)


@pytest.fixture(scope="module")
def aux(setup):
    """Bootstrapped nets, as the gate runs on the card (8 images, 3 + 3
    steps)."""
    pose, v, e4e, _ = bootstrap_aux_nets(
        setup["gt"], setup["pt"], seed=88, pose_params=setup["pose"],
        vgg_params=setup["vgg"], num_images=8, pose_steps=3, vgg_steps=3,
        pose_batch=4, vgg_batch=4)
    return dict(pose=pose, vgg=v, e4e=e4e,
                lp=LPIPSLoss(v, setup["head"]))


def test_gate_end_to_end(setup, aux):
    """tgi's gate test budget and assertions
    (tests/test_inversion.py:94-119), with the bootstrapped e4e start and
    the camera lr / 30 of the bootstrapped gate."""
    out = self_inversion_eval(
        setup["gt"], setup["pt"], seed=11, vgg_params=aux["vgg"],
        lpips_head=setup["head"], pose_params=aux["pose"],
        lpips_loss=aux["lp"], first_inv_steps=60, max_pti_steps=60,
        w_avg_samples=32, early_stop_probe=0.06, e4e_encode=aux["e4e"],
        aim_calibrate=False, trace_every=20,
        proj_overrides={"cam_lr_quat": ProjectorConfig().cam_lr_quat / 30})
    for k, v in out.items():
        if k.endswith("_trace"):
            assert np.isfinite(np.asarray(v, np.float64)).all(), (k, v)
        else:
            assert np.isfinite(v), (k, v)
    assert out["stage1_final_loss"] < out["stage1_first_loss"]
    assert out["final_mse"] <= out["pivot_mse"] * 1.05
    assert out["pti_steps"] <= 60
    assert 0 <= out["es_steps"] <= 60
    assert out["es_threshold"] == 0.06
    assert [s for s, _ in out["quality_trace"]] == [20, 40, 60]
    assert [s for s, _ in out["mse_trace"]] == [20, 40, 60]
    assert out["mse_trace"][-1][1] == out["final_mse"]
    assert [t[0] for t in out["stage1_trace"]] == [20, 40, 60]
    assert out["qconv_steps"] in (20, 40, 60)
    assert abs(out["init_pose_err_deg"] - 3.0) < 0.1


def test_gate_equals_stages_by_hand(setup, aux):
    """The gate's numbers are Projector.project + PTICoach.tune run by
    hand on its draws (seed: z and the aim axis; seed + 1: stage 1;
    seed + 2: stage 2 and, again, the early-stop probe)."""
    seed, s1, s2 = 13, 5, 4
    kw = dict(vgg_params=aux["vgg"], lpips_head=setup["head"],
              lpips_loss=aux["lp"], w_avg_samples=16)
    overrides = {"cam_preheat_steps": 2}
    out = self_inversion_eval(
        setup["gt"], setup["pt"], seed=seed, pose_params=aux["pose"],
        first_inv_steps=s1, max_pti_steps=s2, e4e_encode=aux["e4e"],
        aim_calibrate=False, early_stop_probe=0.5, trace_every=2,
        proj_overrides=overrides, **kw)

    G, p = setup["gt"], setup["pt"]
    cpu = torch.Generator().manual_seed(seed)
    pr = Projector(G, p, aux["vgg"], setup["head"], aux["pose"],
                   ProjectorConfig(num_steps=s1, w_avg_samples=16,
                                   render_fp32=False, **overrides),
                   e4e_encode=aux["e4e"])
    z = torch.randn((1, 32), generator=cpu)
    with torch.no_grad():
        ws_star = G.mapping(p, z, pr.canonical_cam, truncation_psi=0.7,
                            truncation_cutoff=14)
    cam_pose, cam_star = selfinv.gate_camera(device="cpu")
    target, t255 = selfinv.gate_target(G, p, ws_star, cam_star)
    aimed = aim_pose_net(aux["pose"], t255, cam_pose[:3, :3],
                         generator=cpu, calibrate=False)
    pr = Projector(G, p, aux["vgg"], setup["head"], aimed, pr.cfg,
                   e4e_encode=aux["e4e"])
    ws, cam, _, metrics = pr.project(
        t255, target_full=target,
        generator=torch.Generator().manual_seed(seed + 1))
    tuned = {}
    for thr in (0.0, 0.5):
        tuned[thr] = PTICoach(G, aux["lp"], CoachConfig(
            max_pti_steps=s2, lpips_threshold=thr)).tune(
                p, ws, cam, target,
                generator=torch.Generator().manual_seed(seed + 2))
    q = {thr: selfinv.reconstruction_quality(G, t[0], ws, cam, target,
                                             aux["lp"])
         for thr, t in tuned.items()}
    assert out["stage1_first_loss"] == metrics["loss"][0]
    assert out["stage1_final_loss"] == metrics["loss"][-1]
    assert out["pose_err_deg"] == float(rotation_error_deg(cam,
                                                           cam_star)[0])
    assert out["w_err"] == float(torch.linalg.norm(ws[:, 0]
                                                   - ws_star[:, 0]))
    assert out["pti_steps"] == tuned[0.0][1]["steps"] == s2
    assert out["es_steps"] == tuned[0.5][1]["steps"]
    for k in ("mse", "lpips", "ms_ssim"):
        assert out["final_" + k] == q[0.0][k]
        assert out["es_" + k] == q[0.5][k]
    assert [s for s, _ in out["quality_trace"]] == [2, 4]
    # The stage-1 trace: the mean loss of each span, and the camera and
    # w errors at its end (the last are the pivot's).
    assert [t[0] for t in out["stage1_trace"]] == [2, 4, 5]
    for (a, *_), (s, loss, pose, w) in zip([(0,)] + out["stage1_trace"],
                                           out["stage1_trace"]):
        assert abs(loss - np.mean(metrics["loss"][a:s])) <= 1e-6 * loss
    assert abs(out["stage1_trace"][-1][2] - out["pose_err_deg"]) <= 1e-3
    assert abs(out["stage1_trace"][-1][3] - out["w_err"]) <= 1e-5 * (
        out["w_err"])
