"""Density noise and random SR noise through tgi_torch's batched and
rematerialised inversion, on the CPU at the tiny config (plane C = 8,
32² backbone, 16² rays, 8 + 8 samples, SuperresolutionTiny, 64² images)
with ``density_noise=1`` and ``superresolution_noise_mode="random"``,
small VGG and pose nets (``width_mult`` 1/8) and AlexNet-LPIPS:

* ``render_draws`` of two generators is the two one-image draws, and a
  render given one image's draws is the render that draws them from its
  generator, bit for bit (the same values in the same order); a draw
  source takes them at ``tgi``'s key tree;
* one batched stage-1 step (``step_batch``) and one batched tuning step
  (``tune_batch``) at B = 2 against each image's one-image step on its
  own generator, with and without remat, and remat against no remat;
* the one-image projector and coach losses under remat against
  ``tgi``'s ``_loss`` (eager, jitted once; never a scan), ``tgi``'s
  draws handed over through ``torch_helpers.with_tgi_draws``.

Tolerances, relative to the reference's largest magnitude: batched
against one-image 1e-5 on losses and on the tuning step's gradients
(the same fp32 arithmetic, reassociated by the batched convolutions),
STAGE1_GRAD_TOL on the stage-1 step's gradients (see its test); remat
against none 1e-6; against ``tgi`` 1e-4 per loss and gradient (PERF.md
§2).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tgi.invert import projector as jproj
from tgi.invert.coach import CoachConfig as JCoachConfig
from tgi.invert.coach import PTICoach as JPTICoach
from tgi.losses.lpips import AlexLPIPSLoss as JAlexLPIPSLoss
from tgi.models import TriPlaneGenerator as JTriPlaneGenerator
from tgi_torch.invert import projector as proj
from tgi_torch.invert.coach import (CoachConfig, PTICoach, _map,
                                    render_draws)
from tgi_torch.losses.lpips import AlexLPIPSLoss
from tgi_torch.models import alexnet, pose_resnet, vgg
from tgi_torch.models.generator import TriPlaneGenerator

from torch_helpers import (jit_ref, leaves_with_paths, tiny_camera,
                           tiny_pair, with_tgi_draws)
from torch_helpers import render_draws as tgi_jitter_u

B = 2
YAWS = (0.25, -0.3)
OPTIONS = dict(density_noise=1.0, superresolution_noise_mode="random")
KW = dict(num_steps=4, cam_preheat_steps=2, w_avg_samples=64)
JOINT_STEP = 2                          # the first step with w noise
STAGE1_GRAD_TOL = 1e-4


def _j(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


def _rel(name, got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = (want.detach().numpy() if isinstance(want, torch.Tensor)
            else np.asarray(want))
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (name, err)


def _grads(tree):
    return {p: (torch.zeros_like(t) if t.grad is None else t.grad.clone())
            for p, t in leaves_with_paths(tree)}


def _gens(seed):
    return [torch.Generator().manual_seed(seed + b) for b in range(B)]


@pytest.fixture(scope="module")
def setup():
    gj, pj, plain, pt = tiny_pair()
    gj = JTriPlaneGenerator(dataclasses.replace(gj.cfg, rendering_kwargs={
        **gj.cfg.rendering_kwargs, **OPTIONS}))
    gt = TriPlaneGenerator(plain.cfg.with_rendering(**OPTIONS))
    gen = torch.Generator().manual_seed(31)
    v = vgg.vgg16_init(gen, "cpu", width_mult=0.125)
    head = vgg.lpips_head_init(gen, "cpu", width_mult=0.125)
    trunk = alexnet.alexnet_init(gen, "cpu")
    alex_head = alexnet.alex_head_init(gen, "cpu")
    rng = np.random.RandomState(32)
    cams = torch.from_numpy(np.concatenate([tiny_camera(y) for y in YAWS]))
    ws = torch.from_numpy((0.5 * rng.randn(B, 1, 32)).astype(
        np.float32)).repeat(1, gt.cfg.num_ws, 1)
    with torch.no_grad():       # the targets: det renders without noise
        img = plain.synthesis(pt, ws, cams)["image"].clamp(-1, 1)
    t255 = (img + 1) * 127.5
    pose = pose_resnet.resnet34_calibrate(
        pose_resnet.resnet34_init(gen, 4, "cpu", width_mult=0.125,
                                  blocks=(1, 1, 1, 1)), t255[:1])
    with torch.no_grad():
        feats = vgg.lpips_features(v, head, t255)
    real = torch.from_numpy(np.tanh(rng.randn(B, 1, 3, 64, 64)).astype(
        np.float32))
    return dict(gj=gj, pj=pj, gt=gt, pt=pt, vgg=v, head=head, pose=pose,
                lp_t=AlexLPIPSLoss(trunk, alex_head),
                lp_j=JAlexLPIPSLoss(_j(trunk), _j(alex_head)),
                cams=cams, ws=ws, img=img, t255=t255, feats=feats,
                real=real)


def _projector(s, remat):
    return proj.Projector(s["gt"], s["pt"], s["vgg"], s["head"], s["pose"],
                          proj.ProjectorConfig(remat_render=remat, **KW))


def test_render_draws_are_each_images_own(setup):
    s = setup
    for G in (s["gt"], TriPlaneGenerator(s["gt"].cfg.with_rendering(
            depth_resolution_importance=4))):
        rk = G.cfg.rendering_kwargs
        M = G.cfg.neural_rendering_resolution ** 2
        got = render_draws(G, _gens(5), "cpu")
        assert sorted(got) == ["jitter", "sigma_noise", "sr_noise", "u"]
        coarse, fine = got["sigma_noise"]
        assert coarse.shape == (B, M * rk["depth_resolution"], 1)
        assert fine.shape == (B, M * rk["depth_resolution_importance"], 1)
        # tgi's one key for both passes: one draw where the shapes agree.
        assert torch.equal(coarse, fine) == (coarse.shape == fine.shape)
        for b in range(B):
            one = render_draws(G, [torch.Generator().manual_seed(5 + b)],
                               "cpu")
            assert torch.equal(got["jitter"][b:b + 1], one["jitter"])
            assert torch.equal(got["u"][b * M:(b + 1) * M], one["u"])
            for i in range(2):
                assert torch.equal(got["sigma_noise"][i][b:b + 1],
                                   one["sigma_noise"][i])
            for (p, a), (_, c) in zip(leaves_with_paths(got["sr_noise"]),
                                      leaves_with_paths(one["sr_noise"])):
                assert torch.equal(a[b:b + 1], c), p
        # The draws given reproduce the render that draws them itself.
        with torch.no_grad():
            own = G.synthesis(s["pt"], s["ws"][:1], s["cams"][:1], det=False,
                              generator=torch.Generator().manual_seed(5))
            given = G.synthesis(s["pt"], s["ws"][:1], s["cams"][:1],
                                det=False, **render_draws(
                                    G, [torch.Generator().manual_seed(5)],
                                    "cpu"))
        for k in ("image", "image_raw", "image_depth"):
            assert torch.equal(own[k], given[k]), k
    # A draw source is split as tgi's synthesis splits its key.
    G = s["gt"]
    key = jax.random.PRNGKey(3)
    got = with_tgi_draws(key, lambda d: render_draws(G, [d], "cpu"))
    rk = G.cfg.rendering_kwargs
    jitter, u = tgi_jitter_u(key, 1, G.cfg.neural_rendering_resolution ** 2,
                             rk["depth_resolution"],
                             rk["depth_resolution_importance"])
    assert torch.equal(got["jitter"], jitter) and torch.equal(got["u"], u)
    # Under remat a render draws nothing of its own: partial draws raise.
    coach = PTICoach(G, s["lp_t"], CoachConfig(remat=True))
    with pytest.raises(ValueError, match="sigma_noise"):
        coach._loss(s["pt"], s["ws"][:1], s["cams"][:1], s["real"][0],
                    jitter=jitter, u=u)


def test_stage1_batch_step_equals_per_image(setup):
    """``step_batch`` with each image's generator, with and without
    remat, against ``step`` of the image alone on the same generator
    (its init from the same seeds, w_std the batch's), at the first joint
    step (w noise, then the predicted and the canonical view's every
    draw). The losses hold to 1e-5 (the predicted render is the same bit
    for bit), the gradients to STAGE1_GRAD_TOL: the stacked pose nets'
    grouped convolutions and the N = 2 render reassociate the backward,
    and the warp loss's depth mask and the camera amplify it (measured:
    ``step_batch`` at B = 1 against ``step`` 2.2e-5 on the pose net; at
    B = 2 without the options 1.8e-5, with them 7.3e-5 on the pose net
    and 6.2e-5 on w)."""
    s = setup
    out = {}
    for remat in (True, False):
        pr = _projector(s, remat)
        state, opts, w_std = pr.init_state_batch(B, generators=_gens(30))
        out[remat] = (pr.step_batch(state, opts, JOINT_STEP, w_std,
                                    s["t255"], s["feats"],
                                    targets_warp=s["img"],
                                    generators=_gens(40)), _grads(state))
    (got, got_g), (rm, rm_g) = out[False], out[True]
    for k in ("loss", "dist", "warp"):
        _rel(k, rm[k], got[k], 1e-6)
    for path, g in got_g.items():
        _rel(str(path), rm_g[path], g, 1e-6)
    for b in range(B):
        one, one_opts, _ = pr.init_state(
            generator=torch.Generator().manual_seed(30 + b))
        want = pr.step(one, one_opts, JOINT_STEP, w_std,
                       s["t255"][b:b + 1], s["feats"][b:b + 1],
                       target_warp=s["img"][b:b + 1],
                       generator=torch.Generator().manual_seed(40 + b))
        for k in ("loss", "dist", "warp"):
            _rel(f"{k}[{b}]", got[k][b], want[k], 1e-5)
        for path, g in _grads(one).items():
            _rel(f"{path}[{b}]", got_g[path][b], g, STAGE1_GRAD_TOL)


def test_tuning_batch_step_equals_per_image(setup):
    """``tune_batch``'s first step with each image's generator, with and
    without remat, against the image's one-image loss and gradient on
    the same generator; the batch's gradient read from its Adam's first
    moment (b1 = 0.9 after one step: m = 0.1 g)."""
    s = setup
    ws_b, cams_b = s["ws"][:, None], s["cams"][:, None]
    out = {}
    for remat in (True, False):
        coach = PTICoach(s["gt"], s["lp_t"],
                         CoachConfig(lpips_threshold=0.0, remat=remat))
        out[remat] = coach.tune_batch(s["pt"], ws_b, cams_b, s["real"],
                                      generators=_gens(50), max_steps=1)[1]
    info, rm = out[False], out[True]
    _rel("losses", rm["losses"], info["losses"], 1e-6)
    for i, (m, m0) in enumerate(zip(rm["adam"].m, info["adam"].m)):
        _rel(f"moment {i}", m, m0, 1e-6)
    moments = [m / (1 - info["adam"].betas[0]) for m in info["adam"].m]
    for b in range(B):
        params = _map(lambda t: t.detach().clone().requires_grad_(True),
                      s["pt"])
        loss, _ = coach._loss(params, s["ws"][b:b + 1], s["cams"][b:b + 1],
                              s["real"][b],
                              generator=torch.Generator().manual_seed(50 + b))
        loss.backward()
        _rel(f"loss[{b}]", info["losses"][0, b], loss, 1e-5)
        for (path, g), m in zip(_grads(params).items(), moments):
            _rel(f"{path}[{b}]", m[b], g, 1e-5)


def test_remat_coach_loss_matches_tgi(setup):
    s = setup
    cj = JPTICoach(s["gj"], s["lp_j"], JCoachConfig())
    key = jax.random.PRNGKey(9)
    args = (s["ws"][:1], s["cams"][:1], s["real"][0])
    (want_loss, want_aux), want_g = jit_ref(jax.value_and_grad(
        cj._loss, has_aux=True))(s["pj"], *(jnp.asarray(a.numpy())
                                            for a in args), key)
    draws = with_tgi_draws(key, lambda d: render_draws(s["gt"], [d], "cpu"))
    params = _map(lambda t: t.detach().clone().requires_grad_(True),
                  s["pt"])
    coach = PTICoach(s["gt"], s["lp_t"], CoachConfig(remat=True))
    loss, aux = coach._loss(params, *args, **draws)
    loss.backward()
    _rel("loss", loss, want_loss, 1e-4)
    _rel("lpips", aux["lpips"], want_aux["lpips"], 1e-4)
    got = _grads(params)
    for path, g in leaves_with_paths(want_g):
        _rel(str(path), got[path], g, 1e-4)


def test_remat_projector_loss_matches_tgi(setup):
    s = setup
    pr_j = jproj.Projector(s["gj"], s["pj"], _j(s["vgg"]), _j(s["head"]),
                           _j(s["pose"]), jproj.ProjectorConfig(**KW))
    pr_t = _projector(s, True)
    rng = np.random.RandomState(33)
    state_np = {
        "w": (0.5 * rng.randn(1, 1, 32)).astype(np.float32),
        "noise": {"/".join(p): rng.randn(*proj.get_path(
            pr_t.base_params, p).shape).astype(np.float32)
            for p in pr_t.noise_paths},
        "translation": (0.02 * rng.randn(1, 3)).astype(np.float32),
        "pose": jax.tree.map(lambda t: t.numpy(), s["pose"])}
    w_noise = (0.01 * rng.randn(1, 1, 32)).astype(np.float32)
    key = jax.random.PRNGKey(34)
    t255, feats, img = (s[k][:1].numpy() for k in ("t255", "feats", "img"))
    want_g, want_aux = jit_ref(jax.grad(pr_j._loss, has_aux=True))(
        jax.tree.map(jnp.asarray, state_np), jnp.asarray(t255),
        jnp.asarray(feats), jnp.asarray(w_noise), key, jnp.asarray(img))
    draws = with_tgi_draws(key, lambda d: tuple(
        render_draws(s["gt"], [k], "cpu") for k in d.split(2)))
    state = jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)).requires_grad_(True),
        state_np)
    loss, aux = pr_t._loss(state, torch.from_numpy(t255),
                           torch.from_numpy(feats), torch.from_numpy(w_noise),
                           draws=draws, target_warp=torch.from_numpy(img))
    loss.backward()
    want_loss = (want_aux["dist"] + want_aux["warp"]
                 + want_aux["noise_reg"] * pr_t.cfg.regularize_noise_weight)
    _rel("loss", loss, want_loss, 1e-4)
    for k in ("dist", "warp", "noise_reg", "pred_cam"):
        _rel(k, aux[k], want_aux[k], 1e-4)
    got = _grads(state)
    for path, g in leaves_with_paths(want_g):
        _rel(str(path), got[path], g, 1e-4)
