"""tgi_torch's mixed precision (``fused_dtype="bfloat16"``,
``plane_dtype="bfloat16"``) against tgi's, on the CPU, at the tiny config
(plane C = 8, 32² backbone, 16² rays, 8 + 8 samples, SuperresolutionTiny,
64² images) with the same weights on both sides. With
``num_fp16_res=4`` the backbone's blocks 8-32 run in bf16, and with
``sr_num_fp16_res=4`` both SR blocks do.

bf16 is not bitwise across the two: XLA's CPU backend keeps excess
precision inside its fusions, and torch rounds every op to bf16. So,
with ref = tgi in float32 and D = ‖tgi_bf16 − tgi_fp32‖∞ per output:

* each op or block alone: ‖port_bf16 − tgi_bf16‖∞ ≤ 2⁻⁷ · max|ref|
  (two bf16 ulps of its largest magnitude);
* the generator's image, raw image, depth and planes:
  ‖port_bf16 − tgi_bf16‖∞ ≤ 2 · D and ≤ 5e-2 · max|ref|, and
  ‖port_bf16 − port_fp32‖∞ ≥ 0.25 · D (bf16 really runs);
* stage 2's loss, and each gradient leaf (D measured per leaf):
  ‖port_bf16 − tgi_bf16‖∞ ≤ 2 · D + 2⁻⁷ · max|ref| (the ulp term covers
  leaves whose D is near 0), and ‖port_bf16 − ref‖∞ ≤ D + 5e-2 · max|ref|:
  the port is no further from float32 than tgi's bf16 is, plus 5 % of the
  leaf's largest element. On the CPU tgi's bf16 gradients of the SR's
  weights stand far from its fp32 ones (tens of percent of a leaf's
  largest element) where the port's stay within a few percent; on the
  backbone's ``noise_const`` both stand far from fp32 and close to each
  other;
* a 2-step tuning trajectory: each step's loss by the loss bound above;
  each parameter's update within Adam's ``2 · steps · lr`` of tgi's bf16
  one, and within ``2e-2 · steps · lr`` (and at least ``lr / 4``) on the
  elements whose bf16 gradient is sure at both steps, where
  |g| ≥ 2 · (2 · D + 2⁻⁷ · max|ref|) (``assert_updates_match``); and the
  loss both tuned sets give on a third render;
* stage 1 with ``render_fp32=True`` renders in float32: its loss and
  every gradient stay within the fp32 tests' 1e-4 of tgi's.
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
from tgi.nn import layers as jlayers
from tgi.nn import superres as jsuperres
from tgi.nn import synthesis as jsynthesis
from tgi.ops import grid_sample as jgs
from tgi.ops.bias_act import bias_act as j_bias_act
from tgi.ops.conv2d_resample import conv2d_resample as j_conv2d_resample
from tgi.ops.upfirdn2d import upsample2d as j_upsample2d
from tgi_torch.invert import projector as proj
from tgi_torch.invert.coach import CoachConfig, PTICoach
from tgi_torch.losses.lpips import AlexLPIPSLoss
from tgi_torch.models import alexnet, pose_resnet, vgg
from tgi_torch.models.generator import TriPlaneGenerator
from tgi_torch.nn import layers, superres, synthesis
from tgi_torch.ops import grid_sample as gs
from tgi_torch.ops.bias_act import bias_act
from tgi_torch.ops.conv2d_resample import conv2d_resample
from tgi_torch.ops.filters import setup_filter
from tgi_torch.ops.upfirdn2d import upsample2d

from torch_helpers import (assert_updates_match, jit_ref, leaves_with_paths,
                           render_draws, splat_inputs, tiny_camera, tiny_pair)

ULP2 = 2.0 ** -7
BF16 = jnp.bfloat16


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _op_close(got, want, ref, name=""):
    """‖got − want‖∞ ≤ 2⁻⁷ · max|ref| (two bf16 ulps of ref's largest)."""
    got, want, ref = _np(got), _np(want), _np(ref)
    assert got.shape == want.shape == ref.shape, name
    err = np.abs(got - want).max()
    assert err <= ULP2 * np.abs(ref).max(), (name, err, np.abs(ref).max())


def _bf16_pair(gj, gt, **kw):
    return (JTriPlaneGenerator(dataclasses.replace(gj.cfg, **kw)),
            TriPlaneGenerator(dataclasses.replace(gt.cfg, **kw)))


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.randn(*shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# Ops and blocks alone


@pytest.mark.parametrize("up", [1, 2])
def test_modulated_conv_pre_normalize_bf16(up):
    """One bf16 modulated conv, which pre-normalizes by the inf-norms of
    the float32 weight and styles because its input is bf16, against
    tgi's with ``pre_normalize``; ``up=2`` runs conv2d_resample's
    transposed conv."""
    rng = np.random.RandomState(1)
    x, w = _rand(rng, 2, 16, 8, 8), _rand(rng, 8, 16, 3, 3)
    s, noise = _rand(rng, 2, 16, scale=3.0), _rand(rng, 8 * up, 8 * up)
    f = setup_filter([1, 3, 3, 1]) if up > 1 else None
    kw = dict(up=up, padding=1, resample_filter=f, flip_weight=(up == 1))

    def tgi(dtype):
        return jax.jit(lambda x, w, s, n: jlayers.modulated_conv2d(
            x.astype(dtype), w, s, noise=n, pre_normalize=True, **kw))(
                x, w, s, noise)

    got = layers.modulated_conv2d(torch.from_numpy(x).bfloat16(),
                                  torch.from_numpy(w), torch.from_numpy(s),
                                  noise=torch.from_numpy(noise), **kw)
    assert got.dtype == torch.bfloat16
    _op_close(got, tgi(BF16), tgi(jnp.float32))


def test_bias_act_resample_ops_bf16():
    """bias_act's gain and clamp, upsample2d's FIR filter and
    conv2d_resample's ``up=2`` transposed conv, each in bf16 with values
    past the clamp, against tgi's bf16."""
    rng = np.random.RandomState(2)
    x, b = _rand(rng, 2, 8, 8, 8, scale=200.0), _rand(rng, 8)
    w = _rand(rng, 4, 8, 3, 3)
    f = setup_filter([1, 3, 3, 1])
    xt, bt, wt = (torch.from_numpy(a) for a in (x, b, w))
    cases = (
        (lambda x: bias_act(x, bt.bfloat16(), act="lrelu", gain=1.7,
                            clamp=256),
         lambda x: j_bias_act(x, jnp.asarray(b, x.dtype),
                                      act="lrelu", gain=1.7, clamp=256)),
        (lambda x: upsample2d(x, f),
         lambda x: j_upsample2d(x, f)),
        (lambda x: conv2d_resample(x, wt.bfloat16(), f=f, up=2, padding=1,
                                   flip_weight=False),
         lambda x: j_conv2d_resample(
             x, jnp.asarray(w, x.dtype), f=f, up=2, padding=1,
             flip_weight=False)))
    for i, (port, ref) in enumerate(cases):
        got = port(xt.bfloat16())
        assert got.dtype == torch.bfloat16
        _op_close(got, jax.jit(ref)(jnp.asarray(x, BF16)),
                  jax.jit(ref)(jnp.asarray(x)), f"case {i}")
    clamped = bias_act(xt.bfloat16(), act="lrelu", clamp=256)
    assert clamped.abs().max().item() == 256


@pytest.mark.parametrize("block", ["b16", "sr_block0"])
def test_synthesis_block_bf16(pair, block):
    """One backbone block (b16: conv0 with up=2, conv1, torgb) and the
    SR's first block (up=1, conv_clamp 256) in bf16; x comes back in bf16
    and the image in float32."""
    _, pj, _, pt = pair
    rng = np.random.RandomState(3)
    if block == "b16":
        pb_j, pb_t = pj["backbone"]["b16"], pt["backbone"]["b16"]
        x, img = _rand(rng, 1, 32, 8, 8), _rand(rng, 1, 24, 8, 8)
        kw = dict(in_channels=32, up=2, conv_clamp=256)
        jkw = dict(kw, resolution=16)
    else:
        pb_j = pj["superresolution"]["block0"]
        pb_t = pt["superresolution"]["block0"]
        x, img = _rand(rng, 1, 8, 32, 32), _rand(rng, 1, 3, 32, 32)
        kw = dict(in_channels=8, up=1, conv_clamp=256)
        jkw = dict(kw, resolution=32, noise_mode="none")
        kw["noise_mode"] = "none"
    ws = _rand(rng, 1, 3, 32)

    def tgi(use_fp16):
        return jax.jit(lambda p, x, i, w: jsynthesis.synthesis_block_apply(
            p, x, i, w, use_fp16=use_fp16, fused_dtype="bfloat16", **jkw))(
                pb_j, x, img, ws)

    got_x, got_img = synthesis.synthesis_block_apply(
        pb_t, torch.from_numpy(x), torch.from_numpy(img),
        torch.from_numpy(ws), dtype=torch.bfloat16, **kw)
    assert got_x.dtype == torch.bfloat16 and got_img.dtype == torch.float32
    (want_x, want_img), (ref_x, ref_img) = tgi(True), tgi(False)
    _op_close(got_x, want_x, ref_x, "x")
    _op_close(got_img, want_img, ref_img, "img")


def test_superresolution_bf16(pair):
    """The whole SR in bf16 (conv_clamp 256); in float32 with the clamp a
    bf16 generator keeps under ``force_fp32`` it equals the plain SR bit
    for bit."""
    gj, pj, gt, pt = pair
    rng = np.random.RandomState(4)
    rgb, x = _rand(rng, 1, 3, 16, 16), _rand(rng, 1, 8, 16, 16)
    ws = _rand(rng, 1, gt.cfg.num_ws, 32)

    def tgi(use_fp16):
        return jax.jit(lambda p, r, x, w: jsuperres.superresolution_apply(
            p, r, x, w, gj.cfg.sr_cfg, use_fp16=use_fp16,
            fused_dtype="bfloat16", noise_mode="none"))(
                pj["superresolution"], rgb, x, ws)

    args = (pt["superresolution"], torch.from_numpy(rgb),
            torch.from_numpy(x), torch.from_numpy(ws), gt.cfg.sr_cfg)
    got = superres.superresolution_apply(*args, dtype=torch.bfloat16,
                                         conv_clamp=256)
    assert got.dtype == torch.float32
    _op_close(got, tgi(True), tgi(False))
    assert torch.equal(
        superres.superresolution_apply(*args, conv_clamp=256),
        superres.superresolution_apply(*args))


# ---------------------------------------------------------------------------
# The generator


def _gen_bounds(got16, got32, want16, want32, name):
    got16, got32, want16, ref = (_np(a) for a in (got16, got32, want16,
                                                  want32))
    D = np.abs(want16 - ref).max()
    err = np.abs(got16 - want16).max()
    assert D > 0, name
    assert err <= 2 * D and err <= 5e-2 * np.abs(ref).max(), (name, err, D)
    assert np.abs(got16 - got32).max() >= 0.25 * D, name


@pytest.mark.parametrize("plane_dtype", ["float32", "bfloat16"])
def test_synthesis_bf16_matches_tgi(pair, plane_dtype):
    gj, pj, gt, pt = pair
    z = np.random.RandomState(5).randn(1, 32).astype(np.float32)
    c = tiny_camera(0.3)
    outs = {}
    for fd in ("float32", "bfloat16"):
        pd = plane_dtype if fd == "bfloat16" else "float32"
        gjj, gtt = _bf16_pair(gj, gt, fused_dtype=fd, plane_dtype=pd)
        want = jit_ref(lambda p, z, c: gjj(p, z, c, truncation_psi=0.7,
                                           det=True))(pj, z, c)
        got = gtt(pt, torch.from_numpy(z), torch.from_numpy(c),
                  truncation_psi=0.7, det=True)
        outs[fd] = want, got
    for k in ("image", "image_raw", "image_depth", "planes"):
        assert outs["bfloat16"][1][k].dtype == torch.float32, k
        _gen_bounds(outs["bfloat16"][1][k], outs["float32"][1][k],
                    outs["bfloat16"][0][k], outs["float32"][0][k], k)


def test_bf16_planes_sample_in_float32():
    """``TriplaneSample``'s plain path on bf16 planes, against ``tgi``'s
    TPU route's semantics (``grid_sample.py:198-213``, ``:236-300``):
    sampled in float32 from the planes cast up, features in bf16;
    ``d_planes`` in bf16 from a float32 splat of the bf16 feature
    gradient cast up, ``d_coords`` in float32."""
    planes, coords, g = splat_inputs(6, 1, 8, 16, 16, 300, 1.0)
    p16 = jnp.asarray(planes, BF16)

    def tgi(p, c):
        return jgs.sample_triplanes(p.astype(jnp.float32), c,
                                    1.0).astype(BF16)

    want, vjp = jax.vjp(tgi, p16, jnp.asarray(coords))
    want_dp, want_dc = vjp(jnp.asarray(g, BF16))
    p = torch.from_numpy(planes).bfloat16().requires_grad_(True)
    c = torch.from_numpy(coords).requires_grad_(True)
    out = gs.sample_triplanes(p, c, 1.0)
    out.backward(torch.from_numpy(g).bfloat16())
    assert out.dtype == p.grad.dtype == torch.bfloat16
    assert c.grad.dtype == torch.float32
    ref = jax.vjp(lambda p, c: jgs.sample_triplanes(p, c, 1.0),
                  jnp.asarray(planes), jnp.asarray(coords))
    ref_dp, ref_dc = ref[1](jnp.asarray(g))
    _op_close(out, want, ref[0], "features")
    _op_close(p.grad, want_dp, ref_dp, "d_planes")
    err = np.abs(_np(c.grad) - _np(want_dc)).max()
    assert err <= 1e-5 * np.abs(_np(want_dc)).max(), err


# ---------------------------------------------------------------------------
# Stage 2 in bf16


@pytest.fixture(scope="module")
def coach_setup(pair):
    gj, pj, gt, pt = pair
    gen = torch.Generator().manual_seed(7)
    trunk = alexnet.alexnet_init(gen, "cpu")
    head = alexnet.alex_head_init(gen, "cpu")
    lp_j = JAlexLPIPSLoss(*(jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                         tree) for tree in (trunk, head)))
    rng = np.random.RandomState(8)
    out = dict(pj=pj, pt=pt, lp_t=AlexLPIPSLoss(trunk, head),
               ws=_rand(rng, 1, gt.cfg.num_ws, 32, scale=0.5),
               cam=tiny_camera(0.3),
               real=np.tanh(rng.randn(1, 3, 64, 64)).astype(np.float32))
    for fd in ("float32", "bfloat16"):
        gjj, gtt = _bf16_pair(gj, gt, fused_dtype=fd)
        cj = JPTICoach(gjj, lp_j, JCoachConfig(lpips_threshold=0.0))
        out[fd] = dict(gt=gtt, cj=cj, vg=jit_ref(jax.value_and_grad(
            cj._loss, has_aux=True)))
    out["adam"] = jit_ref(lambda g, st, p: out["bfloat16"]["cj"].opt.update(
        g, st, p))
    return out


def _draws(gt, key):
    res = gt.cfg.neural_rendering_resolution
    rk = gt.cfg.rendering_kwargs
    return render_draws(key, 1, res * res, rk["depth_resolution"],
                        rk["depth_resolution_importance"])


def _bf16_close(name, got, want16, ref):
    """The stage-2 bound: ‖got − tgi_bf16‖∞ ≤ 2·D + 2⁻⁷·max|ref| and
    ‖got − ref‖∞ ≤ D + 5e-2·max|ref|, D = ‖tgi_bf16 − ref‖∞."""
    got, want16, ref = _np(got), _np(want16), _np(ref)
    scale = np.abs(ref).max()
    D = np.abs(want16 - ref).max()
    err = np.abs(got - want16).max()
    assert err <= 2 * D + ULP2 * scale, (name, err, D, scale)
    err_ref = np.abs(got - ref).max()
    assert err_ref <= D + 5e-2 * scale, (name, err_ref, D, scale)


def test_stage2_loss_and_grads_bf16(pair, coach_setup):
    """Stage 2's ``_loss`` and the gradient of every leaf in bf16. The
    parameters and their gradients stay float32, ``noise_const``'s
    included (tgi tunes it too)."""
    s = coach_setup
    key = jax.random.PRNGKey(9)
    args = (s["ws"], s["cam"], s["real"])
    want = {fd: s[fd]["vg"](s["pj"], *args, key)
            for fd in ("float32", "bfloat16")}
    jitter, u = _draws(s["bfloat16"]["gt"], key)
    params = {k: v for k, v in s["pt"].items()}
    leaves = dict(leaves_with_paths(params))
    for t in leaves.values():
        t.requires_grad_(True)
        t.grad = None
    try:
        coach = PTICoach(s["bfloat16"]["gt"], s["lp_t"], CoachConfig())
        loss, aux = coach._loss(params, *(torch.from_numpy(a) for a in args),
                                jitter=jitter, u=u)
        loss.backward()
        (l16, a16), g16 = want["bfloat16"]
        (l32, a32), g32 = want["float32"]
        _bf16_close("loss", loss, l16, l32)
        _bf16_close("lpips", aux["lpips"], a16["lpips"], a32["lpips"])
        ref = dict(leaves_with_paths(g32))
        for path, w in leaves_with_paths(g16):
            t = leaves[path]
            if np.abs(np.asarray(ref[path])).max() == 0:
                assert t.grad is None or not t.grad.any(), path
                continue
            assert t.grad.dtype == torch.float32, path
            _bf16_close(path, t.grad, w, ref[path])
        noise = leaves[("backbone", "b16", "conv1", "noise_const")].grad
        assert noise is not None and noise.abs().max() > 0
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
            t.grad = None


def test_stage2_two_steps_bf16(coach_setup):
    """Two Adam steps of the port's ``tune`` in bf16 against tgi's
    ``_loss`` and optax Adam in bf16 applied step by step (tgi's while
    loop is never compiled), and the loss both tuned sets give on a third
    render with the same draws."""
    s = coach_setup
    keys = []
    key = jax.random.PRNGKey(10)
    for _ in range(3):
        key, k = jax.random.split(key)
        keys.append(k)
    args = (s["ws"], s["cam"], s["real"])
    params, ref_params = s["pj"], s["pj"]
    cj = s["bfloat16"]["cj"]
    opt_state, ref_state = cj.opt.init(params), cj.opt.init(params)
    losses, ref_losses, grads, ref_grads = [], [], [], []
    for k in keys[:2]:
        (loss, _), g = s["bfloat16"]["vg"](params, *args, k)
        (ref_loss, _), ref_g = s["float32"]["vg"](ref_params, *args, k)
        losses.append(loss)
        ref_losses.append(ref_loss)
        grads.append(g)
        # tgi's float32 gradient at tgi's bf16 parameters: D, the bf16
        # gradient's distance from float32, for the update bound.
        ref_grads.append(s["float32"]["vg"](params, *args, k)[1])
        upd, opt_state = s["adam"](g, opt_state, params)
        params = jax.tree.map(lambda p, d: p + d, params, upd)
        upd, ref_state = s["adam"](ref_g, ref_state, ref_params)
        ref_params = jax.tree.map(lambda p, d: p + d, ref_params, upd)

    gt = s["bfloat16"]["gt"]
    coach = PTICoach(gt, s["lp_t"], CoachConfig(lpips_threshold=0.0))
    tuned, info = coach.tune(s["pt"], *(torch.from_numpy(a) for a in args),
                             draws=lambda i: _draws(gt, keys[i]),
                             max_steps=2)
    assert info["steps"] == 2
    for got, want, ref in zip(info["losses"], losses, ref_losses):
        _bf16_close("loss", np.float32(got), want, ref)
    assert all(t.dtype == torch.float32 for _, t in leaves_with_paths(tuned))
    assert_updates_match(tuned, params, s["pj"], 2, grads=grads,
                         ref_grads=ref_grads)
    (want_after, _), _ = s["bfloat16"]["vg"](params, *args, keys[2])
    (ref_after, _), _ = s["float32"]["vg"](ref_params, *args, keys[2])
    jitter, u = _draws(gt, keys[2])
    with torch.no_grad():
        after, _ = coach._loss(tuned, *(torch.from_numpy(a) for a in args),
                               jitter=jitter, u=u)
    _bf16_close("loss after", after, want_after, ref_after)


# ---------------------------------------------------------------------------
# Stage 1 of a bf16 generator renders in float32


def test_stage1_render_fp32_bf16_generator(pair):
    """A bf16 generator's stage-1 ``_loss`` and every gradient under
    ``render_fp32=True`` (the default) against tgi's, within the fp32
    tests' 1e-4; the port's loss equals its fp32 generator's bit for bit,
    and differs without ``render_fp32``."""
    gj, pj, gt, pt = pair
    gj16, gt16 = _bf16_pair(gj, gt, fused_dtype="bfloat16")
    gen = torch.Generator().manual_seed(31)
    v = vgg.vgg16_init(gen, "cpu", width_mult=0.125)
    head = vgg.lpips_head_init(gen, "cpu", width_mult=0.125)
    rng = np.random.RandomState(32)
    with torch.no_grad():
        img = gt.synthesis(pt, torch.from_numpy(_rand(
            rng, 1, gt.cfg.num_ws, 32, scale=0.5)), torch.from_numpy(
                tiny_camera(0.25)))["image"].clamp(-1, 1)
    t255 = ((img + 1) * 127.5).numpy()
    pose = pose_resnet.resnet34_calibrate(
        pose_resnet.resnet34_init(gen, 4, "cpu", width_mult=0.125,
                                  blocks=(1, 1, 1, 1)),
        torch.from_numpy(t255))
    kw = dict(num_steps=4, cam_preheat_steps=2, w_avg_samples=64)
    j = lambda tree: jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)
    pr_j = jproj.Projector(gj16, pj, j(v), j(head), j(pose),
                           jproj.ProjectorConfig(**kw))
    with torch.no_grad():
        feats = vgg.lpips_features(v, head, torch.from_numpy(t255)).numpy()
    state_np = {
        "w": _rand(rng, 1, 1, 32, scale=0.5),
        "noise": {"/".join(p): rng.randn(*proj.get_path(pt, p).shape)
                  .astype(np.float32) for p in proj.collect_noise_paths(pt)},
        "translation": _rand(rng, 1, 3, scale=0.02),
        "pose": jax.tree.map(lambda t: t.numpy(), pose)}
    w_noise = _rand(rng, 1, 1, 32, scale=0.01)
    key = jax.random.PRNGKey(34)
    want_g, want_aux = jit_ref(jax.grad(pr_j._loss, has_aux=True))(
        jax.tree.map(jnp.asarray, state_np), t255, feats, w_noise, key,
        img.numpy())
    res = gt.cfg.neural_rendering_resolution
    rk = gt.cfg.rendering_kwargs
    draws = tuple(render_draws(k, 1, res * res, rk["depth_resolution"],
                               rk["depth_resolution_importance"])
                  for k in jax.random.split(key))

    def port(G, **cfg):
        pr = proj.Projector(G, pt, v, head, pose,
                            proj.ProjectorConfig(**kw, **cfg))
        state = jax.tree.map(
            lambda a: torch.from_numpy(np.array(a)).requires_grad_(True),
            state_np)
        loss, aux = pr._loss(state, torch.from_numpy(t255),
                             torch.from_numpy(feats),
                             torch.from_numpy(w_noise), draws=draws,
                             target_warp=img)
        return loss, aux, state

    loss, aux, state = port(gt16)
    loss.backward()
    want_loss = (want_aux["dist"] + want_aux["warp"] + want_aux["noise_reg"]
                 * pr_j.cfg.regularize_noise_weight)
    def rel(name, got, want):
        err = np.abs(_np(got) - _np(want)).max()
        assert err <= 1e-4 * np.abs(_np(want)).max(), (name, err)

    rel("loss", loss, want_loss)
    grads = dict(leaves_with_paths(want_g))
    for path, t in leaves_with_paths(state):
        rel(path, t.grad, grads[path])
    # The renders' terms: the noise regularizer (x 1e5) dwarfs them in
    # the loss.
    same, bf16 = port(gt)[1], port(gt16, render_fp32=False)[1]
    for k in ("dist", "warp"):
        assert torch.equal(aux[k], same[k]), k
        assert not torch.equal(aux[k], bf16[k]), k
