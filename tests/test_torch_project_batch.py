"""tgi_torch's batched stage-1 projector (``Projector.project_batch``) on
the CPU at the tiny config (plane C = 8, 32² backbone, 16² rays, 8 + 8
samples, SuperresolutionTiny, 64² images) with small VGG and pose nets
(``width_mult`` 1/8, one block per stage), B = 2 targets at two yaws,
each image with its own pose net calibrated on its target:

* one batched step's per-image loss, aux values and the gradient of every
  leaf of every image's state against tgi's ``_loss`` and ``jax.grad``
  with that image's state, target and draws (tgi's batched scan is never
  compiled: its per-image step is this ``_loss``);
* a 5-step trajectory across the preheat/joint boundary
  (``cam_preheat_steps=2``) equal to B ``Projector.project`` calls on
  the same draws, each image with its own z batch and noise;
* the draws: image b draws from ``generators[b]`` what ``project`` draws
  from its generator, so image 0 (whose w_std the batch takes, as tgi
  takes ``w_std[0]``) equals a ``project`` call;
* ``normalize_noise`` and the noise regulariser per image, never across
  the stacked images;
* the e4e start per image;
* ``remat_render``: the same loss and gradients when the render is
  recomputed in the backward pass.

Tolerances: the loss and aux values against tgi 1e-4 relative to the
largest value (as ``test_torch_projector.py``); each gradient within
1e-4 of its largest value plus twice the one-image port's own distance
to tgi on the same image. Image 1's camera gradient is ill-conditioned
(the pose net's gradient reaches it through sample points and the warp's
foreground mask, where a rounding can move a point across a cell or the
mask's edge): there the one-image port itself stands up to 2.7e-3 of
the largest value from tgi, and the batched step up to 2.5e-3; on image
0 both stand within 3e-5. Batched against
sequential: losses, w and the cameras 1e-5 relative; the noise buffers,
the pose nets and the translation through the update each element
received (``_updates_close``: every element within 2 · steps · lr, the
elements whose first-step gradient is at least 1e-2 of their leaf's
largest within 2e-2 · steps · lr). The per-image helpers 1e-6;
remat 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tgi.invert import projector as jproj
from tgi_torch.invert import projector as proj
from tgi_torch.losses import basic
from tgi_torch.models import pose_resnet, vgg

from torch_helpers import (jit_ref, leaves_with_paths, render_draws,
                           tiny_camera, tiny_pair)

B, STEPS, PREHEAT = 2, 5, 2
YAWS = (0.25, -0.3)


def _j(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


def _rel(name, got, want, tol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = (want.detach().numpy() if isinstance(want, torch.Tensor)
            else np.asarray(want))
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (name, err)


@pytest.fixture(scope="module")
def setup():
    gj, pj, gt, pt = tiny_pair()
    gen = torch.Generator().manual_seed(31)
    v = vgg.vgg16_init(gen, "cpu", width_mult=0.125)
    head = vgg.lpips_head_init(gen, "cpu", width_mult=0.125)
    rng = np.random.RandomState(32)
    with torch.no_grad():
        w_t = torch.from_numpy((0.5 * rng.randn(B, 1, 32)).astype(
            np.float32)).repeat(1, gt.cfg.num_ws, 1)
        cams = torch.from_numpy(np.concatenate([tiny_camera(y)
                                                for y in YAWS]))
        img = gt.synthesis(pt, w_t, cams)["image"].clamp(-1, 1)
    t255 = (img + 1) * 127.5
    pose0 = pose_resnet.resnet34_init(gen, 4, "cpu", width_mult=0.125,
                                      blocks=(1, 1, 1, 1))
    nets = [pose_resnet.resnet34_calibrate(pose0, t255[b:b + 1])
            for b in range(B)]
    kw = dict(num_steps=STEPS, cam_preheat_steps=PREHEAT, w_avg_samples=64)
    pr_j = jproj.Projector(gj, pj, _j(v), _j(head), _j(nets[0]),
                           jproj.ProjectorConfig(**kw))
    pr_t = proj.Projector(gt, pt, v, head, nets[0],
                          proj.ProjectorConfig(**kw))
    with torch.no_grad():
        feats = vgg.lpips_features(v, head, t255)
    return dict(gt=gt, pt=pt, pr_j=pr_j, pr_t=pr_t, nets=nets, vgg=v,
                head=head, img=img, t255=t255, feats=feats,
                pose_b=pose_resnet.stack_nets(nets))


def _tgi_draws(gt, key):
    res = gt.cfg.neural_rendering_resolution
    rk = gt.cfg.rendering_kwargs
    return tuple(render_draws(k, 1, res * res, rk["depth_resolution"],
                              rk["depth_resolution_importance"])
                 for k in jax.random.split(key))


def _cat_draws(per_image):
    """Per-image ((jitter, u), (jitter, u)) -> the batch's."""
    return tuple((torch.cat([d[v][0] for d in per_image]),
                  torch.cat([d[v][1] for d in per_image])) for v in range(2))


def _states(setup, seed):
    """B one-image states as numpy trees, each with its own pose net."""
    pr = setup["pr_t"]
    rng = np.random.RandomState(seed)
    return [{"w": (0.5 * rng.randn(1, 1, 32)).astype(np.float32),
             "noise": {"/".join(p): rng.randn(*proj.get_path(
                 pr.base_params, p).shape).astype(np.float32)
                 for p in pr.noise_paths},
             "translation": (0.02 * rng.randn(1, 3)).astype(np.float32),
             "pose": jax.tree.map(lambda t: t.numpy(), setup["nets"][b])}
            for b in range(B)]


def _stacked(states):
    return jax.tree.map(
        lambda *a: torch.from_numpy(np.stack(a)).requires_grad_(True),
        *states)


def test_batched_step_matches_tgi_per_image(setup):
    s = setup
    gt, pr_t = s["gt"], s["pr_t"]
    grad = jit_ref(jax.grad(s["pr_j"]._loss, has_aux=True))
    states = _states(s, 33)
    rng = np.random.RandomState(34)
    w_noise = (0.01 * rng.randn(B, 1, 1, 32)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(35), B)
    state = _stacked(states)
    loss, aux = pr_t._loss_batch(
        state, s["t255"], s["feats"], torch.from_numpy(w_noise),
        _cat_draws([_tgi_draws(gt, k) for k in keys]),
        targets_warp=s["img"])
    loss.backward()
    got = dict(leaves_with_paths(state))
    total = 0.0
    for b in range(B):
        want_g, want_aux = grad(
            jax.tree.map(jnp.asarray, states[b]),
            jnp.asarray(s["t255"][b:b + 1].numpy()),
            jnp.asarray(s["feats"][b:b + 1].numpy()),
            jnp.asarray(w_noise[b]), keys[b],
            jnp.asarray(s["img"][b:b + 1].numpy()))
        for k in ("dist", "warp", "noise_reg"):
            _rel(f"{k}[{b}]", aux[k][b], want_aux[k])
        _rel(f"pred_cam[{b}]", aux["pred_cam"][b:b + 1],
             want_aux["pred_cam"])
        total += float(want_aux["dist"] + want_aux["warp"]
                       + want_aux["noise_reg"]
                       * pr_t.cfg.regularize_noise_weight)
        # The one-image port on the same image, for its own distance to
        # tgi (see the module's docstring).
        one = jax.tree.map(lambda a: torch.from_numpy(np.array(a))
                           .requires_grad_(True), states[b])
        pr_t._loss(one, s["t255"][b:b + 1], s["feats"][b:b + 1],
                   torch.from_numpy(w_noise[b]),
                   draws=_tgi_draws(gt, keys[b]),
                   target_warp=s["img"][b:b + 1])[0].backward()
        one = dict(leaves_with_paths(one))
        for path, g in leaves_with_paths(want_g):
            g = np.asarray(g)
            own = np.abs(one[path].grad.numpy() - g).max()
            err = np.abs(got[path].grad[b].numpy() - g).max()
            assert err <= 1e-4 * np.abs(g).max() + 2 * own, (path, b, err,
                                                             own)
        assert aux["warp"][b] > 0 and aux["dist"][b] > 0
    _rel("loss", loss, np.float32(total))


def _draws(seed, setup):
    """Per image: its z batch, its noise and per step its w noise and
    render draws, from a numpy seed."""
    pr, gt = setup["pr_t"], setup["gt"]
    rng = np.random.RandomState(seed)
    res = gt.cfg.neural_rendering_resolution
    rk = gt.cfg.rendering_kwargs
    M, D, Di = res * res, rk["depth_resolution"], \
        rk["depth_resolution_importance"]

    def f(*shape):
        return torch.from_numpy(rng.rand(*shape).astype(np.float32))

    out = []
    for _ in range(B):
        z = torch.from_numpy(rng.randn(64, 32).astype(np.float32))
        noise = {"/".join(p): torch.from_numpy(rng.randn(*proj.get_path(
            pr.base_params, p).shape).astype(np.float32))
            for p in pr.noise_paths}
        steps = [(torch.from_numpy(0.02 * rng.randn(1, 1, 32).astype(
            np.float32)), ((f(1, M, D, 1), f(M, Di)),
                           (f(1, M, D, 1), f(M, Di))))
            for _ in range(STEPS)]
        out.append((z, noise, steps))
    return out


def _updates_close(name, got, want, start, grad, steps, lr):
    """Every element within 2 · steps · lr of the sequential run's; an
    element whose first-step gradient is at least 1e-2 of its leaf's
    largest within 2e-2 · steps · lr."""
    d_want = want - start
    err = np.abs(got - start - d_want)
    assert err.max() <= 2 * steps * lr, (name, err.max())
    g = np.abs(grad)
    sure = g >= 1e-2 * g.max()
    assert (err[sure] <= 2e-2 * steps * lr).all(), (name, err[sure].max())
    return np.abs(d_want).max() > 0


def test_trajectory_equals_sequential_projections(setup):
    s = setup
    pr_t = s["pr_t"]
    cfg = pr_t.cfg
    per = _draws(36, s)
    seq = []
    for b, (z, noise, steps) in enumerate(per):
        pr_b = proj.Projector(s["gt"], s["pt"], s["vgg"], s["head"],
                              s["nets"][b], cfg)
        seq.append(pr_b.project(s["t255"][b:b + 1],
                                target_full=s["img"][b:b + 1], z=z,
                                noise=noise, draws=lambda i, st=steps: st[i]))
    ws, cams, state, metrics = pr_t.project_batch(
        s["t255"], targets_warp=s["img"], pose_params_b=s["pose_b"],
        z=torch.stack([p[0] for p in per]),
        noise={k: torch.stack([p[1][k] for p in per]) for k in per[0][1]},
        draws=lambda i: (torch.stack([p[2][i][0] for p in per]),
                         _cat_draws([p[2][i][1] for p in per])))
    assert ws.shape == (B, 1, s["gt"].cfg.num_ws, 32)
    assert cams.shape == (B, 1, 25)
    for k in ("loss", "dist", "warp"):
        assert metrics[k].shape == (STEPS, B)
    # Each image's first-step gradient, to tell the sure elements.
    moved = 0
    for b, (ws_b, cam_b, st_b, m_b) in enumerate(seq):
        z, noise, steps = per[b]
        _rel(f"loss[{b}]", metrics["loss"][:, b],
             np.asarray(m_b["loss"], np.float32), 1e-5)
        _rel(f"ws[{b}]", ws[b], ws_b, 1e-5)
        _rel(f"cam[{b}]", cams[b], cam_b, 1e-5)
        st0, _, _ = pr_t.init_state(z=z, noise=noise)
        st0["pose"] = jax.tree.map(lambda t: t.clone().requires_grad_(True),
                                   s["nets"][b])
        loss, _ = pr_t._loss(st0, s["t255"][b:b + 1], s["feats"][b:b + 1],
                             torch.zeros(1, 1, 32), draws=steps[0][1],
                             target_warp=s["img"][b:b + 1])
        loss.backward()
        g0 = dict(leaves_with_paths(st0))
        start = {"noise": {k: v.numpy() for k, v in noise.items()},
                 "pose": s["nets"][b],
                 "translation": np.zeros((1, 3), np.float32)}
        for group, lr in (("noise", cfg.first_inv_lr), ("pose", cfg.cam_lr),
                          ("translation", cfg.translation_lr)):
            want = dict(leaves_with_paths(st_b[group]))
            got = dict(leaves_with_paths(state[group]))
            st = dict(leaves_with_paths(start[group]))
            for path, w in want.items():
                g = g0[(group,) + path].grad
                # The noise's first gradient: the preheat's, through the
                # renders (its updates start after the preheat).
                moved += _updates_close(
                    path, got[path][b].numpy(), w.numpy(),
                    np.asarray(st[path]), g.numpy(),
                    STEPS - (PREHEAT if group == "noise" else 0), lr)
    assert moved > 20


def test_each_image_draws_from_its_own_generator(setup):
    s = setup
    pr_t = proj.Projector(s["gt"], s["pt"], s["vgg"], s["head"],
                          s["nets"][0], dataclasses.replace(
                              s["pr_t"].cfg, num_steps=3))
    gens = [torch.Generator().manual_seed(40 + b) for b in range(B)]
    ws, cams, state, metrics = pr_t.project_batch(
        s["t255"], targets_warp=s["img"], pose_params_b=s["pose_b"],
        generators=gens)
    ws0, cam0, st0, m0 = pr_t.project(
        s["t255"][:1], target_full=s["img"][:1],
        generator=torch.Generator().manual_seed(40))
    _rel("loss[0]", metrics["loss"][:, 0], np.asarray(m0["loss"],
                                                      np.float32), 1e-5)
    _rel("ws[0]", ws[0], ws0, 1e-5)
    _rel("cam[0]", cams[0], cam0, 1e-5)
    # Image 1 starts where its own generator puts it: its own z batch's
    # w mean (not image 0's), its own noise draw.
    st1, _, _ = pr_t.init_state(generator=torch.Generator().manual_seed(41))
    init, _, _ = pr_t.init_state_batch(
        B, generators=[torch.Generator().manual_seed(40 + b)
                       for b in range(B)])
    for k in ("w",):
        _rel(k, init[k][1], st1[k], 1e-6)
    for k, v in st1["noise"].items():
        assert torch.equal(init["noise"][k][1], v)
    assert not torch.equal(init["w"][0], init["w"][1])


def test_noise_helpers_per_image():
    rng = np.random.RandomState(37)
    maps = [torch.from_numpy((rng.randn(B, r, r) * (1 + b) + b).astype(
        np.float32)) for b, r in enumerate((16, 32))]
    reg = basic.noise_regularization_per_image(maps)
    for b in range(B):
        _rel(f"reg[{b}]", reg[b],
             basic.noise_regularization([m[b] for m in maps]), 1e-6)
        for m in maps:
            n = basic.normalize_noise_per_image(m)
            _rel("normalize", n[b], basic.normalize_noise(m[b]), 1e-6)
            assert abs(float(n[b].mean())) < 1e-5
            assert abs(float(n[b].square().mean()) - 1) < 1e-5
    # One mean and spread over the stack would differ.
    stacked = maps[1]
    assert not torch.allclose(basic.normalize_noise_per_image(stacked),
                              basic.normalize_noise(stacked))


def test_e4e_start_per_image(setup):
    s = setup
    rng = np.random.RandomState(38)
    proj_m = torch.from_numpy(rng.randn(3, 32).astype(np.float32))
    calls = []

    def e4e(t255):
        calls.append(t255.shape[0])
        return t255.mean(dim=(2, 3)) @ proj_m * 1e-3

    pr = proj.Projector(s["gt"], s["pt"], s["vgg"], s["head"], s["nets"][0],
                        s["pr_t"].cfg, e4e_encode=e4e)
    z = torch.from_numpy(rng.randn(B, 64, 32).astype(np.float32))
    state, _, _ = pr.init_state_batch(B, z=z, targets_255=s["t255"])
    assert calls == [1] * B
    for b in range(B):
        one, _, _ = pr.init_state(z=z[b], target_255=s["t255"][b:b + 1])
        _rel(f"w[{b}]", state["w"][b], one["w"], 1e-6)
    with pytest.raises(ValueError, match="targets_255"):
        pr.init_state_batch(B, z=z)


def test_remat_render_gives_the_same_numbers(setup):
    s = setup
    states = _states(s, 39)
    rng = np.random.RandomState(40)
    w_noise = torch.from_numpy((0.01 * rng.randn(B, 1, 1, 32)).astype(
        np.float32))
    draws = _cat_draws([_tgi_draws(s["gt"], k) for k in jax.random.split(
        jax.random.PRNGKey(41), B)])
    out = {}
    for remat in (False, True):
        pr = proj.Projector(s["gt"], s["pt"], s["vgg"], s["head"],
                            s["nets"][0], dataclasses.replace(
                                s["pr_t"].cfg, remat_render=remat))
        state = _stacked(states)
        loss, _ = pr._loss_batch(state, s["t255"], s["feats"], w_noise,
                                 draws, targets_warp=s["img"])
        loss.backward()
        out[remat] = (loss.detach(), dict(leaves_with_paths(state)))
    _rel("loss", out[True][0], out[False][0], 1e-6)
    for path, t in out[False][1].items():
        _rel(str(path), out[True][1][path].grad, t.grad, 1e-6)
