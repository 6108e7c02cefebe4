"""tgi_torch's stage-1 projector against tgi's, on the CPU, at the tiny
config (plane C = 8, 32² backbone, 16² rays, 8 + 8 samples,
SuperresolutionTiny, 64² images) with a small VGG and pose net
(``width_mult`` 1/8, one block per pose-net stage, BatchNorm calibrated
on the target): the same weights on both sides, tgi's draws handed to
the port.

* ``_loss``, its aux values and the gradient of every leaf of the state
  (w, every noise buffer, the translation and every leaf of the pose
  tree, the BatchNorm running statistics included) against tgi's
  ``_loss`` and ``jax.grad``;
* a 4-step trajectory across the preheat/joint boundary
  (``cam_preheat_steps=2``) through the port's ``Projector.project``,
  against tgi's ``_loss`` gradient plus the optax updates of its step
  (``projector.py:546-612``) applied step by step. tgi's scan is never
  compiled.

Tolerances: the loss and each gradient 1e-4 relative to its largest
value. After the Adam steps: the losses and w 1e-4 relative; the noise
buffers, the pose tree and the translation (one of whose components
has a gradient at the rounding floor: the camera's position is
renormalized to the radius) through the update each element received
(see ``_updates_close``).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from tgi.invert import projector as jproj
from tgi.losses.basic import normalize_noise as jnormalize_noise
from tgi_torch.invert import projector as proj
from tgi_torch.models import pose_resnet, vgg

from torch_helpers import (jit_ref, leaves_with_paths, render_draws,
                           tiny_camera, tiny_pair)

STEPS, PREHEAT = 4, 2


def _j(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


def _rel(name, got, want, tol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (name, err)


@pytest.fixture(scope="module")
def setup():
    gj, pj, gt, pt = tiny_pair()
    gen = torch.Generator().manual_seed(31)
    v = vgg.vgg16_init(gen, "cpu", width_mult=0.125)
    head = vgg.lpips_head_init(gen, "cpu", width_mult=0.125)
    rng = np.random.RandomState(32)
    with torch.no_grad():
        w_t = torch.from_numpy((0.5 * rng.randn(1, gt.cfg.num_ws, 32))
                               .astype(np.float32))
        img = gt.synthesis(pt, w_t, torch.from_numpy(tiny_camera(0.25)))[
            "image"].clamp(-1, 1)
    target_full = img.numpy()
    target_255 = ((img + 1) * 127.5).numpy()
    pose = pose_resnet.resnet34_calibrate(
        pose_resnet.resnet34_init(gen, 4, "cpu", width_mult=0.125,
                                  blocks=(1, 1, 1, 1)),
        torch.from_numpy(target_255))
    kw = dict(num_steps=STEPS, cam_preheat_steps=PREHEAT, w_avg_samples=64)
    pr_j = jproj.Projector(gj, pj, _j(v), _j(head), _j(pose),
                           jproj.ProjectorConfig(**kw))
    pr_t = proj.Projector(gt, pt, v, head, pose, proj.ProjectorConfig(**kw))
    # The target's LPIPS features, an input of _loss in both packages
    # (held against tgi's in test_torch_vgg_pose.py).
    with torch.no_grad():
        feats = vgg.lpips_features(v, head, torch.from_numpy(
            target_255)).numpy()
    # tgi's own loss gradient, compiled once for the file.
    grad = jit_ref(jax.grad(pr_j._loss, has_aux=True))
    return dict(gt=gt, pr_j=pr_j, pr_t=pr_t, grad=grad, feats=feats,
                target_255=target_255, target_full=target_full, pose=pose)


def _draws(gt, key):
    """The draws of tgi's ``_loss(key=key)``: its key splits into the
    predicted and the canonical view's render keys."""
    res = gt.cfg.neural_rendering_resolution
    rk = gt.cfg.rendering_kwargs
    return tuple(render_draws(k, 1, res * res, rk["depth_resolution"],
                              rk["depth_resolution_importance"])
                 for k in jax.random.split(key))


def test_loss_and_every_gradient_match_tgi(setup):
    s = setup
    gt, pr_t = s["gt"], s["pr_t"]
    rng = np.random.RandomState(33)
    state_np = {
        "w": (0.5 * rng.randn(1, 1, 32)).astype(np.float32),
        "noise": {"/".join(p): rng.randn(*proj.get_path(
            pr_t.base_params, p).shape).astype(np.float32)
            for p in pr_t.noise_paths},
        "translation": (0.02 * rng.randn(1, 3)).astype(np.float32),
        "pose": jax.tree.map(lambda t: t.numpy(), s["pose"]),
    }
    w_noise = (0.01 * rng.randn(1, 1, 32)).astype(np.float32)
    key = jax.random.PRNGKey(34)
    # The warp target as run_pti gives it (the full-resolution target):
    # one call signature, so tgi's gradient compiles once for the file.
    want_g, want_aux = s["grad"](
        jax.tree.map(jnp.asarray, state_np), jnp.asarray(s["target_255"]),
        jnp.asarray(s["feats"]), jnp.asarray(w_noise), key,
        jnp.asarray(s["target_full"]))
    state = jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)).requires_grad_(True),
        state_np)
    loss, aux = pr_t._loss(state, torch.from_numpy(s["target_255"]),
                           torch.from_numpy(s["feats"]),
                           torch.from_numpy(w_noise),
                           draws=_draws(gt, key),
                           target_warp=torch.from_numpy(s["target_full"]))
    loss.backward()
    want_loss = (want_aux["dist"] + want_aux["warp"]
                 + want_aux["noise_reg"] * pr_t.cfg.regularize_noise_weight)
    _rel("loss", loss, want_loss)
    for k in ("dist", "warp", "noise_reg", "pred_cam"):
        _rel(k, aux[k], want_aux[k])
    assert float(aux["warp"].detach()) > 0 and float(aux["dist"].detach()) > 0
    got = dict(leaves_with_paths(state))
    grads = dict(leaves_with_paths(want_g))
    assert set(got) == set(grads)
    for path, t in got.items():
        _rel(path, t.grad, grads[path])
    # The camera's gradient crosses the render and the warp into the
    # pose net, the BatchNorm statistics included (tgi's camera Adam
    # moves them too).
    for path in (("pose", "fc3", "weight"), ("pose", "bn1", "running_mean"),
                 ("pose", "layer3", "0", "bn2", "running_var"),
                 ("translation",)):
        assert np.abs(np.asarray(grads[path])).max() > 0, path


def _tgi_update(pr):
    """The optax half of tgi's step (``projector.py:576-606``): the
    camera and translation Adams, in the joint phase the w + noise Adam at
    the step's learning rate, then the noise renormalization. Adam is
    elementwise, so each optimizer runs on its trees raveled into one
    vector: the same numbers, and a few ops to compile instead of one per
    leaf."""
    opts = pr._optimizers()
    groups = {"cam": ("pose",), "trans": ("translation",),
              "w": ("w", "noise")}

    def update(state, opt_states, g, lr, preheat):
        state, opt_states = dict(state), dict(opt_states)
        for name, keys in groups.items():
            if name == "w" and preheat:
                continue
            flat, unravel = ravel_pytree({k: state[k] for k in keys})
            gflat, _ = ravel_pytree({k: g[k] for k in keys})
            st = opt_states[name]
            if name == "w":
                st = st._replace(hyperparams={**st.hyperparams,
                                              "learning_rate": lr})
            upd, opt_states[name] = opts[name].update(gflat, st, flat)
            state.update(unravel(optax.apply_updates(flat, upd)))
        state["noise"] = {k: jnormalize_noise(v)
                          for k, v in state["noise"].items()}
        return state, opt_states

    def init(state):
        return {name: opts[name].init(ravel_pytree(
            {k: state[k] for k in keys})[0])
            for name, keys in groups.items()}

    return jit_ref(update, static_argnums=4), init


def _tgi_trajectory(s, key, target_warp):
    """tgi's step (``_make_step_batched``) with its ``_loss`` gradient
    compiled once: per step the metrics, the gradients and the w noise;
    then the final state. Returns also the port's inputs: the z batch,
    the noise re-draw and the per-step draws."""
    pr = s["pr_j"]
    cfg = pr.cfg
    target = jnp.asarray(s["target_255"])
    k_init, key = jax.random.split(key)
    state, _, w_std = jit_ref(pr.init_state)(k_init, target)
    z = np.asarray(jax.random.normal(jax.random.split(k_init)[0],
                                     (cfg.w_avg_samples, pr.G.cfg.z_dim)))
    noise0 = jax.tree.map(np.asarray, state["noise"])
    update, init = _tgi_update(pr)
    opt_states = init(state)
    start = jax.tree.map(np.asarray, state)
    losses, grads_hist, draws = [], [], []
    for i in range(cfg.num_steps):
        key, k_loss, k_wnoise = jax.random.split(key, 3)
        preheat = i < cfg.cam_preheat_steps
        t = (i - cfg.cam_preheat_steps) / max(
            cfg.num_steps - cfg.cam_preheat_steps, 1)
        scale = w_std * cfg.initial_noise_factor * max(
            0.0, 1.0 - t / cfg.noise_ramp_length) ** 2
        ramp = min(1.0, (1.0 - t) / cfg.lr_rampdown_length)
        ramp = (0.5 - 0.5 * np.cos(ramp * np.pi)) * min(
            1.0, t / cfg.lr_rampup_length)
        w_noise = (jnp.zeros_like(state["w"]) if preheat else
                   jax.random.normal(k_wnoise, state["w"].shape) * scale)
        g, aux = s["grad"](state, target, jnp.asarray(s["feats"]), w_noise,
                           k_loss, target_warp)
        losses.append(float(aux["dist"] + aux["warp"]))
        grads_hist.append(g)
        draws.append((None if preheat else torch.from_numpy(
            np.array(w_noise)), _draws(s["gt"], k_loss)))
        state, opt_states = update(state, opt_states, g,
                                   np.float32(cfg.first_inv_lr * ramp),
                                   preheat)
    return dict(z=z, noise=noise0, draws=draws, losses=losses,
                grads=grads_hist, start=start, final=state)


def _updates_close(name, got, want, start, grads, lr):
    """Adam moves an element by about ``lr`` per step whatever its
    gradient's size, so an element whose gradient sits at the fp32
    rounding floor may step either way in either package. Every element
    is held within ``2 · steps · lr`` of tgi's; an element whose
    gradient is at least 1e-2 of its leaf's largest at every step, whose
    steps rounding cannot turn, within ``2e-2 · steps · lr``."""
    steps = len(grads)
    d_want = np.asarray(want) - np.asarray(start)
    err = np.abs(got.numpy() - np.asarray(start) - d_want)
    assert err.max() <= 2 * steps * lr, (name, err.max())
    sure = np.ones(d_want.shape, bool)
    for g in grads:
        g = np.abs(np.asarray(g))
        sure &= g >= 1e-2 * g.max()
    assert (err[sure] <= 2e-2 * steps * lr).all(), (name, err[sure].max())
    return np.abs(d_want).max() > 0


def test_trajectory_across_the_preheat_boundary_matches_tgi(setup):
    s = setup
    pr_t, cfg = s["pr_t"], s["pr_j"].cfg
    key = jax.random.PRNGKey(35)
    ref = _tgi_trajectory(s, key, jnp.asarray(s["target_full"]))
    ws, cam, state, metrics = pr_t.project(
        torch.from_numpy(s["target_255"]),
        target_full=torch.from_numpy(s["target_full"]),
        z=torch.from_numpy(np.array(ref["z"])),
        noise={k: torch.from_numpy(np.array(v))
               for k, v in ref["noise"].items()},
        draws=lambda i: ref["draws"][i])
    _rel("losses", np.asarray(metrics["loss"], np.float32),
         np.asarray(ref["losses"], np.float32))
    final = ref["final"]
    _rel("w", state["w"], final["w"])
    assert np.abs(np.asarray(final["w"]) - ref["start"]["w"]).max() > 0
    moved = 0
    for group, lr in (("noise", cfg.first_inv_lr), ("pose", cfg.cam_lr),
                      ("translation", cfg.translation_lr)):
        start = dict(leaves_with_paths(ref["start"][group]))
        hist = [dict(leaves_with_paths(g[group])) for g in ref["grads"]]
        if group == "noise":      # w and noise move in the joint steps only
            hist = hist[PREHEAT:]
        for path, w in leaves_with_paths(final[group]):
            moved += _updates_close(path, _get(state[group], path), w,
                                    start[path], [h[path] for h in hist], lr)
    assert moved > 20
    # The pivots: w tiled to every layer, the camera of the tuned pose net.
    assert ws.shape == (1, s["gt"].cfg.num_ws, 32)
    assert torch.equal(ws[0, 0], state["w"][0, 0])
    want_cam = jproj.assemble_camera(
        jproj.resnet34_apply(final["pose"], jnp.asarray(s["target_255"])),
        final["translation"], "quat", 2.7,
        jnp.asarray(jproj.DEFAULT_INTRINSIC).reshape(9))[1]
    _rel("camera", cam, want_cam)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree
