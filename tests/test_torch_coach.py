"""tgi_torch's stage-2 coach against tgi's, on the CPU, at
the tiny config (plane C = 8, 32² backbone, 16² rays, 8 + 8 samples,
SuperresolutionTiny, 64² images), with the same generator and
AlexNet-LPIPS weights on both sides and tgi's render draws handed to the
port.

Tolerances, relative to the reference's largest magnitude: 1e-5 on loss
values (fp32, a render, SR and AlexNet summed in another order), 1e-4 on
gradients (as in ``test_torch_gradients.py``). Parameters after Adam
steps: see ``torch_helpers.assert_updates_match``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tgi.invert.coach import CoachConfig as JCoachConfig
from tgi.invert.coach import PTICoach as JPTICoach
from tgi.losses.lpips import AlexLPIPSLoss as JAlexLPIPSLoss
from tgi_torch.invert.coach import CoachConfig, PTICoach
from tgi_torch.losses.lpips import AlexLPIPSLoss
from tgi_torch.models import alexnet

from torch_helpers import (assert_updates_match, close, jit_ref,
                           leaves_with_paths, render_draws, tiny_camera,
                           tiny_pair)


@pytest.fixture(scope="module")
def setup():
    gj, pj, gt, pt = tiny_pair()
    gen = torch.Generator().manual_seed(7)
    trunk = alexnet.alexnet_init(gen, "cpu")
    head = alexnet.alex_head_init(gen, "cpu")
    lp_t = AlexLPIPSLoss(trunk, head)
    lp_j = JAlexLPIPSLoss(*(jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                         tree) for tree in (trunk, head)))
    rng = np.random.RandomState(8)
    ws = (0.5 * rng.randn(1, gt.cfg.num_ws, 32)).astype(np.float32)
    cam = tiny_camera(0.3)
    real = np.tanh(rng.randn(1, 3, 64, 64)).astype(np.float32)
    cj = JPTICoach(gj, lp_j, JCoachConfig(lpips_threshold=0.0))
    # tgi's own loss, gradient and Adam update: the pieces its tune runs.
    vg = jit_ref(jax.value_and_grad(cj._loss, has_aux=True))
    adam = jit_ref(lambda g, st, p: cj.opt.update(g, st, p))
    return dict(gj=gj, pj=pj, gt=gt, pt=pt, lp_t=lp_t, cj=cj, vg=vg,
                adam=adam, ws=ws, cam=cam, real=real)


def _draws(gt, key):
    res = gt.cfg.neural_rendering_resolution
    rk = gt.cfg.rendering_kwargs
    return render_draws(key, 1, res * res, rk["depth_resolution"],
                        rk["depth_resolution_importance"])


def _step_keys(key, n):
    """The keys tgi's tune gives step 0, 1, ... (``key, k = split(key)``)."""
    out = []
    for _ in range(n):
        key, k = jax.random.split(key)
        out.append(k)
    return out


def _check_rel(name, got, want, rel):
    want = np.asarray(want)
    got = np.zeros_like(want) if got is None else got.detach().numpy()
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (name, err)


def test_loss_and_grads_match_tgi(setup):
    s = setup
    gt, pt = s["gt"], s["pt"]
    key = jax.random.PRNGKey(9)
    (want_loss, want_aux), want_g = s["vg"](s["pj"], s["ws"], s["cam"],
                                            s["real"], key)
    jitter, u = _draws(gt, key)
    params = {k: v for k, v in pt.items()}
    leaves = dict(leaves_with_paths(params))
    for t in leaves.values():
        t.requires_grad_(True)
        t.grad = None
    coach = PTICoach(gt, s["lp_t"], CoachConfig())
    loss, aux = coach._loss(params, torch.from_numpy(s["ws"]),
                            torch.from_numpy(s["cam"]),
                            torch.from_numpy(s["real"]), jitter=jitter, u=u)
    loss.backward()
    close(loss, want_loss, 1e-5)
    close(aux["l2"], want_aux["l2"], 1e-5)
    close(aux["lpips"], want_aux["lpips"], 1e-5)
    for path, want in leaves_with_paths(want_g):
        _check_rel(path, leaves[path].grad, want, 1e-4)
    for t in leaves.values():
        t.requires_grad_(False)
        t.grad = None


def _tgi_steps(s, keys):
    """tgi's loss, LPIPS and parameters per step: the body of its tune
    (``coach.py:133-154``: ``_loss``'s gradient, then its optax Adam
    update) with no threshold. Returns (losses, lpips, gradients, final
    params)."""
    cj, params = s["cj"], s["pj"]
    opt_state = cj.opt.init(params)
    losses, lps, grads = [], [], []
    for k in keys:
        (loss, aux), g = s["vg"](params, s["ws"], s["cam"], s["real"], k)
        losses.append(np.float32(loss))
        lps.append(np.float32(aux["lpips"]))
        grads.append(g)
        upd, opt_state = s["adam"](g, opt_state, params)
        params = jax.tree.map(lambda p, d: p + d, params, upd)
    return losses, lps, grads, params


def test_tune_trajectory_matches_tgi(setup):
    """Three Adam steps: the port's per-step losses and its tuned
    parameters against tgi's loss and optax Adam applied step by step
    (``test_torch_coach_tune.py`` holds the port against tgi's ``tune``
    itself), and the loss both sets of tuned parameters give on a fourth
    render with the same draws."""
    s = setup
    gt = s["gt"]
    keys = _step_keys(jax.random.PRNGKey(10), 4)
    want_losses, want_lps, grads, want_params = _tgi_steps(s, keys[:3])

    coach = PTICoach(gt, s["lp_t"], CoachConfig(lpips_threshold=0.0))
    tuned, info = coach.tune(s["pt"], torch.from_numpy(s["ws"]),
                             torch.from_numpy(s["cam"]),
                             torch.from_numpy(s["real"]),
                             draws=lambda i: _draws(gt, keys[i]),
                             max_steps=3)
    assert info["steps"] == 3
    close(np.asarray(info["losses"], np.float32), np.asarray(want_losses),
          1e-5)
    close(np.float32(info["final_lpips"]), want_lps[-1], 1e-5)
    assert_updates_match(tuned, want_params, s["pj"], 3, grads=grads)
    (want_after, _), _ = s["vg"](want_params, s["ws"], s["cam"], s["real"],
                                 keys[3])
    jitter, u = _draws(gt, keys[3])
    with torch.no_grad():
        after, _ = coach._loss(tuned, torch.from_numpy(s["ws"]),
                               torch.from_numpy(s["cam"]),
                               torch.from_numpy(s["real"]), jitter=jitter,
                               u=u)
    close(after, want_after, 1e-5)
    # The caller's params are untouched.
    assert all(not t.requires_grad for _, t in leaves_with_paths(s["pt"]))


def test_early_stop_checks_before_the_update(setup):
    """LPIPS at or below the threshold stops the loop before its update:
    a threshold above the first step's LPIPS stops at step 0 with no
    update; one between step 0's and step 1's stops after one update."""
    s = setup
    gt = s["gt"]
    keys = _step_keys(jax.random.PRNGKey(11), 2)
    _, lps, _, _ = _tgi_steps(s, keys)
    assert lps[1] < lps[0]
    args = (s["pt"], torch.from_numpy(s["ws"]), torch.from_numpy(s["cam"]),
            torch.from_numpy(s["real"]))
    calls = []
    for thr, steps in ((lps[0] + 1.0, 0), (0.5 * (lps[0] + lps[1]), 1)):
        coach = PTICoach(gt, s["lp_t"], CoachConfig(lpips_threshold=thr))
        tuned, info = coach.tune(
            *args, draws=lambda i: _draws(gt, keys[i]), max_steps=5,
            checkpoint_fn=lambda step, p: calls.append(step))
        assert info["steps"] == steps
        close(np.float32(info["final_lpips"]), lps[steps], 1e-5)
        assert len(info["losses"]) == steps + 1
        same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            leaves_with_paths(tuned), leaves_with_paths(s["pt"])))
        assert same == (steps == 0)
    assert calls == [1]
