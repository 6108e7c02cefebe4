"""tgi_torch's locality regulariser and the tuning step that adds it,
against tgi's, on the CPU at the tiny config (plane C = 8, 32² backbone,
16² rays, 8 + 8 samples, SuperresolutionTiny, 64² images), with the same
generator and AlexNet-LPIPS weights on both sides and tgi's z and render
draws handed to the port.

Tolerances as in ``test_torch_coach.py``: 1e-5 relative on loss values;
parameters after Adam steps through ``torch_helpers.assert_updates_match``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tgi.invert.coach import CoachConfig as JCoachConfig
from tgi.invert.coach import PTICoach as JPTICoach
from tgi.losses.locality import LocalityConfig as JLocalityConfig
from tgi.losses.locality import SpaceRegularizer as JSpaceRegularizer
from tgi.losses.lpips import AlexLPIPSLoss as JAlexLPIPSLoss
from tgi_torch.invert.coach import CoachConfig, PTICoach, _map
from tgi_torch.losses.locality import LocalityConfig, SpaceRegularizer
from tgi_torch.losses.lpips import AlexLPIPSLoss
from tgi_torch.models import alexnet
from tgi_torch.ops import grid_sample as gs

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
    # "Tuned" weights: the generator's with its decoder and last backbone
    # block moved, so the two renders differ.
    moved = _map(lambda t: t.clone(), pt)
    for path, t in leaves_with_paths(moved):
        if path[0] == "decoder" or "b32" in path:
            t.add_(0.05 * torch.from_numpy(np.asarray(
                rng.randn(*t.shape), np.float32)))
    moved_j = jax.tree.map(lambda t: jnp.asarray(t.numpy()), moved)
    return dict(gj=gj, pj=pj, gt=gt, pt=pt, lp_t=lp_t, lp_j=lp_j, ws=ws,
                cam=cam, real=real, moved=moved, moved_j=moved_j)


def _z(key, n=1):
    """tgi's z for ``key`` (locality.py's ``_interpolated_ws``)."""
    return torch.from_numpy(np.array(jax.random.normal(key, (n, 32))))


def test_space_regularizer_matches_tgi(setup):
    s = setup
    key = jax.random.PRNGKey(3)
    cfg = dict(num_samples=2, alpha=20.0)
    reg_j = JSpaceRegularizer(s["gj"], s["pj"], s["lp_j"],
                              jnp.asarray(s["cam"]), JLocalityConfig(**cfg))
    want = jit_ref(reg_j.__call__)(s["moved_j"], jnp.asarray(s["ws"]), key)
    reg = SpaceRegularizer(s["gt"], s["pt"], s["lp_t"],
                           torch.from_numpy(s["cam"]), LocalityConfig(**cfg))
    with torch.no_grad():
        got = reg(s["moved"], torch.from_numpy(s["ws"]), z=_z(key, 2))
    assert float(want) > 1e-3
    close(got, want, 1e-5)
    # At the original weights the term is zero.
    with torch.no_grad():
        zero = reg(s["pt"], torch.from_numpy(s["ws"]), z=_z(key, 2))
    assert float(zero) == 0.0


def test_only_the_tuned_render_has_a_backward(setup, monkeypatch):
    """The original weights' mapping and render run without autograd: in
    the backward only the tuned render's two passes splat, and the
    original weights get no gradient. z comes from the generator."""
    s = setup
    splats = []
    real = gs.triplane_splat_plain
    monkeypatch.setattr(gs, "triplane_splat_plain",
                        lambda *a, **k: splats.append(1) or real(*a, **k))
    original = _map(lambda t: t.clone().requires_grad_(True), s["pt"])
    new = _map(lambda t: t.clone().requires_grad_(True), s["moved"])
    reg = SpaceRegularizer(s["gt"], original, s["lp_t"],
                           torch.from_numpy(s["cam"]))
    loss = reg(new, torch.from_numpy(s["ws"]),
               generator=torch.Generator().manual_seed(0))
    loss.backward()
    assert len(splats) == 2
    assert all(t.grad is None for _, t in leaves_with_paths(original))
    for part in ("decoder", "backbone"):
        assert all(t.grad is not None for _, t in
                   leaves_with_paths(new[part])), part
    assert new["backbone"]["b32"]["conv1"]["weight"].grad.abs().max() > 0


def _draws(gt, key):
    res = gt.cfg.neural_rendering_resolution
    rk = gt.cfg.rendering_kwargs
    return render_draws(key, 1, res * res, rk["depth_resolution"],
                        rk["depth_resolution_importance"])


def test_locality_tuning_steps_match_tgi(setup, monkeypatch):
    """Two tuning steps with the regulariser: the port's losses and tuned
    parameters against tgi's ``_loss`` (whose render and locality draws
    both come from the step's key) and optax's Adam applied step by step,
    never through tgi's while loop. Each port step samples the planes 6
    times and splats 4 times (the original render has no backward)."""
    s = setup
    cj = JPTICoach(s["gj"], s["lp_j"], JCoachConfig(lpips_threshold=0.0),
                   locality_regularizer=JSpaceRegularizer(
                       s["gj"], s["pj"], s["lp_j"], camera=None))
    vg = jit_ref(jax.value_and_grad(cj._loss, has_aux=True))
    adam = jit_ref(lambda g, st, p: cj.opt.update(g, st, p))
    keys, key = [], jax.random.PRNGKey(10)
    for _ in range(2):
        key, k = jax.random.split(key)
        keys.append(k)
    params, opt_state = s["pj"], cj.opt.init(s["pj"])
    want_losses, grads = [], []
    for k in keys:
        (loss, _), g = vg(params, jnp.asarray(s["ws"]), jnp.asarray(s["cam"]),
                          jnp.asarray(s["real"]), k)
        want_losses.append(np.float32(loss))
        grads.append(g)
        upd, opt_state = adam(g, opt_state, params)
        params = jax.tree.map(lambda p, d: p + d, params, upd)

    counts = {"gather": 0, "splat": 0}
    for name, fn in (("gather", "sample_triplanes_plain"),
                     ("splat", "triplane_splat_plain")):
        real = getattr(gs, fn)

        def counted(*a, _real=real, _name=name, **k):
            counts[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(gs, fn, counted)
    coach = PTICoach(s["gt"], s["lp_t"], CoachConfig(lpips_threshold=0.0),
                     locality_regularizer=SpaceRegularizer(
                         s["gt"], s["pt"], s["lp_t"]))
    tuned, info = coach.tune(
        s["pt"], torch.from_numpy(s["ws"]), torch.from_numpy(s["cam"]),
        torch.from_numpy(s["real"]),
        draws=lambda i: (*_draws(s["gt"], keys[i]), _z(keys[i])),
        max_steps=2)
    assert info["steps"] == 2
    assert counts == {"gather": 12, "splat": 8}
    close(np.asarray(info["losses"], np.float32), np.asarray(want_losses),
          1e-5)
    assert_updates_match(tuned, params, s["pj"], 2, grads=grads)
