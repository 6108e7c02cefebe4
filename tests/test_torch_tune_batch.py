"""tgi_torch's batched stage-2 coach (``PTICoach.tune_batch``) on the CPU
at the tiny config (plane C = 8, 32² backbone, 16² rays, 8 + 8 samples,
SuperresolutionTiny, 64² images) with AlexNet-LPIPS, B = 2 images at
two yaws, each tuning its own copy of the generator:

* the images equal sequential ``tune`` calls on their own draws;
* a threshold that stops image 1 after two updates while image 0 runs
  on: image 1's weights, Adam moments and step count equal its own
  sequential run's (``tune``'s loop with ``torch.optim.Adam``, by hand,
  for the moments), image 0's its own ``tune``;
* one batched step against tgi's ``_loss`` and ``optax.adam`` per image
  (the body of tgi's ``tune``, coach.py:133-154; its vmapped while-loop
  is never compiled), one jitted function for the file;
* ``remat``: the same numbers when the render is recomputed in the
  backward pass, its draws given as tensors;
* the locality regulariser per image against its one-image call;
* ``MaskedAdam`` against ``torch.optim.Adam`` per image.

Tolerances: losses and LPIPS 1e-5 relative (fp32, a render, SR and
AlexNet summed in another order); tuned weights through the update each
element received (``torch_helpers.assert_updates_match``, as
``test_torch_coach.py``); Adam moments within 1e-4 of each leaf's
largest first moment and 2e-4 of its largest second moment (the
gradients agree to 1e-4 of their largest value); the locality term 1e-5
and its gradient 1e-4; ``MaskedAdam`` 1e-6; remat 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tgi.invert.coach import CoachConfig as JCoachConfig
from tgi.invert.coach import PTICoach as JPTICoach
from tgi.losses.lpips import AlexLPIPSLoss as JAlexLPIPSLoss
from tgi_torch.invert.coach import (CoachConfig, MaskedAdam, PTICoach,
                                    _leaves, _map)
from tgi_torch.losses.locality import LocalityConfig, SpaceRegularizer
from tgi_torch.losses.lpips import AlexLPIPSLoss
from tgi_torch.models import alexnet
from tgi_torch.models.generator import take_image

from torch_helpers import (assert_updates_match, close, jit_ref,
                           leaves_with_paths, render_draws, tiny_camera,
                           tiny_pair)

B = 2


@pytest.fixture(scope="module")
def setup():
    gj, pj, gt, pt = tiny_pair()
    gen = torch.Generator().manual_seed(7)
    trunk = alexnet.alexnet_init(gen, "cpu")
    head = alexnet.alex_head_init(gen, "cpu")
    lp_t = AlexLPIPSLoss(trunk, head)
    rng = np.random.RandomState(8)
    ws = torch.from_numpy((0.5 * rng.randn(B, 1, 1, 32)).astype(
        np.float32)).repeat(1, 1, gt.cfg.num_ws, 1)
    cams = torch.from_numpy(np.stack([tiny_camera(0.3), tiny_camera(-0.2)]))
    # Image 0: a far target; image 1: its own pivot's render, whose LPIPS
    # starts low and falls, so a threshold can stop it first.
    with torch.no_grad():
        pivot1 = gt.synthesis(pt, ws[1], cams[1])["image"].clamp(-1, 1)
    real = torch.stack([torch.from_numpy(np.tanh(rng.randn(1, 3, 64, 64))
                                         .astype(np.float32)), pivot1])
    return dict(gj=gj, pj=pj, gt=gt, pt=pt, lp_t=lp_t, trunk=trunk,
                head=head, ws=ws, cams=cams, real=real)


def _gens(seed):
    return [torch.Generator().manual_seed(seed + b) for b in range(B)]


def _first_grads(coach, s, b, seed):
    """Image b's first-step gradient, on the draws its generator gives."""
    params = _map(lambda t: t.detach().clone().requires_grad_(True),
                  s["pt"])
    loss, _ = coach._loss(params, s["ws"][b], s["cams"][b], s["real"][b],
                          generator=torch.Generator().manual_seed(seed))
    loss.backward()
    return _map(lambda t: (np.zeros(t.shape, np.float32) if t.grad is None
                           else t.grad.numpy()), params)


def _np_tree(tree):
    return _map(lambda t: t.detach().numpy(), tree)


def test_images_equal_sequential_tunes(setup):
    s = setup
    coach = PTICoach(s["gt"], s["lp_t"], CoachConfig(lpips_threshold=0.0))
    tuned, info = coach.tune_batch(s["pt"], s["ws"], s["cams"], s["real"],
                                   generators=_gens(50), max_steps=3)
    assert info["steps"] == [3, 3] and info["losses"].shape == (3, B)
    assert info["adam"].t == [3, 3]
    for b in range(B):
        one, one_info = coach.tune(s["pt"], s["ws"][b], s["cams"][b],
                                   s["real"][b], max_steps=3,
                                   generator=torch.Generator().manual_seed(
                                       50 + b))
        close(info["losses"][:, b], np.asarray(one_info["losses"],
                                               np.float32), 1e-5)
        close(np.float32(info["final_lpips"][b]),
              np.float32(one_info["final_lpips"]), 1e-5)
        assert_updates_match(take_image(tuned, b), _np_tree(one),
                             _np_tree(s["pt"]), 3,
                             grads=[_first_grads(coach, s, b, 50 + b)])


def _by_hand(coach, s, b, seed, thr, max_steps):
    """``tune``'s loop for image b with its torch Adam kept: (params,
    optimizer, steps)."""
    params = _map(lambda t: t.detach().clone().requires_grad_(True),
                  s["pt"])
    opt = torch.optim.Adam(list(_leaves(params)), lr=3e-4,
                           betas=(0.9, 0.999), eps=1e-8)
    gen = torch.Generator().manual_seed(seed)
    steps = 0
    for _ in range(max_steps):
        loss, aux = coach._loss(params, s["ws"][b], s["cams"][b],
                                s["real"][b], generator=gen)
        if not float(aux["lpips"].detach()) > thr:
            break
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        steps += 1
    return params, opt, steps


def test_an_image_stops_early_while_the_other_runs_on(setup):
    s = setup
    base = PTICoach(s["gt"], s["lp_t"], CoachConfig(lpips_threshold=0.0))
    # Each image's LPIPS at steps 0-3 without a threshold: the LPIPS of
    # the last render of a k-step tune.
    lps = [[base.tune(s["pt"], s["ws"][b], s["cams"][b], s["real"][b],
                      max_steps=k, generator=torch.Generator().manual_seed(
                          60 + b))[1]["final_lpips"] for k in range(1, 5)]
           for b in range(B)]
    thr = 0.5 * (lps[1][2] + min(lps[1][:2]))
    assert lps[1][2] < min(lps[1][:2]) and min(lps[0]) > thr, lps
    coach = PTICoach(s["gt"], s["lp_t"], CoachConfig(lpips_threshold=thr))
    tuned, info = coach.tune_batch(s["pt"], s["ws"], s["cams"], s["real"],
                                   generators=_gens(60), max_steps=4)
    assert info["steps"] == [4, 2]
    assert info["adam"].t == [4, 2]
    assert np.isnan(info["losses"][3, 1]) and not np.isnan(
        info["losses"][2, 1])
    close(np.float32(info["final_lpips"][1]), np.float32(lps[1][2]), 1e-5)
    # Image 0 ran on: its own tune under the same threshold.
    one, one_info = coach.tune(s["pt"], s["ws"][0], s["cams"][0],
                               s["real"][0], max_steps=4,
                               generator=torch.Generator().manual_seed(60))
    assert one_info["steps"] == 4
    close(info["losses"][:, 0], np.asarray(one_info["losses"], np.float32),
          1e-5)
    assert_updates_match(take_image(tuned, 0), _np_tree(one),
                         _np_tree(s["pt"]), 4,
                         grads=[_first_grads(coach, s, 0, 60)])
    # Image 1 stopped after two updates and stayed there while image 0
    # took two more: weights and moments as its own run's.
    params, opt, steps = _by_hand(coach, s, 1, 61, thr, 4)
    assert steps == 2
    assert_updates_match(take_image(tuned, 1), _np_tree(params),
                         _np_tree(s["pt"]), 2,
                         grads=[_first_grads(coach, s, 1, 61)])
    adam = info["adam"]
    held = 0
    for p, m, v in zip(_leaves(params), adam.m, adam.v):
        st = opt.state.get(p)
        if st is None:
            assert not m[1].any() and not v[1].any()
            continue
        for got, want, tol in ((m[1], st["exp_avg"], 1e-4),
                               (v[1], st["exp_avg_sq"], 2e-4)):
            err = float((got - want).abs().max())
            assert err <= tol * float(want.abs().max()), err
        held += 1
    assert held > 10


def test_one_batched_step_matches_tgi(setup):
    """Each image's first step against tgi's ``_loss`` gradient and optax
    Adam update on that image's key."""
    s = setup
    gt = s["gt"]
    lp_j = JAlexLPIPSLoss(*(jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                         tree)
                            for tree in (s["trunk"], s["head"])))
    cj = JPTICoach(s["gj"], lp_j, JCoachConfig(lpips_threshold=0.0))

    def step(params, ws, cam, real, key):
        (loss, aux), g = jax.value_and_grad(cj._loss, has_aux=True)(
            params, ws, cam, real, key)
        upd, _ = cj.opt.update(g, cj.opt.init(params), params)
        return loss, aux["lpips"], g, jax.tree.map(lambda p, d: p + d,
                                                   params, upd)

    tgi_step = jit_ref(step)
    keys = jax.random.split(jax.random.PRNGKey(70), B)
    res = gt.cfg.neural_rendering_resolution
    rk = gt.cfg.rendering_kwargs
    draws = [render_draws(k, 1, res * res, rk["depth_resolution"],
                          rk["depth_resolution_importance"]) for k in keys]
    coach = PTICoach(gt, s["lp_t"], CoachConfig(lpips_threshold=0.0))
    tuned, info = coach.tune_batch(
        s["pt"], s["ws"], s["cams"], s["real"], max_steps=1,
        draws=lambda i: (torch.cat([d[0] for d in draws]),
                         torch.cat([d[1] for d in draws])))
    for b in range(B):
        loss, lpips, g, want = tgi_step(
            s["pj"], jnp.asarray(s["ws"][b].numpy()),
            jnp.asarray(s["cams"][b].numpy()),
            jnp.asarray(s["real"][b].numpy()), keys[b])
        close(info["losses"][0, b], np.float32(loss), 1e-5)
        close(np.float32(info["final_lpips"][b]), np.float32(lpips), 1e-5)
        assert_updates_match(take_image(tuned, b), want, s["pj"], 1,
                             grads=[g])


def test_remat_gives_the_same_numbers(setup):
    s = setup
    out = {}
    for remat in (False, True):
        coach = PTICoach(s["gt"], s["lp_t"],
                         CoachConfig(lpips_threshold=0.0, remat=remat))
        out[remat] = coach.tune_batch(s["pt"], s["ws"], s["cams"],
                                      s["real"], generators=_gens(80),
                                      max_steps=2)
    close(out[True][1]["losses"], out[False][1]["losses"].numpy(), 1e-6)
    for (p1, a), (p2, b) in zip(leaves_with_paths(out[True][0]),
                                leaves_with_paths(out[False][0])):
        assert p1 == p2
        close(a, b.numpy(), 1e-6)


def test_locality_term_per_image(setup):
    s = setup
    gt = s["gt"]
    reg = SpaceRegularizer(gt, s["pt"], s["lp_t"],
                           cfg=LocalityConfig(num_samples=2))
    copies = [_map(lambda t, b=b: t + 0.01 * (b + 1), s["pt"])
              for b in range(B)]
    from tgi_torch.models.pose_resnet import stack_nets
    stacked = _map(lambda t: t.detach().clone().requires_grad_(True),
                   stack_nets(copies))
    z = torch.from_numpy(np.random.RandomState(90).randn(B, 2, 32).astype(
        np.float32))
    terms = reg.per_image(stacked, s["ws"][:, 0], s["cams"][:, 0], z=z)
    terms.sum().backward()
    got = dict(leaves_with_paths(stacked))
    for b in range(B):
        one_p = _map(lambda t: t.detach().clone().requires_grad_(True),
                     copies[b])
        one = reg(one_p, s["ws"][b], z=z[b], camera=s["cams"][b])
        one.backward()
        close(terms[b], np.float32(one.detach()), 1e-5)
        n = 0
        for path, t in leaves_with_paths(one_p):
            if t.grad is not None:
                close(got[path].grad[b], t.grad.numpy(), 1e-4)
                n += 1
        assert n > 10


def test_masked_adam_is_torch_adam_per_image():
    rng = np.random.RandomState(95)
    start = torch.from_numpy(rng.randn(3, 4, 5).astype(np.float32))
    p = start.clone().requires_grad_(True)
    opt = MaskedAdam([p], lr=1e-2)
    mine = [start[b].clone().requires_grad_(True) for b in range(3)]
    ref = [torch.optim.Adam([q], lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
           for q in mine]
    for go in ([1, 1, 1], [1, 0, 1], [1, 0, 0], [1, 0, 0]):
        g = torch.from_numpy(rng.randn(3, 4, 5).astype(np.float32))
        p.grad = g.clone()
        opt.step(go)
        for b in range(3):
            if go[b]:
                mine[b].grad = g[b].clone()
                ref[b].step()
    assert opt.t == [4, 1, 2]
    for b in range(3):
        close(p[b].detach(), mine[b].detach().numpy(), 1e-6)
        close(opt.m[0][b], ref[b].state[mine[b]]["exp_avg"].numpy(), 1e-6)
        close(opt.v[0][b], ref[b].state[mine[b]]["exp_avg_sq"].numpy(),
              1e-6)
