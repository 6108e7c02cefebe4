"""Gradients through tgi_torch's generator against ``jax.grad`` of tgi's,
on the CPU, at the tiny config (plane C = 8, 32² backbone, 16² rays,
8 + 8 samples, SuperresolutionTiny), with tgi's weights carried over by
name.

The loss is a fixed random projection of ``image``, ``image_raw`` and
``image_depth``; every parameter leaf's gradient and the gradient with
respect to ``ws`` are compared, at ``det=True`` and at ``det=False`` with
tgi's draws (reproduced from its key) handed to the port. The render's
backward runs through ``TriplaneSample``'s plain splat.

Tolerance: ``max|got - want| <= 1e-4 * max|want|`` per leaf: fp32
rounding through the backbone's modulated convolutions, a two-pass
render with a sort, and the SR blocks, with sums in another order. A
leaf whose tgi gradient is exactly zero (the mapping network, unused by
``synthesis``) must get none or zero.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_helpers import (jit_ref, leaves_with_paths, render_draws,
                           tiny_camera, tiny_pair)

REL = 1e-4


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


def _weights(gt):
    rng = np.random.RandomState(11)
    img = gt.cfg.img_resolution
    res = gt.cfg.neural_rendering_resolution
    return (rng.randn(1, 3, img, img).astype(np.float32) / img,
            rng.randn(1, 3, res, res).astype(np.float32) / res,
            rng.randn(1, 1, res, res).astype(np.float32) / res)


@pytest.mark.parametrize("det", [True, False])
def test_synthesis_grads_match_tgi(pair, det):
    gj, pj, gt, pt = pair
    c = tiny_camera(0.3)
    ws = np.random.RandomState(12).randn(1, gt.cfg.num_ws, 32).astype(
        np.float32)
    r = _weights(gt)
    key = jax.random.PRNGKey(5)

    def loss_j(p, w):
        out = gj.synthesis(p, w, c, det=det, key=None if det else key)
        return sum(jnp.sum(out[k] * rk) for k, rk in
                   zip(("image", "image_raw", "image_depth"), r))

    want_p, want_w = jit_ref(jax.grad(loss_j, argnums=(0, 1)))(pj, ws)

    jitter = u = None
    if not det:
        res = gt.cfg.neural_rendering_resolution
        rk = gt.cfg.rendering_kwargs
        jitter, u = render_draws(key, 1, res * res, rk["depth_resolution"],
                                 rk["depth_resolution_importance"])
    params = {k: v for k, v in pt.items()}
    leaves = dict(leaves_with_paths(params))
    for t in leaves.values():
        t.requires_grad_(True)
        t.grad = None
    w = torch.from_numpy(ws).requires_grad_(True)
    out = gt.synthesis(params, w, torch.from_numpy(c), det=det, jitter=jitter,
                       u=u)
    loss = sum((out[k] * torch.from_numpy(rk)).sum() for k, rk in
               zip(("image", "image_raw", "image_depth"), r))
    loss.backward()

    def check(name, got, want):
        want = np.asarray(want)
        scale = np.abs(want).max()
        got = np.zeros_like(want) if got is None else got.numpy()
        err = np.abs(got - want).max()
        assert err <= REL * scale, (name, err, scale)
        return scale

    check("ws", w.grad, want_w)
    nonzero = set()
    for path, want in leaves_with_paths(want_p):
        if check(path, leaves[path].grad, want) > 0:
            nonzero.add(path[0])
    # The render carries gradient into the backbone, the decoder and SR.
    assert {"backbone", "decoder", "superresolution"} <= nonzero
    for t in leaves.values():
        t.requires_grad_(False)
