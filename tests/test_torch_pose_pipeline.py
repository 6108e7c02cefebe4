"""The pose pipeline (``tgi_torch/apps/pose_pipeline.py``) against tgi's,
on the CPU: the geodesic rotation loss, the head parameterizations,
``pose_loss`` and its gradients for each head mode, two steps of
``train_pose_estimator`` against ``pose_loss``'s gradient plus
``optax.adam`` on tgi's own minibatches, and the pseudo-dataset written
as PNGs and read back.

A small pose net (``width_mult`` 1/8, one block per stage, BatchNorm
calibrated on the images so the tanh head does not saturate), the port's
weights carried to tgi. Tolerances: losses and gradients 1e-4 relative to
their largest value; the Adam updates through
``torch_helpers.assert_updates_match``; a loss after an update 1e-3."""

import math

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from tgi.apps import pose_pipeline as jpp
from tgi.render import cameras as jcameras
from tgi_torch.apps import pose_pipeline as pp
from tgi_torch.models import pose_resnet
from tgi_torch.render import cameras

from torch_helpers import (TINY, TINY_RK, assert_updates_match, jit_ref,
                           leaves_with_paths)

DIMS = {"quat": 4, "6d": 6, "2d": 2}


def _j(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), tree)


def _rel(got, want, tol=1e-4, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (name, err)


def _data(n, seed, res=32):
    rng = np.random.RandomState(seed)
    imgs = (rng.rand(n, 3, res, res) * 255).astype(np.float32)
    yaw = math.pi / 2 + 0.5 * rng.randn(n)
    pitch = math.pi / 2 + 0.2 * rng.randn(n)
    exts = cameras.look_at_pose(torch.tensor(yaw), torch.tensor(pitch),
                                torch.zeros(3), radius=2.7,
                                device="cpu").numpy()
    return imgs, exts


def _net(mode, imgs, seed=61):
    gen = torch.Generator().manual_seed(seed)
    p = pose_resnet.resnet34_init(gen, DIMS[mode], "cpu", width_mult=0.125,
                                  blocks=(1, 1, 1, 1))
    return pose_resnet.resnet34_calibrate(p, torch.from_numpy(imgs))


def test_geodesic_rotation_loss():
    _, exts = _data(5, 62)
    r1 = exts[:, :3, :3]
    r2 = np.roll(r1, 1, axis=0)
    for a, b in ((r1, r2), (r1, r1)):
        got = pp.geodesic_rotation_loss(torch.from_numpy(a),
                                        torch.from_numpy(b))
        want = jpp.geodesic_rotation_loss(jnp.asarray(a), jnp.asarray(b))
        assert abs(float(got) - float(want)) <= 1e-5


@pytest.mark.parametrize("mode", ["quat", "6d", "2d"])
def test_head_to_rotmat(mode):
    pred = np.random.RandomState(63).uniform(
        -0.9, 0.9, (4, DIMS[mode])).astype(np.float32)
    _rel(pp.head_to_rotmat(torch.from_numpy(pred), mode),
         jpp.head_to_rotmat(jnp.asarray(pred), mode), 1e-5, mode)


@pytest.mark.parametrize("mode", ["quat", "6d", "2d"])
def test_pose_loss_and_gradients(mode):
    imgs, exts = _data(4, 64)
    params = pose_resnet.resnet34_init(torch.Generator().manual_seed(65),
                                       DIMS[mode], "cpu", width_mult=0.125,
                                       blocks=(1, 1, 1, 1))
    params = pose_resnet.resnet34_calibrate(params, torch.from_numpy(imgs))
    leaves = pp.trainable(params)
    loss, aux = pp.pose_loss(leaves, torch.from_numpy(imgs),
                             torch.from_numpy(exts), mode)
    loss.backward()
    (want, want_aux), grads = jit_ref(
        jax.value_and_grad(jpp.pose_loss, has_aux=True),
        static_argnames=("mode",))(_j(params), jnp.asarray(imgs),
                                   jnp.asarray(exts), mode=mode)
    _rel(loss, want, name="loss")
    for k in ("rot", "trans"):
        _rel(aux[k], want_aux[k], name=k)
    g = dict(leaves_with_paths(grads))
    for path, t in leaves_with_paths(leaves):
        _rel(t.grad, g[path], name=".".join(path))


def test_train_pose_estimator_two_steps():
    """Two steps on tgi's minibatches (``RandomState(0).choice`` over the
    train split) against tgi's ``pose_loss`` gradient and optax's Adam;
    the one validation at the last step."""
    mode, lr, batch, steps = "quat", 1e-4, 3, 2
    imgs, exts = _data(10, 66)
    start = _net(mode, imgs)
    got, history = pp.train_pose_estimator(
        start, (imgs, exts), mode=mode, lr=lr, batch=batch, steps=steps,
        val_every=1000)

    n_val = min(max(batch, 10 // 10), 10 // 2)
    rng = np.random.RandomState(0)
    grad_fn = jit_ref(jax.value_and_grad(jpp.pose_loss, has_aux=True),
                      static_argnames=("mode",))
    opt = optax.adam(lr)
    p = _j(start)
    state = opt.init(p)
    grads, train = [], []
    for _ in range(steps):
        idx = rng.choice(np.arange(n_val, 10), batch)
        (loss, _), g = grad_fn(p, jnp.asarray(imgs[idx]),
                               jnp.asarray(exts[idx]), mode=mode)
        upd, state = opt.update(g, state, p)
        p = optax.apply_updates(p, upd)
        grads.append(g)
        train.append(float(loss))
    (vloss, _), _ = grad_fn(p, jnp.asarray(imgs[:batch]),
                            jnp.asarray(exts[:batch]), mode=mode)
    assert [h["step"] for h in history] == [steps]
    assert_updates_match(got, p, _j(start), steps, grads, lr=lr)
    # The losses after an update: elements whose gradient sits at the
    # rounding floor may step by lr either way in either package, which
    # moves these losses by ~1e-4 of their size; 1e-3 holds them.
    assert abs(history[0]["train"] - train[-1]) <= 1e-3 * abs(train[-1])
    assert abs(history[0]["val"] - float(vloss)) <= 1e-3 * abs(float(vloss))
    # The first step's loss, before any update, at 1e-4.
    _, first = pp.train_pose_estimator(start, (imgs, exts), mode=mode, lr=lr,
                                       batch=batch, steps=1)
    assert abs(first[0]["train"] - train[0]) <= 1e-4 * abs(train[0])


def test_pseudo_dataset_png_round_trip(tmp_path):
    """gen_pseudo_dataset writes each render and its cam2world; the
    loader reads back the PNG's bytes and the extrinsics to their 8
    written decimals."""
    pytest.importorskip("PIL")
    from tgi_torch.models.generator import (GeneratorConfig,
                                            TriPlaneGenerator,
                                            default_rendering_kwargs)
    from tgi_torch.utils.image import to_uint8
    G = TriPlaneGenerator(GeneratorConfig(
        rendering_kwargs=default_rendering_kwargs(**TINY_RK), **TINY))
    params = G.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(67)
    draws = [tuple(torch.from_numpy(rng.randn(*s).astype(np.float32))
                   for s in ((2, 32), (2,), (2,))) for _ in range(2)]
    n = pp.gen_pseudo_dataset(G, params, str(tmp_path), num_images=3,
                              batch=2, draws=lambda b: draws[b])
    assert n == 3
    imgs, exts = pp.load_pseudo_dataset(str(tmp_path), size=64)
    assert imgs.shape == (3, 3, 64, 64) and exts.shape == (3, 4, 4)
    with torch.no_grad():
        img, cams, _ = pp.pseudo_batch(G, params, *draws[1])
    np.testing.assert_array_equal(imgs[2].transpose(1, 2, 0),
                                  to_uint8(img[0]).astype(np.float32))
    np.testing.assert_allclose(exts[2], cams[0].numpy(), atol=1e-8)
    # The cameras are tgi's for the same angles.
    yaw = math.pi / 2 + draws[1][1] * 0.65
    pitch = np.clip(math.pi / 2 + draws[1][2] * 0.3, 1e-5, math.pi - 1e-5)
    want = jcameras.look_at_pose(jnp.asarray(yaw.numpy()),
                                 jnp.asarray(pitch.numpy()), jnp.zeros(3),
                                 radius=2.7)
    _rel(cams, want, 1e-5, "cams")
