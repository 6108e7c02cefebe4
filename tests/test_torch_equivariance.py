"""The equivariance metrics (the port's ``metrics/equivariance.py``)
against tgi's, on the CPU, tgi run eagerly.

Each operator on the same images: the integer translation and the masks
exactly; the bandlimit filters (the same numpy) exactly; the fractional
translation, the affine resampling and the pseudo-rotation within 1e-5
of the image's largest magnitude (float32 FIR convolutions in two
libraries). The harness with ``samples=`` (tgi's z, translations and
angles) on the tiny SG3 generator: PSNRs within 1e-3 dB of tgi's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_helpers import sg3_pair
from tgi.metrics import equivariance as je
from tgi_torch.metrics import equivariance as te

REL = 1e-5


def _img(seed=0, res=32):
    return np.random.RandomState(seed).randn(2, 3, res, res).astype(
        np.float32)


def _close(got, want, exact=False):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    if exact:
        assert np.array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= REL * np.abs(want).max()


@pytest.mark.parametrize("t", [(0.125, -0.0625), (-0.3, 0.2), (1.2, 0.0)])
def test_integer_translation(t):
    x = _img()
    got = te.apply_integer_translation(torch.from_numpy(x), *t)
    want = je.apply_integer_translation(jnp.asarray(x), *t)
    for a, b in zip(got, want):
        _close(a, b, exact=True)


@pytest.mark.parametrize("t", [(0.1, -0.07), (-0.23, 0.31)])
def test_fractional_translation(t):
    x = _img(1)
    got = te.apply_fractional_translation(torch.from_numpy(x), *t)
    want = je.apply_fractional_translation(jnp.asarray(x), *t)
    _close(got[0], want[0])
    _close(got[1], want[1], exact=True)


def test_bandlimit_filter_and_rotation_matrix():
    for angle in (0.3, -2.1):
        m = te.rotation_matrix(angle)
        assert np.array_equal(m, je.rotation_matrix(angle))
        for kw in (dict(), dict(a=3, amax=6, up=1)):
            assert np.array_equal(
                te.construct_affine_bandlimit_filter(m, **kw),
                je.construct_affine_bandlimit_filter(m, **kw))


def test_affine_grid_and_nearest_sample():
    """The grid and the nearest-neighbour sample, ties included (the
    identity grid moved by half a pixel rounds half to even in both)."""
    theta = np.asarray([[0.9, 0.2, 0.05], [-0.1, 1.1, -0.25]], np.float32)
    g = te._affine_grid(theta, 2, 8, 12, "cpu")
    want = je._affine_grid(theta, 2, 8, 12)
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=0,
                               atol=1e-7)
    img = _img(2, 10)
    _close(te._grid_sample_nearest(torch.from_numpy(img), g),
           je._grid_sample_nearest(jnp.asarray(img), want), exact=True)
    ident = np.asarray([[1, 0, 0], [0, 1, 0]], np.float32)
    half = (te._affine_grid(ident, 2, 10, 10, "cpu")
            + torch.tensor([1 / 10, -1 / 10]))
    _close(te._grid_sample_nearest(torch.from_numpy(img), half),
           je._grid_sample_nearest(jnp.asarray(img), jnp.asarray(
               half.numpy())), exact=True)


@pytest.mark.parametrize("angle", [0.4, -1.3])
def test_rotation_operators(angle):
    x = _img(3)
    got = te.apply_fractional_rotation(torch.from_numpy(x), angle)
    want = je.apply_fractional_rotation(jnp.asarray(x), angle)
    _close(got[0], want[0])
    _close(got[1], want[1], exact=True)
    got = te.apply_fractional_pseudo_rotation(torch.from_numpy(x), angle)
    want = je.apply_fractional_pseudo_rotation(jnp.asarray(x), angle)
    _close(got[0], want[0])
    _close(got[1], want[1], exact=True)


class _Jitted:
    """tgi's SG3 generator with its forward jitted (one program for
    every transform)."""

    def __init__(self, g):
        self.cfg = g.cfg
        self.fn = jax.jit(lambda p, z: g(p, z, None))

    def __call__(self, params, z, c):
        return self.fn(params, z)


def test_harness_matches_tgi():
    """``compute_equivariance_metrics(samples=...)``: two batches of 2,
    all three metrics, tgi's draws handed to both (tgi's generator
    jitted once: its transform is a leaf of the params); then the port's
    own draws give finite PSNRs through ``gan_metrics``."""
    from tgi_torch.metrics.gan_metrics import equivariance_metrics
    gj, pj, gt, pt = sg3_pair()
    rng = np.random.RandomState(7)
    samples = [dict(z=rng.randn(2, 16).astype(np.float32),
                    t_int=np.round(rng.uniform(-0.125, 0.125, 2) * 32) / 32,
                    t_frac=rng.uniform(-0.125, 0.125, 2),
                    angle=float(rng.uniform(-np.pi, np.pi)))
               for _ in range(2)]
    kw = dict(eqt_int=True, eqt_frac=True, eqr=True)
    want = je.compute_equivariance_metrics(_Jitted(gj), pj, samples=samples,
                                           **kw)
    got = te.compute_equivariance_metrics(gt, pt, samples=samples, **kw)
    assert got.keys() == want.keys() == {"eqt_int", "eqt_frac", "eqr"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
    own = equivariance_metrics(gt, pt, num_samples=2, batch=2,
                               eqt_frac=True)
    assert own.keys() == {"eqt", "eqr", "eqt_frac"}
    assert all(np.isfinite(v) and v > 10 for v in own.values()), own
