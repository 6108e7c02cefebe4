"""SSIM and MS-SSIM (``tgi_torch/metrics/msssim.py``) against tgi's, on
the CPU: at 256² (all five scales) and below 176 px, where the coarse
scales drop and the weights renormalize, on pairs from near-equal to
unrelated. Tolerance: 1e-5 absolute (the metrics lie in [0, 1])."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tgi.metrics import ms_ssim as jms_ssim
from tgi.metrics import ssim as jssim
from tgi_torch.metrics import ms_ssim, ssim
from tgi_torch.metrics.msssim import _filter2d_sep, _gaussian_window

TOL = 1e-5


def _pair(res, noise, seed):
    rng = np.random.RandomState(seed)
    a = rng.rand(2, 3, res, res).astype(np.float32)
    b = np.clip(a + noise * rng.randn(*a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("res", [256, 128, 48])
@pytest.mark.parametrize("noise", [0.02, 0.3])
def test_ms_ssim_and_ssim(res, noise):
    a, b = _pair(res, noise, res)
    for got, want in ((ms_ssim(torch.from_numpy(a), torch.from_numpy(b)),
                       jms_ssim(jnp.asarray(a), jnp.asarray(b))),
                      (ssim(torch.from_numpy(a), torch.from_numpy(b)),
                       jssim(jnp.asarray(a), jnp.asarray(b)))):
        want = np.asarray(want)
        assert got.shape == want.shape == (2,)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
        assert np.isfinite(got.numpy()).all()


def test_identical_images_score_one():
    a, _ = _pair(64, 0.0, 3)
    t = torch.from_numpy(a)
    np.testing.assert_allclose(ms_ssim(t, t).numpy(), 1.0, atol=1e-6)


def test_separable_filter_is_the_valid_gaussian_convolution():
    """The shifted multiply-adds equal a 'VALID' 11x11 Gaussian
    convolution in float64."""
    x = np.random.RandomState(4).rand(1, 2, 20, 23)
    g = _gaussian_window().astype(np.float64)
    k = np.outer(g, g)
    want = np.zeros((1, 2, 10, 13))
    for i in range(10):
        for j in range(13):
            want[..., i, j] = (x[..., i:i + 11, j:j + 11] * k).sum((-1, -2))
    got = _filter2d_sep(torch.from_numpy(x), g)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
