"""The port's ADA pipe against tgi's (tgi/train/augment.py), on the CPU
in fp32: the deterministic percentile path, the random path with tgi's
own draws, and the adaptive-p controller."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_helpers import close, with_tgi_draws
from tgi.train import augment as ja
from tgi_torch.train import augment as ta
from tgi_torch.utils.draws import TorchDraws

TOL = 1e-5
# Every tier, the reference's golden set (tests/test_augment.py) with the
# additive noise too: its field is drawn from tgi's key here.
ALL_ON = dict(imgfilter=1.0, noise=1.0, cutout=1.0)


def _images(C, seed=0, n=2, res=32):
    return np.random.RandomState(seed).randn(n, C, res, res).astype(
        np.float32)


@pytest.mark.parametrize("C", [3, 6])
@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.75])
def test_debug_percentile(q, C):
    """p = 1, every random value replaced by the percentile q."""
    img = _images(C)
    key = jax.random.PRNGKey(1)
    want = ja.augment_images(jnp.asarray(img), key, 1.0,
                             ja.AugmentConfig(**ALL_ON), debug_percentile=q)
    got = with_tgi_draws(key, lambda d: ta.augment_images(
        torch.from_numpy(img), d, 1.0, ta.AugmentConfig(**ALL_ON),
        debug_percentile=q))
    close(got, want, TOL)


@pytest.mark.parametrize("C,p", [(3, 0.5), (6, 1.0)])
def test_random_draws(C, p):
    """The random path with tgi's draws given as tensors (each gate, flip,
    angle, scale, band gain, noise field and cutout centre)."""
    img = _images(C, seed=1, n=4)
    key = jax.random.PRNGKey(2)
    want = ja.augment_images(jnp.asarray(img), key, p,
                             ja.AugmentConfig(**ALL_ON))
    got = with_tgi_draws(key, lambda d: ta.augment_images(
        torch.from_numpy(img), d, p, ta.AugmentConfig(**ALL_ON)))
    close(got, want, TOL)


def test_pipe_pair_matches_tgi():
    """AugmentPipe: image and raw image through one 6-channel pipe."""
    img, raw = _images(3, seed=2), _images(3, seed=3, res=16)
    key = jax.random.PRNGKey(3)
    wi, wr = ja.AugmentPipe()(jnp.asarray(img), jnp.asarray(raw), key, 0.7)
    gi, gr = with_tgi_draws(key, lambda d: ta.AugmentPipe()(
        torch.from_numpy(img), torch.from_numpy(raw), d, 0.7))
    close(gi, wi, TOL)
    close(gr, wr, TOL)


def test_pipe_identity_at_p0():
    """p = 0: the wavelet up/warp/down round trip leaves the image (sym6
    reconstruction error ~3e-5); the raw half passes the antialiased
    2x resize round trip."""
    from tgi_torch.nn.discriminator import filtered_resizing
    img = torch.from_numpy(_images(3, seed=4))
    raw = torch.from_numpy(_images(3, seed=5, res=16))
    out, out_raw = ta.AugmentPipe()(img, raw,
                                    TorchDraws(torch.Generator()), 0.0)
    assert (out - img).abs().max() < 1e-4
    want_raw = filtered_resizing(filtered_resizing(raw, 32), 16)
    assert (out_raw - want_raw).abs().max() < 1e-3


def test_gate_rates():
    """The port's own draws keep the reference's rates: xflip draws
    floor(u * 2), so half of the gated samples flip; rotation splits p
    into pre and post at 1 - sqrt(1 - p)."""
    n = 4000
    draws = TorchDraws(torch.Generator().manual_seed(5))
    cfg = ta.AugmentConfig(rotate90=0, xint=0, scale=0, rotate=0, aniso=0,
                           xfrac=0)
    G_inv = ta._geom_inv(draws, n, 1.0, cfg, 64, 64)
    assert 0.46 < (G_inv[:, 0, 0] < 0).float().mean().item() < 0.54
    cfg = ta.AugmentConfig(xflip=0, rotate90=0, xint=0, scale=0, aniso=0,
                           xfrac=0)
    G_inv = ta._geom_inv(draws, n, 0.5, cfg, 64, 64)
    assert 0.46 < (G_inv[:, 0, 1].abs() > 1e-7).float().mean().item() < 0.54
    cfg = ta.AugmentConfig(xflip=0, rotate90=0, scale=0, rotate=0, aniso=0,
                           xfrac=0)
    G_inv = ta._geom_inv(draws, n, 1.0, cfg, 64, 64)
    tx = G_inv[:, 0, 2]
    assert torch.equal(tx, torch.round(tx)) and tx.abs().max() <= 8


def test_adaptive_p_trajectory():
    """The controller's p over a run of signs, step for step."""
    signs = np.random.RandomState(6).uniform(-1, 1, 300)
    signs[:100] = 1.0
    want = ja.AdaptiveAugment(target=0.6, batch_size=64, kimg=1)
    got = ta.AdaptiveAugment(target=0.6, batch_size=64, kimg=1)
    traj = [(want.update(s), got.update(s)) for s in signs]
    assert [a for a, _ in traj] == [b for _, b in traj]
    assert max(a for a, _ in traj) > 0.5 and traj[-1][0] >= 0.0
