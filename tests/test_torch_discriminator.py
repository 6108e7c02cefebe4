"""The port's dual discriminator against tgi's (tgi/nn/discriminator.py),
and R1's double backward against tgi's ``dreg_loss`` (CPU, fp32)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_helpers import (close, jit_ref, leaves_with_paths,
                                 tiny_camera, with_tgi_draws)
from tgi.nn import discriminator as jd
from tgi_torch.nn import discriminator as td

TOL_OP = 1e-5
TOL_GRAD = 1e-4
# tests/test_gan.py's discriminator: 64², channel_base 512, channel_max 32.
D_KW = dict(c_dim=25, img_resolution=64, img_channels=6, channel_base=512,
            channel_max=32, mbstd_group_size=2, mapping_layers=2)


@pytest.fixture(scope="module")
def d_pair():
    cfg_t = td.DiscriminatorConfig(**D_KW)
    pt = td.discriminator_init(torch.Generator().manual_seed(0), cfg_t,
                               device="cpu")
    pj = jax.tree.map(lambda t: jnp.asarray(t.numpy()), pt)
    return jd.DiscriminatorConfig(**D_KW), pj, cfg_t, pt


def _inputs(N, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.randn(N, 3, 64, 64).astype(np.float32)
    raw = rng.randn(N, 3, 16, 16).astype(np.float32)
    c = np.concatenate([tiny_camera(0.3 * (i - 1)) for i in range(N)])
    return img, raw, c.astype(np.float32)


def test_init_matches_tgi_tree(d_pair):
    """Names, shapes and distributions of tgi's init (unit normal
    weights, the mapping's fc layers divided by their lr multiplier
    0.01, zero biases, no mapping w_avg)."""
    cfg_j, _, cfg_t, pt = d_pair
    want = jax.eval_shape(lambda k: jd.discriminator_init(k, cfg_j),
                          jax.random.PRNGKey(0))
    got = dict(leaves_with_paths(pt))
    want = {p: tuple(v.shape) for p, v in leaves_with_paths(want)}
    assert {p: tuple(t.shape) for p, t in got.items()} == want
    weights = torch.cat([
        t.flatten() * (0.01 if p[0] == "mapping" and p[1] != "embed" else 1)
        for p, t in got.items() if p[-1] == "weight"])
    assert abs(weights.mean().item()) < 0.01
    assert abs(weights.std().item() - 1) < 0.01
    assert all(not t.any() for p, t in got.items() if p[-1] == "bias"
               and p[0] != "mapping")


def test_logits_and_gradients(d_pair):
    """Logits [N, 1], and the gradient of a weighted sum of them with
    respect to every weight and to both images."""
    cfg_j, pj, cfg_t, pt = d_pair
    img, raw, c = _inputs(4)
    wts = np.asarray([[1.0], [-0.5], [0.25], [2.0]], np.float32)

    def f(p, im, rw):
        return (jd.dual_discriminator_apply(p, im, rw, jnp.asarray(c),
                                            cfg_j) * wts).sum()

    def logits(p, im, rw):
        return jd.dual_discriminator_apply(p, im, rw, jnp.asarray(c), cfg_j)

    want_logits = jit_ref(logits)(pj, img, raw)
    _, (gp, gi, gr) = jit_ref(jax.value_and_grad(f, argnums=(0, 1, 2)))(
        pj, img, raw)

    p = {k: v for k, v in jax.tree.map(lambda t: t, pt).items()}
    leaves = [t.requires_grad_(True) for _, t in leaves_with_paths(p)]
    ti = torch.from_numpy(img).requires_grad_(True)
    tr = torch.from_numpy(raw).requires_grad_(True)
    out = td.dual_discriminator_apply(p, ti, tr, torch.from_numpy(c), cfg_t)
    close(out, want_logits, TOL_OP)
    grads = torch.autograd.grad((out * torch.from_numpy(wts)).sum(),
                                leaves + [ti, tr])
    for (path, _), g in zip(leaves_with_paths(p), grads):
        close(g, dict(leaves_with_paths(gp))[path], TOL_GRAD)
    close(grads[-2], gi, TOL_GRAD)
    close(grads[-1], gr, TOL_GRAD)
    for t in leaves:
        t.requires_grad_(False)


@pytest.mark.parametrize("group", [2, 4])
def test_minibatch_std(group):
    x = np.random.RandomState(1).randn(4, 8, 5, 5).astype(np.float32)
    want = jd.minibatch_std(jnp.asarray(x), group_size=group)
    close(td.minibatch_std(torch.from_numpy(x), group_size=group), want,
          TOL_OP)


@pytest.mark.parametrize("mode", ["antialiased", "classic", "none", 0.3])
@pytest.mark.parametrize("sizes", [(16, 64), (64, 16), (16, 32), (40, 16)],
                         ids=["up4", "down4", "up2", "down2.5"])
def test_filtered_resizing(mode, sizes):
    """Every mode, enlarging (the raw render to the image) and shrinking
    (the augmented raw half back), at whole and fractional factors."""
    src, dst = sizes
    x = np.random.RandomState(2).randn(2, 3, src, src).astype(np.float32)
    want = jd.filtered_resizing(jnp.asarray(x), dst, mode)
    close(td.filtered_resizing(torch.from_numpy(x), dst, mode), want,
          TOL_OP)


def test_filtered_resizing_rejects_unknown():
    x = torch.zeros(1, 3, 8, 8)
    with pytest.raises(ValueError):
        td.filtered_resizing(x, 16, "bogus")
    with pytest.raises(ValueError):
        td.filtered_resizing(x, 16, 1.5)


def test_r1_double_backward(d_pair):
    """R1 (``dreg_loss``): the gradient of D's logits to the real image
    and raw image, through the whole augment pipe at p = 1 (tgi's own
    draws) and D, then differentiated again to D's weights — held
    against tgi's ``jax.value_and_grad(dreg_loss)``. tgi's ``_blur``
    cannot be traced with taps (it hands a traced filter to numpy), so
    the blur's double backward is checked in test_torch_gan.py."""
    from tgi.train import augment as ja
    from tgi.train.gan import GANTrainConfig as JCfg
    from tgi.train.gan import GANTrainer as JTrainer
    from tgi_torch.train import augment as ta
    from tgi_torch.train.gan import GANTrainConfig, GANTrainer

    cfg_j, pj, cfg_t, pt = d_pair
    img, raw, c = _inputs(2, seed=3)
    key = jax.random.PRNGKey(11)
    sigma, size, p = 0.0, 0, 1.0
    aug = dict(imgfilter=1.0, noise=1.0, cutout=1.0)
    jt = JTrainer(None, cfg_j, JCfg(r1_gamma=2.0),
                  augment_fn=ja.AugmentPipe(ja.AugmentConfig(**aug)))
    want, want_g = jit_ref(jax.value_and_grad(jt.dreg_loss),
                           static_argnums=(6,))(
        pj, img, raw, jnp.asarray(c), key, jnp.float32(sigma), size,
        jnp.float32(p))

    tt = GANTrainer(None, cfg_t, GANTrainConfig(r1_gamma=2.0),
                    augment_fn=ta.AugmentPipe(ta.AugmentConfig(**aug)))
    leaves = [t.requires_grad_(True) for _, t in leaves_with_paths(pt)]
    loss = with_tgi_draws(key, lambda d: tt.dreg_loss(
        pt, torch.from_numpy(img), torch.from_numpy(raw),
        torch.from_numpy(c), d, sigma, size, p))
    close(loss, want, TOL_GRAD)
    # The logits' last bias does not reach R1: jax's zero, autograd's None.
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    want_g = dict(leaves_with_paths(want_g))
    for (path, _), g in zip(leaves_with_paths(pt), grads):
        close(g, want_g[path], TOL_GRAD)
    assert float(loss.detach()) > 0
    assert max(g.abs().max().item() for g in grads) > 0
    for t in leaves:
        t.requires_grad_(False)


@pytest.mark.parametrize("up,down,taps", [(2, 1, 4), (1, 2, 4), (2, 2, 12)],
                         ids=["up-2d", "down-2d", "updown-separable"])
def test_fir_twice_differentiable(up, down, taps):
    """R1 differentiates the resampling filters twice (D's
    ``conv2d_resample``, the augment pipe's sym6 up and down): the
    filter's own double backward against finite differences."""
    from tgi_torch.ops.filters import setup_filter
    from tgi_torch.ops.upfirdn2d import upfirdn2d
    f = setup_filter(np.arange(1, taps + 1, dtype=np.float32))
    x = torch.randn(2, 3, 7, 6, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradgradcheck(
        lambda t: upfirdn2d(t, f, up=up, down=down, padding=[2, 1, 1, 3]),
        (x,))
