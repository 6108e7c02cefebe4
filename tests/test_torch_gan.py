"""The port's GAN trainer's parts against tgi's (tgi/train/gan.py), on
the CPU in fp32: the schedules, the blur, ``noise_mode="random"``, and
each of the four phases' loss and gradient with tgi's draws given as
tensors (one jitted tgi computation for the file). No augment pipe here
(test_torch_discriminator.py holds R1 through it; test_torch_augment.py
the pipe): it would add half again to the compile."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_helpers import (close, gan_inputs, gan_pair, jit_ref,
                                 leaves_with_paths, with_tgi_draws)

TOL_OP = 1e-5
TOL = 1e-4          # losses and gradients, relative to the largest value
CUR_NIMG = 1000
ADA_P = 0.3


@pytest.fixture(scope="module")
def ref():
    """tgi's four phases at one state (losses, gradients, the G phase's
    render) and the port's, with tgi's draws."""
    jt, pj, dj, tt, pt, dt = gan_pair()
    z, c, real = gan_inputs()
    key = jax.random.PRNGKey(3)
    _, sp, res, _ = jt._schedules(CUR_NIMG)

    def phases(g, d, z, c, real, key):
        from tgi.nn.discriminator import filtered_resizing
        k_g, k_greg, k_d, k_dreg = jax.random.split(key, 4)
        real_raw = filtered_resizing(real, res)
        ada = jnp.float32(ADA_P)
        spf = jnp.float32(sp)
        g_loss, g_grads = jax.value_and_grad(jt.gmain_loss)(
            g, d, z, c, k_g, 0.0, 0, spf, res, ada)
        greg, greg_grads = jax.value_and_grad(jt.greg_loss)(
            g, z, c, k_greg, spf)
        (d_loss, signs), d_grads = jax.value_and_grad(
            jt.dmain_loss, has_aux=True)(d, g, z, c, real, real_raw, k_d,
                                         0.0, 0, spf, res, ada)
        dreg, dreg_grads = jax.value_and_grad(jt.dreg_loss)(
            d, real, real_raw, c, k_dreg, 0.0, 0, ada)
        out, ws = jt._run_G(g, z, c, jax.random.split(k_g)[0], spf, res)
        return dict(g_loss=g_loss, g_grads=g_grads, greg=greg,
                    greg_grads=greg_grads, d_loss=d_loss, signs=signs,
                    d_grads=d_grads, dreg=dreg, dreg_grads=dreg_grads,
                    image=out["image"], image_raw=out["image_raw"], ws=ws)

    want = jit_ref(phases)(pj, dj, z, c, real, key)
    got = with_tgi_draws(key, lambda draws: _port_phases(
        tt, pt, dt, torch.from_numpy(z), torch.from_numpy(c),
        torch.from_numpy(real), draws, sp, res))
    return dict(want=want, got=got)


def _port_phases(tt, g, d, z, c, real, draws, sp, res):
    """The port's four phases at one state (the same splits of one key as
    ``phases`` above), their losses and gradients, and the G phase's
    render."""
    from tgi_torch.nn.discriminator import filtered_resizing
    from tgi_torch.train.gan import _grads, _map
    k_g, k_greg, k_d, k_dreg = draws.split(4)
    g = _map(lambda t: t.clone().requires_grad_(True), g)
    d = _map(lambda t: t.clone().requires_grad_(True), d)
    d_frozen = _map(torch.Tensor.detach, d)
    real_raw = filtered_resizing(real, res)
    out = {}
    out["g_loss"] = tt.gmain_loss(g, d_frozen, z, c, k_g, 0.0, 0, sp, res,
                                  ADA_P)
    out["g_grads"] = _grads(out["g_loss"], g)
    out["greg"] = tt.greg_loss(g, z, c, k_greg, sp)
    out["greg_grads"] = _grads(out["greg"], g)
    out["d_loss"], out["signs"] = tt.dmain_loss(d, g, z, c, real, real_raw,
                                                k_d, 0.0, 0, sp, res, ADA_P)
    out["d_grads"] = _grads(out["d_loss"], d)
    out["dreg"] = tt.dreg_loss(d, real, real_raw, c, k_dreg, 0.0, 0, ADA_P)
    out["dreg_grads"] = _grads(out["dreg"], d)
    with torch.no_grad():
        render, out["ws"] = tt._run_G(g, z, c, k_g.split(2)[0], sp, res)
    out["image"], out["image_raw"] = render["image"], render["image_raw"]
    out["g"], out["d"] = g, d
    return out


def _close_tree(got_list, params, want_tree, tol=TOL):
    want = dict(leaves_with_paths(want_tree))
    for (path, _), g in zip(leaves_with_paths(params), got_list):
        close(g, want[path], tol)


def _with_grad(tree):
    return [t.requires_grad_(True) for _, t in leaves_with_paths(tree)]


def test_schedules():
    """Blur sigma, swap probability, neural resolution and EMA beta over
    a grid of cur_nimg, with and without the resolution fade and the
    EMA rampup."""
    from tgi.train.gan import GANTrainConfig as JCfg
    from tgi.train.gan import GANTrainer as JTrainer
    from tgi_torch.train.gan import GANTrainConfig, GANTrainer
    for kw in ({}, dict(neural_rendering_resolution_final=128,
                        ema_rampup=None, gpc_reg_prob=None),
               dict(blur_fade_kimg=0, gpc_reg_fade_kimg=0)):
        jt = JTrainer(None, None, JCfg(**kw))
        tt = GANTrainer(None, None, GANTrainConfig(**kw))
        for n in (0, 4, 1000, 123_456, 200_000, 999_996, 5_000_000):
            assert tt._schedules(n) == jt._schedules(n), (kw, n)
    assert tt.g_adam == jt.cfg.lazy_adjusted(jt.cfg.g_lr, 4)
    assert tt.d_adam == jt.cfg.lazy_adjusted(jt.cfg.d_lr, 16)


@pytest.mark.parametrize("sigma", [1.5, 10.0])
def test_blur(sigma):
    """``_blur`` (eager on tgi's side: its taps cannot be traced)."""
    from tgi.train.gan import _blur as jblur
    from tgi_torch.train.gan import _blur
    x = np.random.RandomState(4).randn(2, 3, 64, 64).astype(np.float32)
    size = int(np.floor(sigma * 3))
    close(_blur(torch.from_numpy(x), sigma, size),
          jblur(jnp.asarray(x), jnp.float32(sigma), size), TOL_OP)


def test_blur_twice_differentiable():
    """R1 differentiates through the blur twice: autograd's double
    backward of the separable FIR against finite differences."""
    from tgi_torch.train.gan import _blur
    x = torch.randn(1, 2, 9, 9, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradgradcheck(lambda t: _blur(t, 1.2, 3), (x,))


def test_random_noise_render(ref):
    """``noise_mode="random"`` in the G phase's render: tgi's per-layer
    noise given as tensors (noise strengths 0.3), the image and the raw
    image, and the ws after the pose swap and style mixing."""
    got, want = ref["got"], ref["want"]
    close(got["ws"], want["ws"], TOL_OP)
    close(got["image_raw"], want["image_raw"], TOL)
    close(got["image"], want["image"], TOL)


def test_random_noise_changes_the_image():
    """The noise is drawn per call: two draws give two images."""
    from tgi_torch.utils.draws import TorchDraws
    _, _, _, tt, pt, _ = gan_pair()
    z, c, _ = gan_inputs()
    with torch.no_grad():
        a, b = (tt._run_G(pt, torch.from_numpy(z), torch.from_numpy(c),
                          TorchDraws(torch.Generator().manual_seed(s)),
                          None, 16)[0]["image"] for s in (0, 1))
    assert (a - b).abs().max() > 1e-3


def test_gmain(ref):
    """Gmain's loss and gradient to every G weight (the backbone's noise
    strengths included: the random noise's gradient)."""
    got, want = ref["got"], ref["want"]
    close(got["g_loss"], want["g_loss"], TOL)
    _close_tree(got["g_grads"], got["g"], want["g_grads"])
    strengths = [g for (p, _), g in zip(leaves_with_paths(got["g"]),
                                        got["g_grads"])
                 if p[0] == "backbone" and p[-1] == "noise_strength"]
    assert len(strengths) > 0 and all(s.abs() > 0 for s in strengths)


def test_greg(ref):
    """The density regulariser (one scalar pose swap, uniform points and
    their N(0, 0.004) twins through ``sample_mixed``)."""
    got, want = ref["got"], ref["want"]
    close(got["greg"], want["greg"], TOL)
    _close_tree(got["greg_grads"], got["g"], want["greg_grads"])


def test_dmain(ref):
    """Dmain: the fakes re-rendered without autograd, fakes and reals
    through separate draws; loss, signs_real and D's gradient."""
    got, want = ref["got"], ref["want"]
    close(got["d_loss"], want["d_loss"], TOL)
    assert float(got["signs"]) == float(want["signs"])
    _close_tree(got["d_grads"], got["d"], want["d_grads"])


def test_dreg(ref):
    """R1 in the step: the penalty and its gradient to D's weights (the
    double backward)."""
    got, want = ref["got"], ref["want"]
    close(got["dreg"], want["dreg"], TOL)
    _close_tree(got["dreg_grads"], got["d"], want["dreg_grads"])
