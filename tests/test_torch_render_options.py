"""The render and generator options tgi_torch took over from tgi —
``gaussian_camera_pose`` / ``uniform_camera_pose``, ``density_noise >
0``, ``superresolution_noise_mode="random"``, ``fused_dtype="float16"``
and ``unify_samples`` — against tgi's, on the CPU at the tiny config
(plane C = 8, 32² backbone, 16² rays, 8 + 8 samples, SuperresolutionTiny).

Randomness crosses as tensors: the port runs on tgi's own draws from the
same key (``torch_helpers.with_tgi_draws``, which gives one tensor for
one draw). tgi draws both passes' density noise from one key
(``tgi/render/renderer.py:105``, :123), so with 8 + 8 samples the two
passes get the same normals: the port is handed that one tensor, and the
renders agree within 1e-5. tgi's renders run in one jitted call.

float16 is held as bf16 is in ``test_torch_bf16.py``, with D =
‖tgi_fp16 − tgi_fp32‖∞: a block within 2⁻⁷ · max|ref|, the generator's
outputs within 2 · D and 5e-2 · max|ref| of tgi's float16, and at least
0.25 · D from the port's float32 (float16 really runs).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tgi.models import TriPlaneGenerator as JTriPlaneGenerator
from tgi.nn import synthesis as jsynthesis
from tgi.render import cameras as jcameras
from tgi.render import importance as jimportance
from tgi_torch.models.generator import GeneratorConfig, TriPlaneGenerator
from tgi_torch.nn import synthesis
from tgi_torch.nn.superres import sr_random_noise
from tgi_torch.render import cameras, importance
import tgi_torch.render.renderer as renderer
from tgi_torch.utils.draws import TorchDraws

from torch_helpers import (TINY_GAN, TINY_D, close, gan_inputs, jit_ref,
                           tiny_camera, tiny_pair, with_tgi_draws)

TOL = 1e-5
ULP2 = 2.0 ** -7
KEY = jax.random.PRNGKey(21)
OPTIONS = dict(density_noise=1.0, superresolution_noise_mode="random")


def _with(g, cls, rk=None, **kw):
    """A generator of class ``cls`` with ``g``'s config changed."""
    if rk:
        kw["rendering_kwargs"] = {**g.cfg.rendering_kwargs, **rk}
    return cls(dataclasses.replace(g.cfg, **kw))


@pytest.fixture(scope="module")
def setup():
    gj, pj, gt, pt = tiny_pair()
    rng = np.random.RandomState(5)
    z = rng.randn(1, 32).astype(np.float32)
    c = tiny_camera(0.3)
    x = rng.randn(1, 32, 8, 8).astype(np.float32)
    img = rng.randn(1, 24, 8, 8).astype(np.float32)
    ws = rng.randn(1, 3, 32).astype(np.float32)
    variants = {
        "options": _with(gj, JTriPlaneGenerator, OPTIONS),
        "noise_4": _with(gj, JTriPlaneGenerator, dict(
            density_noise=0.5, depth_resolution_importance=4)),
        "float16": _with(gj, JTriPlaneGenerator, fused_dtype="float16"),
        "float32": gj}

    from tgi.nn.discriminator import DiscriminatorConfig as JD
    from tgi.train.gan import GANTrainConfig as JCfg
    from tgi.train.gan import GANTrainer as JTrainer
    trainer = JTrainer(variants["options"], JD(**TINY_D), JCfg(**TINY_GAN))
    zb, cb, _ = gan_inputs()

    def run(p, z, c, x, img, ws, key):
        out = {name: g(p, z, c, truncation_psi=0.7, key=key,
                       det=name not in ("options", "noise_4"))
               for name, g in variants.items()}
        out["trainer"] = trainer._run_G(p, zb, cb, key, 0.5, 16)[0]
        for dtype in ("float16", "float32"):
            out[f"block_{dtype}"] = jsynthesis.synthesis_block_apply(
                p["backbone"]["b16"], x, img, ws, in_channels=32,
                resolution=16, up=2, conv_clamp=256,
                use_fp16=dtype == "float16", fused_dtype="float16")
        return out

    want = jax.tree.map(np.asarray, jit_ref(run)(pj, z, c, x, img, ws, KEY))
    t = (torch.from_numpy(a) for a in (z, c, x, img, ws))
    return dict(gt=gt, pt=pt, want=want, **dict(zip(
        ("z", "c", "x", "img", "ws"), t)))


def _render(G, s, draws=None, **kw):
    """The port's render at tgi's key tree: ``draws`` splits as
    ``synthesis`` (backbone, render, SR) and the render key as
    ``importance_render`` (stratified, importance, density noise)."""
    rk, res = G.cfg.rendering_kwargs, G.cfg.neural_rendering_resolution
    ws = G.mapping(s["pt"], s["z"], s["c"], truncation_psi=0.7)
    if draws is None:
        return G.synthesis(s["pt"], ws, s["c"], det=True, **kw)
    _, k_render, k_sr = draws.split(3)
    k_strat, k_imp, k_noise = k_render.split(3)
    M, S, Si = res * res, rk["depth_resolution"], rk[
        "depth_resolution_importance"]
    noise = (k_noise.normal((1, M * S, 1)), k_noise.normal((1, M * Si, 1)))
    sr = (sr_random_noise(G.cfg.sr_cfg, 1, k_sr)
          if rk["superresolution_noise_mode"] == "random" else None)
    kw = dict(dict(jitter=k_strat.uniform((1, M, S, 1)),
                   u=k_imp.uniform((M, Si)), sigma_noise=noise,
                   sr_noise=sr), **kw)
    return G.synthesis(s["pt"], ws, s["c"], det=False, **kw)


def _outputs_close(got, want, tol=TOL):
    for k in ("image", "image_raw", "image_depth"):
        close(got[k], want[k], tol)


@pytest.mark.parametrize("sampler", ["gaussian", "uniform"])
def test_camera_samplers_equal_tgi(sampler):
    """4 poses at yaw/pitch spreads 0.3 / 0.15 on tgi's draws, within
    1e-6; a CPU generator's poses look at the origin from the radius."""
    port = getattr(cameras, f"{sampler}_camera_pose")
    ref = getattr(jcameras, f"{sampler}_camera_pose")
    args = (math.pi / 2, math.pi / 2, 0.3, 0.15, 2.7, 4)
    got = with_tgi_draws(KEY, lambda d: port(d, *args, device="cpu"))
    want = np.asarray(ref(KEY, *args))
    assert got.shape == (4, 4, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    own = port(torch.Generator().manual_seed(0), *args, device="cpu")
    origin = own[:, :3, 3]
    close(origin.norm(dim=-1), np.full(4, 2.7, np.float32), 1e-6)
    close(own[:, :3, 2], (-origin / 2.7).numpy(), 1e-6)
    assert (own[0] - own[1]).abs().max() > 1e-3


def test_density_and_sr_noise_render_equals_tgi(setup):
    """``density_noise=1`` and random SR noise together, det=False, every
    draw tgi's: within 1e-5 of tgi's render. The coarse and fine passes
    get one and the same normals (8 = 8 samples), as in tgi; each option
    moves the image."""
    G = _with(setup["gt"], TriPlaneGenerator, OPTIONS)
    seen = []
    real = renderer.run_model

    def spy(*args, sigma_noise=None, **kw):
        seen.append(sigma_noise)
        return real(*args, sigma_noise=sigma_noise, **kw)

    renderer.run_model = spy
    try:
        got = with_tgi_draws(KEY, lambda d: _render(G, setup, d))
    finally:
        renderer.run_model = real
    _outputs_close(got, setup["want"]["options"])
    # with_tgi_draws runs the render twice: stand-ins, then tgi's draws.
    assert len(seen) == 4 and seen[2] is seen[3]
    zeros = torch.zeros_like(seen[0])
    for off in (dict(sigma_noise=(zeros, zeros)),
                dict(sr_noise=sr_random_noise(G.cfg.sr_cfg, 1, _Zeros()))):
        other = with_tgi_draws(KEY, lambda d: _render(G, setup, d, **off))
        assert (other["image"] - got["image"]).abs().max() > 1e-3


class _Zeros:
    """A draw source of zeros."""

    def split(self, n):
        return [self] * n

    def normal(self, shape):
        return torch.zeros(shape)


def test_trainer_render_with_options_equals_tgi(setup):
    """The G phase's render (``GANTrainer._run_G``: random backbone noise,
    the pose swap, style mixing) under both options, on tgi's draws."""
    from tgi_torch.nn.discriminator import DiscriminatorConfig
    from tgi_torch.train.gan import GANTrainConfig, GANTrainer
    G = _with(setup["gt"], TriPlaneGenerator, OPTIONS)
    trainer = GANTrainer(G, DiscriminatorConfig(**TINY_D),
                         GANTrainConfig(**TINY_GAN))
    z, c, _ = (torch.from_numpy(a) for a in gan_inputs())
    with torch.no_grad():
        got = with_tgi_draws(KEY, lambda d: trainer._run_G(
            setup["pt"], z, c, d, 0.5, 16)[0])
    for k in ("image", "image_raw", "image_depth"):
        close(got[k], setup["want"]["trainer"][k], 1e-4)


def test_density_noise_of_two_shapes_equals_tgi(setup):
    """8 + 4 samples: tgi draws the two passes' normals from one key at
    two shapes; given both, the port's render is tgi's."""
    G = _with(setup["gt"], TriPlaneGenerator, dict(
        density_noise=0.5, depth_resolution_importance=4))
    got = with_tgi_draws(KEY, lambda d: _render(G, setup, d))
    _outputs_close(got, setup["want"]["noise_4"])


def test_density_noise_draws():
    """Drawn, one normal is shared by passes of the same shape; a render
    without a generator takes fixed draws on its own device (tgi's
    ``PRNGKey(0)``); a draw source gives the normals in call order;
    ``run_model`` refuses ``density_noise > 0`` without its draw."""
    a, b = renderer.density_noise_draws((1, 6, 1), (1, 6, 1),
                                        torch.Generator(), device="cpu")
    assert a is b
    a, b = renderer.density_noise_draws((1, 6, 1), (1, 3, 1), device="cpu")
    a2, b2 = renderer.density_noise_draws((1, 6, 1), (1, 3, 1),
                                          device="cpu")
    assert b.shape == (1, 3, 1) and torch.equal(a, a2) and torch.equal(b, b2)
    assert a.device.type == "cpu"
    c, f = renderer.density_noise_draws(
        (1, 6, 1), (1, 3, 1), TorchDraws(torch.Generator().manual_seed(5)))
    g = torch.Generator().manual_seed(5)
    assert torch.equal(c, torch.randn((1, 6, 1), generator=g))
    assert torch.equal(f, torch.randn((1, 3, 1), generator=g))
    _, _, gt, pt = tiny_pair()
    with pytest.raises(ValueError, match="sigma_noise"):
        renderer.run_model(torch.zeros(1, 3, 8, 4, 4), pt["decoder"],
                           torch.zeros(1, 5, 3), dict(
                               gt.cfg.rendering_kwargs, density_noise=1.0))


def test_sr_random_noise_needs_its_draws(setup):
    """Random SR noise with neither ``sr_noise`` nor a generator keeps
    the synthesis layer's refusal; with a generator it renders, and a
    seed repeats."""
    G = _with(setup["gt"], TriPlaneGenerator, dict(
        superresolution_noise_mode="random"))
    with pytest.raises(ValueError, match="needs the layer's noise"):
        _render(G, setup)
    a, b = (_render(G, setup, generator=torch.Generator().manual_seed(1))
            for _ in range(2))
    assert torch.equal(a["image"], b["image"])


def test_unify_samples_equals_tgi():
    """Coarse and fine sets with tied depths, sorted stably: tgi's bits."""
    rng = np.random.RandomState(3)
    d1 = np.sort(rng.rand(2, 5, 6, 1), axis=2).astype(np.float32)
    d2 = np.sort(rng.rand(2, 5, 4, 1), axis=2).astype(np.float32)
    d2[:, :, 1] = d1[:, :, 2]
    c1, c2 = (rng.randn(2, 5, n, 7).astype(np.float32) for n in (6, 4))
    s1, s2 = (rng.randn(2, 5, n, 1).astype(np.float32) for n in (6, 4))
    args = (d1, c1, s1, d2, c2, s2)
    got = importance.unify_samples(*(torch.from_numpy(a) for a in args))
    want = jimportance.unify_samples(*(jnp.asarray(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool((got[0].diff(dim=2) >= 0).all())


def test_float16_block_and_generator_match_tgi(setup):
    """A backbone block (b16: conv0 up 2, conv1, torgb) in float16 within
    two bf16 ulps of tgi's float16, and the float16 generator within the
    generator bounds (see the module docstring)."""
    want = setup["want"]
    got_x, got_img = synthesis.synthesis_block_apply(
        setup["pt"]["backbone"]["b16"], setup["x"], setup["img"],
        setup["ws"], in_channels=32, up=2, conv_clamp=256,
        dtype=torch.float16)
    assert got_x.dtype == torch.float16 and got_img.dtype == torch.float32
    for got, w, ref in ((got_x, want["block_float16"][0],
                         want["block_float32"][0]),
                        (got_img, want["block_float16"][1],
                         want["block_float32"][1])):
        err = np.abs(got.float().numpy() - w.astype(np.float32)).max()
        assert err <= ULP2 * np.abs(ref).max(), err

    G16 = _with(setup["gt"], TriPlaneGenerator, fused_dtype="float16")
    assert G16.cfg.fused_dtype == "float16"
    got16, got32 = _render(G16, setup), _render(setup["gt"], setup)
    for k in ("image", "image_raw", "image_depth", "planes"):
        g16, g32 = got16[k].numpy(), got32[k].numpy()
        w16, ref = want["float16"][k], want["float32"][k]
        assert got16[k].dtype == torch.float32
        D = np.abs(w16 - ref).max()
        err = np.abs(g16 - w16).max()
        assert D > 0 and err <= 2 * D, (k, err, D)
        assert err <= 5e-2 * np.abs(ref).max(), (k, err)
        assert np.abs(g16 - g32).max() >= 0.25 * D, k
    with pytest.raises(ValueError, match="plane_dtype"):
        GeneratorConfig(plane_dtype="float16")
