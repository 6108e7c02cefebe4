"""tgi_torch render pieces against tgi's, on the CPU.

Random draws cross as tensors: the stratified jitter and the importance
``u`` are made with numpy and given to both packages. Tolerances: 1e-5
abs for each function (fp32, the same formulas); 1e-4 abs for the full
two-pass render, where rounding differences pass through two decoder
passes, a sort and two composites.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tgi.render import cameras as jcameras
from tgi.render import importance as jimp
from tgi.render import maths as jmaths
from tgi.render import march as jmarch
from tgi.render import rays as jrays
from tgi.render.decoder import osg_decoder_apply as josg_apply
from tgi.render.decoder import osg_decoder_init as josg_init
from tgi.render.renderer import importance_render as jimportance_render
from tgi_torch.io.from_jax import params_from_numpy
from tgi_torch.render import cameras, importance, maths, march, rays
from tgi_torch.render.decoder import osg_decoder_apply
from tgi_torch.render.renderer import importance_render

ATOL = 1e-5


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def _t(a):
    return torch.tensor(np.asarray(a))


def _cams(yaws, pitch=np.pi / 2, radius=2.7, fov=18.837):
    """Packed cameras [N, 25] from tgi (the reference conditioning)."""
    intr = jcameras.fov_to_intrinsics(fov)
    c2w = jnp.stack([jcameras.look_at_pose(np.pi / 2 + y, pitch,
                                           jnp.asarray([0., 0., 0.2]),
                                           radius=radius) for y in yaws])
    return np.asarray(jcameras.pack_camera(c2w, intr))


@pytest.mark.parametrize("yaw,pitch,radius", [(0.0, np.pi / 2, 2.7),
                                              (0.5, 1.2, 2.7),
                                              (-1.0, 2.0, 1.5)])
def test_cameras_match_tgi(yaw, pitch, radius):
    piv = [0., 0., 0.2]
    want = jcameras.look_at_pose(np.pi / 2 + yaw, pitch, jnp.asarray(piv),
                                 radius=radius)
    got = cameras.look_at_pose(np.pi / 2 + yaw, pitch, torch.tensor(piv),
                               radius=radius, device="cpu")
    _close(got, want)
    _close(cameras.fov_to_intrinsics(18.837, device="cpu"),
           jcameras.fov_to_intrinsics(18.837))
    _close(cameras.pack_camera(got[None],
                               cameras.fov_to_intrinsics(18.837, "cpu")),
           jcameras.pack_camera(want[None], jcameras.fov_to_intrinsics(18.837)))


@pytest.mark.parametrize("res", [4, 16])
def test_ray_sampler_matches_tgi(res):
    c = _cams([0.0, 0.7])
    c2w, intr = c[:, :16].reshape(-1, 4, 4), c[:, 16:].reshape(-1, 3, 3)
    wo, wd = jrays.ray_sampler(jnp.asarray(c2w), jnp.asarray(intr), res)
    go, gd = rays.ray_sampler(_t(c2w), _t(intr), res)
    _close(go, wo)
    _close(gd, wd)


def test_get_ray_limits_box_matches_tgi_including_misses():
    rng = np.random.RandomState(0)
    o = (rng.randn(2, 64, 3) * 1.5).astype(np.float32)
    d = rng.randn(2, 64, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    wmin, wmax = jmaths.get_ray_limits_box(jnp.asarray(o), jnp.asarray(d), 1.0)
    gmin, gmax = maths.get_ray_limits_box(_t(o), _t(d), 1.0)
    assert (np.asarray(wmin) == -1).any() and (np.asarray(wmin) > 0).any()
    _close(gmin, wmin)
    _close(gmax, wmax)


@pytest.mark.parametrize("start_kind", ["scalar", "tensor", "disparity"])
@pytest.mark.parametrize("det", [True, False])
def test_sample_stratified_matches_tgi(start_kind, det):
    rng = np.random.RandomState(1)
    N, M, D = 2, 10, 8
    o = rng.randn(N, M, 3).astype(np.float32)
    jitter = rng.rand(N, M, D, 1).astype(np.float32)
    if start_kind == "tensor":
        s = (2.0 + rng.rand(N, M, 1)).astype(np.float32)
        e = s + 0.5 + rng.rand(N, M, 1).astype(np.float32)
        js, je, ts, te = jnp.asarray(s), jnp.asarray(e), _t(s), _t(e)
    else:
        js = ts = 2.25
        je = te = 3.3
    disp = start_kind == "disparity"
    # tgi draws its jitter from a key; hand the same numbers to both by
    # substituting jax.random.uniform for this call.
    orig = jax.random.uniform
    jax.random.uniform = lambda key, shape, *a, **k: jnp.asarray(
        jitter).reshape(shape)
    try:
        want = jimp.sample_stratified(jax.random.PRNGKey(0), jnp.asarray(o),
                                      js, je, D, disp, det=det)
    finally:
        jax.random.uniform = orig
    got = importance.sample_stratified(_t(o), ts, te, D, disp, det=det,
                                       jitter=_t(jitter))
    _close(got, want)


def _pdf_inputs(seed, R=12, B=7, NI=9):
    rng = np.random.RandomState(seed)
    bins = np.sort(2.0 + rng.rand(R, B + 1), axis=-1).astype(np.float32)
    weights = (0.1 + rng.rand(R, B)).astype(np.float32)
    weights[0] = 0.0                       # all-zero row: eps-only pdf
    weights[1, 2:5] = 0.0                  # empty bins -> flat CDF steps
    u = rng.rand(R, NI).astype(np.float32)
    return bins, weights, u


def _exact_cdf_inputs(seed, R=6, B=7):
    """Weights whose CDF is exact in fp32 whatever the summation order:
    integer multiples of 2**20 summing to 2**24 (the eps added to each
    weight is below their rounding), with empty bins for flat steps. Both
    packages then hold bit-identical CDFs, so u can sit exactly on them."""
    rng = np.random.RandomState(seed)
    bins = np.sort(2.0 + rng.rand(R, B + 1), axis=-1).astype(np.float32)
    k = np.zeros((R, B), np.int64)
    for r in range(R):
        nz = np.sort(rng.choice(B, size=rng.randint(1, B + 1), replace=False))
        cuts = np.sort(rng.choice(np.arange(1, 16), size=len(nz) - 1,
                                  replace=False))
        k[r, nz] = np.diff(np.concatenate([[0], cuts, [16]]))
    weights = (k * 2.0 ** 20).astype(np.float32)
    cdf = np.concatenate([np.zeros((R, 1)), np.cumsum(k, -1) / 16.0], -1)
    return bins, weights, cdf.astype(np.float32)


def _jax_sample_pdf_with_u(bins, weights, u):
    """tgi's stochastic sample_pdf, its uniform draw replaced by ``u``."""
    orig = jax.random.uniform
    jax.random.uniform = lambda key, shape, *a, **k: jnp.asarray(u)
    try:
        return jimp.sample_pdf(jax.random.PRNGKey(0), jnp.asarray(bins),
                               jnp.asarray(weights), u.shape[1])
    finally:
        jax.random.uniform = orig


def test_sample_pdf_matches_tgi_with_injected_u():
    """Generic weights (the division by a CDF step amplifies cumsum
    rounding, so weights stay >= 0.1 to keep that below the tolerance)."""
    bins, weights, u = _pdf_inputs(2)
    want = jimp.sample_pdf(None, jnp.asarray(bins), jnp.asarray(weights),
                           u.shape[1], det=True)
    got = importance.sample_pdf(_t(bins), _t(weights), u.shape[1], det=True)
    _close(got, want)
    want = _jax_sample_pdf_with_u(bins, weights, u)
    got = importance.sample_pdf(_t(bins), _t(weights), u.shape[1], u=_t(u))
    _close(got, want)


@pytest.mark.parametrize("seed", [3, 4])
def test_sample_pdf_matches_tgi_with_u_on_cdf_values(seed):
    """u exactly on CDF values — ties of searchsorted(right=True),
    including 0, 1 and the edges of flat steps — and random u."""
    bins, weights, cdf = _exact_cdf_inputs(seed)
    rng = np.random.RandomState(seed)
    u = np.concatenate([cdf, rng.rand(*cdf.shape)], -1).astype(np.float32)
    want = _jax_sample_pdf_with_u(bins, weights, u)
    got = importance.sample_pdf(_t(bins), _t(weights), u.shape[1], u=_t(u))
    _close(got, want)


def test_sample_importance_matches_tgi():
    rng = np.random.RandomState(4)
    N, M, S = 1, 6, 8
    z = np.sort(2.25 + rng.rand(N, M, S, 1), axis=2).astype(np.float32)
    w = rng.rand(N, M, S - 1, 1).astype(np.float32)
    want = jimp.sample_importance(None, jnp.asarray(z), jnp.asarray(w), 8,
                                  det=True)
    got = importance.sample_importance(_t(z), _t(w), 8, det=True)
    _close(got, want)


def _march_inputs(seed, tie):
    rng = np.random.RandomState(seed)
    N, M, S = 2, 5, 6
    d1 = np.sort(2.25 + rng.rand(N, M, S, 1), axis=2).astype(np.float32)
    d2 = np.sort(2.25 + rng.rand(N, M, S, 1), axis=2).astype(np.float32)
    if tie:
        d2[:, :, ::2] = d1[:, :, 1::2]          # coarse and fine depths tie
        d2 = np.sort(d2, axis=2)
    c1, c2 = (rng.rand(N, M, S, 4).astype(np.float32) for _ in range(2))
    s1, s2 = (rng.randn(N, M, S, 1).astype(np.float32) * 3 for _ in range(2))
    return d1, c1, s1, d2, c2, s2


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("white_back", [False, True])
def test_merged_march_matches_tgi(tie, white_back):
    args = _march_inputs(5, tie)
    want = jimp.merged_march(*map(jnp.asarray, args), white_back=white_back)
    got = importance.merged_march(*map(_t, args), white_back=white_back)
    for g, w in zip(got, want):
        _close(g, w)


def test_mip_ray_marcher_matches_tgi():
    d, c, s, _, _, _ = _march_inputs(6, False)
    want = jmarch.mip_ray_marcher(jnp.asarray(c), jnp.asarray(s),
                                  jnp.asarray(d))
    got = march.mip_ray_marcher(_t(c), _t(s), _t(d))
    for g, w in zip(got, want):
        _close(g, w)


def _render_setup(C=8, res=8, seed=7):
    rng = np.random.RandomState(seed)
    planes = rng.randn(1, 3, C, 16, 16).astype(np.float32)
    dec = jax.tree.map(np.asarray, josg_init(jax.random.PRNGKey(seed), C,
                                             output_dim=C))
    return planes, dec


def test_osg_decoder_matches_tgi():
    rng = np.random.RandomState(8)
    _, dec = _render_setup()
    feats = rng.randn(1, 3, 20, 8).astype(np.float32)
    want = josg_apply(jax.tree.map(jnp.asarray, dec), jnp.asarray(feats))
    got = osg_decoder_apply(params_from_numpy(dec, "cpu"), _t(feats))
    _close(got["rgb"], want["rgb"])
    _close(got["sigma"], want["sigma"])


@pytest.mark.parametrize("yaw,fov,auto", [
    (0.0, 18.837, False),
    (0.6, 18.837, False),
    (0.3, 18.837, True),
    (0.3, 40.0, True),      # corner rays miss the box: invalid-ray fill-in
    (0.3, 40.0, False),     # fixed depth range: points outside the box
])
def test_importance_render_matches_tgi(yaw, fov, auto):
    from tgi_torch.models.generator import default_rendering_kwargs
    planes, dec = _render_setup()
    opts = default_rendering_kwargs(depth_resolution=8,
                                    depth_resolution_importance=8)
    if auto:
        opts.update(ray_start="auto", ray_end="auto")
    c = _cams([yaw], fov=fov)
    c2w, intr = c[:, :16].reshape(-1, 4, 4), c[:, 16:].reshape(-1, 3, 3)
    o, d = jrays.ray_sampler(jnp.asarray(c2w), jnp.asarray(intr), 8)
    smin, smax = jmaths.get_ray_limits_box(o, d, 1.0)
    assert bool(jnp.any(smax > smin))
    assert bool(jnp.any(smax <= smin)) == (fov > 30)
    render = jax.jit(lambda p, dp, o, d: jimportance_render(
        p, dp, o, d, opts, det=True))
    want = render(jnp.asarray(planes), jax.tree.map(jnp.asarray, dec), o, d)
    got = importance_render(_t(planes), params_from_numpy(dec, "cpu"),
                            _t(o), _t(d), opts, det=True)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, atol=1e-4)


def test_stochastic_draw_needs_a_source():
    o = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError, match="Generator"):
        importance.sample_stratified(o, 2.25, 3.3, 8, det=False)
    g = torch.Generator().manual_seed(0)
    a = importance.sample_stratified(o, 2.25, 3.3, 8, det=False, generator=g)
    assert a.shape == (1, 4, 8, 1) and (a >= 2.25).all()
