"""tgi_torch's losses and AlexNet-LPIPS against tgi's, on the CPU.

Same inputs from a numpy seed, tgi's random-init AlexNet and LPIPS head
carried over as arrays. Tolerances: 1e-6 relative for the elementwise
losses and resizes (the same fp32 formula, means summed in another
order); 1e-5 relative for LPIPS (five fp32 convolutions, channel norms).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tgi.invert.coach import compute_tv_norm as jcompute_tv_norm
from tgi.losses import basic as jbasic
from tgi.losses import warp as jwarp
from tgi.losses.lpips import AlexLPIPSLoss as JAlexLPIPSLoss
from tgi.models import alexnet as jalex
from tgi_torch.invert.coach import compute_tv_norm
from tgi_torch.io.from_jax import params_from_numpy
from tgi_torch.losses import basic, warp
from tgi_torch.losses.lpips import AlexLPIPSLoss, LPIPSLoss, make_lpips
from tgi_torch.models import alexnet

from torch_helpers import close


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(a)


def test_l2_loss():
    a, b = _rand(0, 2, 3, 8, 8), _rand(1, 2, 3, 8, 8)
    close(basic.l2_loss(_t(a), _t(b)), jbasic.l2_loss(a, b), 1e-6)


@pytest.mark.parametrize("shape", [(1, 1, 16, 16), (2, 1, 9, 13)])
def test_depth_tv_loss(shape):
    d = _rand(2, *shape)
    close(basic.depth_tv_loss(_t(d)), jbasic.depth_tv_loss(d), 1e-6)


def test_compute_tv_norm():
    d = _rand(3, 1, 16, 16)
    close(compute_tv_norm(_t(d)), jcompute_tv_norm(d), 1e-6)


@pytest.mark.parametrize("as_dict", [False, True])
def test_noise_regularization(as_dict):
    maps = [_rand(4, 32, 32), _rand(5, 8, 8), _rand(6, 16, 16)]
    if as_dict:
        maps = {f"n{i}": m for i, m in enumerate(maps)}
        port = {k: _t(v) for k, v in maps.items()}
    else:
        port = [_t(m) for m in maps]
    close(basic.noise_regularization(port),
          jbasic.noise_regularization(maps), 1e-6)


def test_normalize_noise():
    n = _rand(7, 16, 16) * 3 + 1
    close(basic.normalize_noise(_t(n)), jbasic.normalize_noise(n), 1e-6)


@pytest.mark.parametrize("size,out", [(64, 16), (512, 128), (32, 32)])
def test_area_downsample(size, out):
    x = _rand(8, 1, 3, size, size)
    close(warp.area_downsample(_t(x), out), jwarp.area_downsample(x, out),
          1e-6)


@pytest.mark.parametrize("size,out", [(16, 128), (64, 128), (5, 12),
                                      (32, 32)])
def test_bilinear_resize_upsampling(size, out):
    x = _rand(9, 1, 3, size, size)
    close(warp.bilinear_resize_nchw(_t(x), out),
          jwarp.bilinear_resize_nchw(jnp.asarray(x), out), 1e-6)


def test_bilinear_resize_refuses_a_shrink():
    """A shrink, which the port refused before it had jax's antialiased
    kernel, now matches ``jax.image.resize`` (more shapes and the
    gradient: ``test_torch_warp.py``)."""
    x = _rand(10, 1, 3, 64, 64)
    close(warp.bilinear_resize_nchw(_t(x), 32),
          jwarp.bilinear_resize_nchw(jnp.asarray(x), 32), 1e-6)


@pytest.fixture(scope="module")
def alex():
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    trunk = jax.tree.map(np.asarray, jalex.alexnet_init(k1))
    head = jax.tree.map(np.asarray, jalex.alex_head_init(k2))
    return trunk, head


@pytest.mark.parametrize("size", [64, 128])
def test_alex_lpips_distance(alex, size):
    trunk, head = alex
    a = np.tanh(_rand(10, 2, 3, size, size))
    b = np.tanh(_rand(11, 2, 3, size, size))
    want = jax.jit(jalex.alex_lpips_distance)(trunk, head, a, b)
    got = alexnet.alex_lpips_distance(params_from_numpy(trunk, "cpu"),
                                      params_from_numpy(head, "cpu"),
                                      _t(a), _t(b))
    assert got.shape == (2,)
    close(got, want, 1e-5)


def test_alex_lpips_loss_call_forms(alex):
    trunk, head = alex
    a = np.tanh(_rand(12, 1, 3, 64, 64))
    b = np.tanh(_rand(13, 1, 3, 64, 64))
    jl = JAlexLPIPSLoss(trunk, head)
    tl = AlexLPIPSLoss(params_from_numpy(trunk, "cpu"),
                       params_from_numpy(head, "cpu"))
    close(tl.from_unit(_t(a), _t(b)), jl.from_unit(a, b), 1e-5)
    a255, b255 = (a + 1) * 127.5, (b + 1) * 127.5
    close(tl(_t(a255), _t(b255)), jl(a255, b255), 1e-5)
    close(tl.features(_t(a255)), jl.features(a255), 1e-5)


def test_stage_features_pool_is_valid(alex):
    """The VALID 3x3/2 max-pools: stage shapes at a 64² input."""
    trunk, _ = alex
    acts = alexnet.alexnet_stage_features(params_from_numpy(trunk, "cpu"),
                                          torch.zeros(1, 3, 64, 64))
    assert [tuple(a.shape[1:]) for a in acts] == [
        (64, 15, 15), (192, 7, 7), (384, 3, 3), (256, 3, 3), (256, 3, 3)]


def test_own_init_matches_tgi_shapes():
    trunk = alexnet.alexnet_init(torch.Generator().manual_seed(0), "cpu")
    head = alexnet.alex_head_init(torch.Generator().manual_seed(0), "cpu")
    jt = jalex.alexnet_init(jax.random.PRNGKey(0))
    jh = jalex.alex_head_init(jax.random.PRNGKey(0))
    assert (jax.tree.map(lambda t: tuple(t.shape), trunk)
            == jax.tree.map(lambda t: tuple(t.shape), jt))
    assert (jax.tree.map(lambda t: tuple(t.shape), head)
            == jax.tree.map(lambda t: tuple(t.shape), jh))
    assert all((v["weight"] >= 0).all() for v in head.values())


@pytest.mark.parametrize("form", ["lpips", "lins", "torchvision"])
def test_convert_lpips_alex(form):
    """A synthetic state dict in each of the three layouts converts to
    the same arrays as tgi's converter gives."""
    rng = np.random.RandomState(14)
    sd = {}
    for idx, (cin, cout, k, _, _) in jalex.ALEXNET_CONVS.items():
        w = rng.randn(cout, cin, k, k).astype(np.float32)
        b = rng.randn(cout).astype(np.float32)
        if form == "torchvision":
            sd[f"features.{idx}.weight"], sd[f"features.{idx}.bias"] = w, b
        else:
            stage = next(i for i, s in enumerate(jalex.ALEX_STAGES) if idx < s)
            sd[f"net.slice{stage + 1}.{idx}.weight"] = w
            sd[f"net.slice{stage + 1}.{idx}.bias"] = b
    if form != "torchvision":
        for i, c in enumerate(jalex.ALEX_CHANNELS):
            name = (f"lin{i}.model.1.weight" if form == "lpips"
                    else f"lins.{i}.model.1.weight")
            sd[name] = np.abs(rng.randn(1, c, 1, 1)).astype(np.float32)
    sd["scaling_layer.shift"] = np.zeros((1, 3, 1, 1), np.float32)
    want_t, want_h = jalex.convert_lpips_alex(sd)
    got_t, got_h = alexnet.convert_lpips_alex(
        {k: torch.from_numpy(v) for k, v in sd.items()})
    for want, got in ((want_t, got_t), (want_h, got_h)):
        assert jax.tree.structure(want) == jax.tree.structure(got)
        assert jax.tree.all(jax.tree.map(
            np.array_equal, jax.tree.map(np.asarray, want), got))
    assert len(got_t["features"]) == 5
    assert len(got_h) == (0 if form == "torchvision" else 5)


def test_make_lpips():
    assert isinstance(make_lpips("alex", device="cpu"), AlexLPIPSLoss)
    assert isinstance(make_lpips("vgg", device="cpu"), LPIPSLoss)
    with pytest.raises(ValueError):
        make_lpips("squeeze", device="cpu")
