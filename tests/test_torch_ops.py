"""tgi_torch resampling, activation and layer ops against tgi's, on the CPU.

Same inputs (numpy, seeded) through both packages; fp32 convolutions that
sum in another order, so the tolerance is 1e-5 abs (values are O(1)).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tgi.nn import layers as jlayers
from tgi.ops.bias_act import bias_act as jbias_act
from tgi.ops.conv2d_resample import conv2d_resample as jconv2d_resample
from tgi.ops.filters import setup_filter as jsetup_filter
from tgi.ops.upfirdn2d import downsample2d as jdownsample2d
from tgi.ops.upfirdn2d import filter2d as jfilter2d
from tgi.ops.upfirdn2d import upfirdn2d as jupfirdn2d
from tgi.ops.upfirdn2d import upsample2d as jupsample2d
from tgi_torch.nn import layers
from tgi_torch.ops.bias_act import activation_funcs, bias_act
from tgi_torch.ops.conv2d_resample import conv2d_resample
from tgi_torch.ops.filters import setup_filter
from tgi_torch.ops.fma import fma
from tgi_torch.ops.upfirdn2d import (downsample2d, filter2d, upfirdn2d,
                                     upsample2d)

ATOL = 1e-5


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_setup_filter_is_tgis():
    for f, kw in (([1, 3, 3, 1], {}), ([1, 2, 3, 4, 4, 3, 2, 1], {}),
                  ([[1, 2], [3, 4]], dict(flip_filter=True, gain=4))):
        np.testing.assert_array_equal(setup_filter(f, **kw),
                                      jsetup_filter(f, **kw))


@pytest.mark.parametrize("f,up,down,padding,flip,gain", [
    ([1, 3, 3, 1], 1, 1, 0, False, 1.0),
    ([1, 3, 3, 1], 2, 1, [2, 1], False, 4.0),
    ([1, 3, 3, 1], 1, 2, [1, 1, 1, 1], False, 1.0),
    ([1, 3, 3, 1], 2, 2, [1, 2, 0, 3], True, 1.0),
    ([[1, 2, 0], [0, 3, 1]], 1, 1, [1, 1, 0, 1], True, 2.0),
    ([[1, 2, 0], [0, 3, 1]], (2, 1), (1, 2), [0, 1, 2, 0], False, 1.0),
    ([1, 3, 3, 1], 1, 1, [-1, 2, 3, -1], False, 1.0),
    ([1, 2, 3, 4, 4, 3, 2, 1], 2, 1, [4, 3], False, 1.0),  # separable
    (None, 3, 1, 0, False, 1.0),
])
def test_upfirdn2d_matches_tgi(f, up, down, padding, flip, gain):
    x = _x((2, 3, 9, 8))
    f = setup_filter(f) if f is not None else None
    want = jupfirdn2d(jnp.asarray(x), f, up=up, down=down,
                      padding=padding, flip_filter=flip, gain=gain)
    got = upfirdn2d(torch.from_numpy(x), f, up=up, down=down,
                    padding=padding, flip_filter=flip, gain=gain)
    _close(got, want)


@pytest.mark.parametrize("name", ["filter2d", "upsample2d", "downsample2d"])
def test_resample_helpers_match_tgi(name):
    x = _x((1, 4, 8, 8), 1)
    f = setup_filter([1, 3, 3, 1])
    jfn, fn = {"filter2d": (jfilter2d, filter2d),
               "upsample2d": (jupsample2d, upsample2d),
               "downsample2d": (jdownsample2d, downsample2d)}[name]
    _close(fn(torch.from_numpy(x), f), jfn(jnp.asarray(x), f))


@pytest.mark.parametrize("act", sorted(activation_funcs))
@pytest.mark.parametrize("with_bias", [False, True])
def test_bias_act_matches_tgi(act, with_bias):
    x = _x((2, 5, 3, 4), 2) * 3
    b = _x((5,), 3) if with_bias else None
    want = jbias_act(jnp.asarray(x), None if b is None else jnp.asarray(b),
                     act=act)
    got = bias_act(torch.from_numpy(x),
                   None if b is None else torch.from_numpy(b), act=act)
    _close(got, want)


@pytest.mark.parametrize("kw", [dict(act="lrelu", gain=0.5, clamp=1.3),
                                dict(act="linear", clamp=0.7, dim=2),
                                dict(act="lrelu", alpha=0.1, gain=3.0)])
def test_bias_act_gain_clamp_match_tgi(kw):
    x = _x((2, 4, 6), 4) * 3
    dim = kw.get("dim", 1)
    b = _x((x.shape[dim],), 5)
    want = jbias_act(jnp.asarray(x), jnp.asarray(b), **kw)
    got = bias_act(torch.from_numpy(x), torch.from_numpy(b), **kw)
    _close(got, want)


@pytest.mark.parametrize("kh,up,down,groups,flip_weight,padding", [
    (3, 1, 1, 1, True, 1),
    (3, 2, 1, 1, False, 1),
    (3, 1, 2, 1, True, 1),
    (3, 2, 1, 2, False, 1),
    (3, 1, 2, 2, True, 1),
    (1, 2, 1, 1, True, 0),
    (1, 1, 2, 1, True, 0),
    (3, 2, 2, 1, False, 1),
    (3, 1, 1, 1, True, [0, 2, 1, 1]),
])
def test_conv2d_resample_matches_tgi(kh, up, down, groups, flip_weight,
                                     padding):
    x = _x((2, 4, 8, 8), 6)
    w = _x((6, 4 // groups, kh, kh), 7) * 0.3
    f = setup_filter([1, 3, 3, 1]) if (up > 1 or down > 1) else None
    kw = dict(f=f, up=up, down=down, padding=padding, groups=groups,
              flip_weight=flip_weight)
    want = jconv2d_resample(jnp.asarray(x), jnp.asarray(w), **kw)
    got = conv2d_resample(torch.from_numpy(x), torch.from_numpy(w), **kw)
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("up,demodulate,noise", [(1, True, False),
                                                 (2, True, True),
                                                 (1, False, False)])
def test_modulated_conv2d_matches_tgi(up, demodulate, noise):
    x = _x((2, 4, 8, 8), 8)
    w = _x((5, 4, 3, 3), 9)
    s = _x((2, 4), 10) + 1
    n = _x((8 * up, 8 * up), 11) if noise else None
    f = setup_filter([1, 3, 3, 1]) if up > 1 else None
    kw = dict(up=up, padding=1, resample_filter=f, demodulate=demodulate,
              flip_weight=(up == 1))
    want = jlayers.modulated_conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
        noise=None if n is None else jnp.asarray(n), **kw)
    got = layers.modulated_conv2d(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s),
        noise=None if n is None else torch.from_numpy(n), **kw)
    _close(got, want)


@pytest.mark.parametrize("activation,lr", [("linear", 1.0), ("lrelu", 0.01)])
def test_fully_connected_matches_tgi(activation, lr):
    p = {"weight": _x((6, 5), 12), "bias": _x((6,), 13)}
    x = _x((3, 5), 14)
    want = jlayers.fully_connected_apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        activation=activation, lr_multiplier=lr)
    got = layers.fully_connected_apply(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        activation=activation, lr_multiplier=lr)
    _close(got, want)


@pytest.mark.parametrize("up,down", [(1, 1), (2, 1), (1, 2)])
def test_conv2d_layer_matches_tgi(up, down):
    p = {"weight": _x((6, 4, 3, 3), 15), "bias": _x((6,), 16)}
    x = _x((2, 4, 8, 8), 17)
    kw = dict(activation="lrelu", up=up, down=down, conv_clamp=0.8)
    want = jlayers.conv2d_layer_apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), **kw)
    got = layers.conv2d_layer_apply(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        **kw)
    _close(got, want)


def test_normalize_2nd_moment_and_fma_match_tgi():
    x = _x((3, 7), 18)
    _close(layers.normalize_2nd_moment(torch.from_numpy(x)),
           jlayers.normalize_2nd_moment(jnp.asarray(x)))
    a, b, c = _x((3, 1), 19), _x((1, 7), 20), _x((3, 7), 21)
    _close(fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)),
           jnp.asarray(a) * jnp.asarray(b) + jnp.asarray(c))
