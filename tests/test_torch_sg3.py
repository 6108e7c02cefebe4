"""The alias-free (StyleGAN3) generator and its filtered leaky ReLU (the
port's ``nn/synthesis3.py`` and ``ops/filtered_lrelu.py``) against tgi's,
on the CPU, tgi's operators run eagerly and its tiny generator jitted.

The layer specs and filters are the same numpy and scipy: equal. The
filtered leaky ReLU agrees within 1e-5 of its output's largest magnitude
over up/down factors, paddings (negative ones crop), clamps and 1-D and
2-D filters. A tiny SG3Config's images (weights drawn by tgi's init,
carried to the port as arrays) agree within 1e-4 absolute: float32
through 7 modulated convolutions, each with a 12- or 24-tap up and down
FIR."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_helpers import TINY_SG3, sg3_pair
from tgi.nn import synthesis3 as j3
from tgi.ops.filtered_lrelu import filtered_lrelu as jflrelu
from tgi_torch.nn import synthesis3 as t3
from tgi_torch.ops.filtered_lrelu import filtered_lrelu

def test_lowpass_filters_match_tgi():
    for kw in (dict(numtaps=12, cutoff=2.0, width=2.0, fs=16),
               dict(numtaps=12, cutoff=2.0, width=2.0, fs=16, radial=True),
               dict(numtaps=24, cutoff=11.3, width=5.1, fs=64)):
        got, want = (t3.design_lowpass_filter(**kw),
                     j3.design_lowpass_filter(**kw))
        assert got.dtype == np.float32 and np.array_equal(got, want)
    assert t3.design_lowpass_filter(1, 2.0, 2.0, 16) is None


@pytest.mark.parametrize("cfg", [TINY_SG3, {}])
def test_layer_specs_match_tgi(cfg):
    """The tiny config's and tgi's default's (256², 14 layers)."""
    gi, gs = t3.SG3Config(**cfg).layer_specs()
    wi, ws = j3.SG3Config(**cfg).layer_specs()
    assert gi == wi and len(gs) == len(ws)
    for a, b in zip(gs, ws):
        assert dataclasses.astuple(a) == dataclasses.astuple(b)


@pytest.mark.parametrize("case", [
    dict(up=2, down=2, padding=[5, 6, 5, 6], clamp=256.0, res=10, f=(12, 12)),
    dict(up=2, down=1, padding=[3, 2, 4, 1], clamp=None, res=9, f=(12, 6)),
    dict(up=1, down=2, padding=[7, 8, 7, 8], clamp=0.5, res=12, f=(6, 12)),
    dict(up=1, down=1, padding=[-1, -2, 1, 0], clamp=None, res=8,
         f=(None, None), gain=1.0, slope=1.0),
    dict(up=2, down=2, padding=[5, 6, 5, 6], clamp=2.0, res=10,
         f=(12, "radial"))])
def test_filtered_lrelu_matches_tgi(case):
    case = dict(case)
    res, (nu, nd) = case.pop("res"), case.pop("f")
    rng = np.random.RandomState(res)
    x = rng.randn(2, 3, res, res).astype(np.float32) * 3
    b = rng.randn(3).astype(np.float32)

    def filt(n, up):
        if n is None:
            return None
        if n == "radial":
            return t3.design_lowpass_filter(12, 4.0, 3.0, 16, radial=True)
        return t3.design_lowpass_filter(n, 3.0 * up, 2.0, 8 * up)

    fu, fd = filt(nu, case["up"]), filt(nd, case["down"])
    got = filtered_lrelu(torch.from_numpy(x), fu, fd, torch.from_numpy(b),
                         **case)
    want = np.asarray(jflrelu(jnp.asarray(x), fu, fd, jnp.asarray(b),
                              **case))
    assert got.shape == want.shape
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


def test_params_tree_is_tgi_tree():
    """The port's init has tgi's keys and shapes (so weights cross by
    ``params_from_numpy``); traced, not run."""
    gj, _, gt, pt = sg3_pair()
    want = jax.eval_shape(gj.init, jax.random.PRNGKey(0))
    got = jax.tree.map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape),
                                                      jnp.float32), pt)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert all(a.shape == b.shape for a, b in zip(jax.tree.leaves(got),
                                                  jax.tree.leaves(want)))


def test_tiny_images_match_tgi():
    """Weights drawn by tgi's init (magnitude EMAs moved off 1) cross by
    ``params_from_numpy``; the images agree, and the input layer's
    transform (what EQ drives) moves them."""
    from tgi_torch.io.from_jax import params_from_numpy
    gj = j3.SG3Generator(j3.SG3Config(**TINY_SG3))
    gt = t3.SG3Generator(t3.SG3Config(**TINY_SG3))
    arrays = jax.tree.map(np.array, jax.jit(gj.init)(jax.random.PRNGKey(2)))
    for i in range(TINY_SG3["num_layers"] + 1):
        arrays["synthesis"][f"L{i}"]["magnitude_ema"] = np.float32(
            1.0 + 0.1 * i)
    pj = jax.tree.map(jnp.asarray, arrays)
    pt = params_from_numpy(arrays, device="cpu")
    z = np.random.RandomState(1).randn(2, 16).astype(np.float32)
    # tgi's forward jitted: a Python loop over layers, no scan, compiled
    # once in ~1 s where its eager ops take ~10.
    fwd = jax.jit(lambda p, x: gj(p, x, None, truncation_psi=0.8))
    want = np.asarray(fwd(pj, jnp.asarray(z)))
    got = gt(pt, torch.from_numpy(z), None, truncation_psi=0.8)
    assert got.shape == (2, 3, 32, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    m = np.eye(3, dtype=np.float32)
    m[0, 2] = 0.1
    moved = dict(pt["synthesis"]["input"], transform=torch.from_numpy(m))
    shifted = gt(pt | {"synthesis": pt["synthesis"] | {"input": moved}},
                 torch.from_numpy(z), None, truncation_psi=0.8)
    assert (shifted - got).abs().max() > 1e-2
