"""The self-inversion gate's generator is drawn from seed by the port's
own init (``TriPlaneGenerator.init``): on the CPU, at the tiny config,
each leaf against the distribution of tgi's ``G.init``, so the port's
gate inverts the kind of generator tgi's gate inverts. A constant leaf
must be that constant; a random one has its mean within 5 standard
errors and its standard deviation within 5 of its own standard errors
(both leaves drawn once, from fixed seeds)."""

import numpy as np
import torch

import jax

from tgi.models import GeneratorConfig as JGeneratorConfig
from tgi.models import TriPlaneGenerator as JTriPlaneGenerator
from tgi.models import default_rendering_kwargs as jrk
from tgi_torch.models.generator import (GeneratorConfig, TriPlaneGenerator,
                                        default_rendering_kwargs)

from torch_helpers import TINY, TINY_RK, jit_ref, leaves_with_paths


def test_seeded_generator_draws_tgi_distributions():
    want = jit_ref(JTriPlaneGenerator(JGeneratorConfig(
        rendering_kwargs=jrk(**TINY_RK), **TINY)).init)(
            jax.random.PRNGKey(3))
    got = dict(leaves_with_paths(TriPlaneGenerator(GeneratorConfig(
        rendering_kwargs=default_rendering_kwargs(**TINY_RK), **TINY)).init(
            torch.Generator().manual_seed(3), device="cpu")))
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(got)
    for path, w in flat:
        w = np.asarray(w, np.float64).ravel()
        g = got[tuple(k.key for k in path)].double().numpy().ravel()
        assert g.shape == w.shape, path
        if w.min() == w.max():
            assert (g == w[0]).all(), path
            continue
        n, sd = w.size, w.std()
        assert abs(g.mean() - w.mean()) <= 5 * sd / np.sqrt(n), path
        assert abs(g.std() - sd) <= 5 * sd / np.sqrt(2 * n), path
