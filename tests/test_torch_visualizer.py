"""The port's visualizer (``tgi_torch/apps/visualizer.py``) against
``tgi``'s ``VisualizerState`` on the tiny generator pair, on the CPU.

z crosses as a tensor: the port's state takes ``z_fn``, here tgi's draw
``jax.random.normal(PRNGKey(seed))`` (the port draws from torch's PRNG
otherwise). Every control is rendered by both: seed, yaw / pitch,
truncation and its cutoff, the render types (image, image_raw,
image_depth, planes), the depth multiplier 1 and 2, fov, the
conditioning pose, style mixing, the noise mode and the plane channel.
Frames within 1e-4 abs in [-1, 1] (the tiny generator's full render is
held to 1e-4 by tests/test_torch_generator.py). Then the HTTP round trip
on 127.0.0.1: the page, a PNG frame equal to the direct render's bytes,
the stats and a capture.
"""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax

from tests.torch_helpers import tiny_pair
from tgi.apps.visualizer import VisualizerState as JState
from tgi_torch.apps.visualizer import (VisualizerState, make_handler,
                                       render_kwargs)

CONTROLS = [
    dict(seed=0, mult=1),
    dict(seed=3, yaw=0.4, pitch=-0.2, mult=1),
    dict(seed=1, trunc=0.5, cutoff=3, mult=1),
    dict(seed=1, trunc=1.0, cutoff=0, rtype="image_raw", mult=1),
    dict(seed=0, rtype="image_depth", mult=1),
    dict(seed=0, rtype="planes", layerch=5, mult=1),
    dict(seed=0, fov=30.0, cyaw=0.5, cpitch=0.1, mult=1),
    dict(seed=0, mixseed=3, mixlayer=2, mult=1),
    dict(seed=0, noise="random", mult=1),
    dict(seed=2, yaw=-0.3),                      # mult 2 (the default)
]


def _tgi_z(seed, z_dim):
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(seed), (1, z_dim))))


@pytest.fixture(scope="module")
def states():
    gj, pj, gt, pt = tiny_pair()
    return JState(gj, pj), VisualizerState(gt, pt, z_fn=_tgi_z)


@pytest.mark.parametrize("kw", CONTROLS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_render_matches_tgi(states, kw):
    want, got = (s.render(**kw) for s in states)
    assert got.shape == want.shape and got.shape[0] == 3
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)


def test_controls_change_the_frame(states):
    """As tests/test_apps.py checks tgi's: mixing, fov and the
    conditioning pose move the frame; the plane cache serves a camera
    move; the stats count frames."""
    st = states[1]
    base = st.render(seed=0, mult=1)
    for kw in (dict(mixseed=3, mixlayer=1), dict(fov=30.0),
               dict(cyaw=0.5)):
        assert np.abs(st.render(seed=0, mult=1, **kw) - base).max() > 1e-4
    st.render(seed=0, mult=1)
    cached = st._plane_cache
    st.render(seed=0, yaw=0.3, mult=1)
    assert st._plane_cache is cached
    s = st.stats()
    assert s["frames"] >= 6 and s["avg_ms"] > 0 and s["fps"] > 0


def test_http_round_trip(states, tmp_path):
    from http.server import ThreadingHTTPServer

    from PIL import Image

    from tgi_torch.utils.image import to_uint8
    gt_state = states[1]
    st = VisualizerState(gt_state.G, gt_state.params,
                         capture_dir=str(tmp_path / "shots"), z_fn=_tgi_z)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(st))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        html = urllib.request.urlopen(base + "/").read().decode()
        assert "stylemix" in html and "cond yaw" in html
        query = "seed=1&mult=1&mixseed=2&mixlayer=1&rtype=image"
        png = urllib.request.urlopen(f"{base}/render?{query}").read()
        img = np.asarray(Image.open(io.BytesIO(png)))
        direct = st.render(**render_kwargs(
            {k: [v] for k, v in (p.split("=") for p in query.split("&"))}))
        assert np.array_equal(img, to_uint8(direct))
        # The depth at the rays' 16², a plane channel at the backbone's
        # 32².
        for rtype, size in (("image_depth", 16), ("planes", 32)):
            png = urllib.request.urlopen(
                f"{base}/render?seed=1&mult=2&rtype={rtype}").read()
            assert Image.open(io.BytesIO(png)).size == (size, size)
        stats = json.loads(urllib.request.urlopen(base + "/stats").read())
        assert stats["frames"] == 4 and stats["avg_ms"] > 0
        cap = json.loads(urllib.request.urlopen(
            f"{base}/capture?{query}").read())
        assert np.array_equal(np.asarray(Image.open(cap["path"])),
                              to_uint8(direct))
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nothing")
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)
    assert not t.is_alive()
