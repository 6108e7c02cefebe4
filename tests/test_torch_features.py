"""Feature statistics and the feature loops (the port's
``metrics/features.py``) against tgi's, on the CPU.

``FeatureStats`` is host numpy in float64 in both packages: the same
batches give the same bits, and a pickle that tgi saved loads in the
port. ``compute_generator_features`` renders the tiny generator pair
with tgi's z and c handed in; a 4 x 4 average pool of each image stands
in for the detector, and the features agree within 1e-4 absolute (the
tiny generator's images agree to that, tests/test_torch_generator.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_helpers import tiny_pair
from tgi.metrics import features as jf
from tgi_torch.metrics import features as tf

ATOL = 1e-4


def _batches(seed, sizes, f=16):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, f).astype(np.float32) for n in sizes]


@pytest.mark.parametrize("max_items", [None, 11])
def test_feature_stats_match_tgi(max_items):
    want = jf.FeatureStats(capture_all=True, capture_mean_cov=True,
                           max_items=max_items)
    got = tf.FeatureStats(capture_all=True, capture_mean_cov=True,
                          max_items=max_items)
    for i, b in enumerate(_batches(0, [4, 5, 3, 6])):
        want.append(b)
        got.append(torch.from_numpy(b) if i % 2 else b)
        assert got.is_full() == want.is_full()
    assert got.num_items == want.num_items
    assert np.array_equal(got.get_all(), want.get_all())
    for a, b in zip(got.get_mean_cov(), want.get_mean_cov()):
        assert a.dtype == np.float64 and np.array_equal(a, b)
    fresh = tf.FeatureStats(capture_all=True)
    fresh.append(np.zeros((2, 16), np.float32))
    with pytest.raises(ValueError, match="width"):
        fresh.append(np.zeros((2, 7), np.float32))


def test_pickle_from_tgi_loads(tmp_path):
    """A FeatureStats pickle written by tgi loads in the port, and the
    port's own round-trips."""
    want = jf.FeatureStats(capture_all=True, capture_mean_cov=True)
    for b in _batches(1, [3, 4]):
        want.append(b)
    path = str(tmp_path / "tgi.pkl")
    want.save(path)
    got = tf.FeatureStats.load(path)
    assert got.num_items == 7 and got.num_features == 16
    assert np.array_equal(got.get_all(), want.get_all())
    for a, b in zip(got.get_mean_cov(), want.get_mean_cov()):
        assert np.array_equal(a, b)
    got.save(str(tmp_path / "port.pkl"))
    again = jf.FeatureStats.load(str(tmp_path / "port.pkl"))
    assert np.array_equal(again.get_mean_cov()[1], want.get_mean_cov()[1])


class _Images:
    """A stand-in dataset: ``path``, ``len`` and ([3, H, W], label)."""

    def __init__(self, path, n):
        self.path = path
        rng = np.random.RandomState(2)
        self.imgs = rng.uniform(-1, 1, (n, 3, 8, 8)).astype(np.float32)

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, i):
        return self.imgs[i], np.zeros(25, np.float32)


def test_dataset_features_and_cache(tmp_path):
    ds = _Images(str(tmp_path / "data"), 10)

    def jfn(x):
        return x.mean(axis=(2, 3))

    def tfn(x):
        return x.mean(dim=(2, 3))

    want = jf.compute_dataset_features(ds, jfn, batch_size=4, max_items=9)
    calls = []

    def counted(x):
        calls.append(x.shape[0])
        return tfn(x)

    cache = str(tmp_path / "run")
    got = tf.compute_dataset_features(ds, counted, batch_size=4,
                                      max_items=9, cache_dir=cache,
                                      cache_tag="det-a")
    assert calls == [4, 4, 1] and got.num_items == 9
    np.testing.assert_allclose(got.get_all(), want.get_all(), rtol=0,
                               atol=1e-6)
    again = tf.compute_dataset_features(ds, counted, batch_size=4,
                                        max_items=9, cache_dir=cache,
                                        cache_tag="det-a")
    assert calls == [4, 4, 1]        # read from the cache
    assert np.array_equal(again.get_all(), got.get_all())
    tf.compute_dataset_features(ds, counted, batch_size=4, max_items=9,
                                cache_dir=cache, cache_tag="det-b")
    assert calls == [4, 4, 1] * 2    # another detector, another file


def test_generator_features_match_tgi():
    """Two batches of 3 tiny renders with tgi's draws, 5 items wanted:
    the second batch is cut to 2 rows by ``max_items``."""
    from tgi.apps.calc_metrics import default_camera_sampler as jsampler
    from tgi_torch.apps.calc_metrics import default_camera_sampler
    gj, pj, gt, pt = tiny_pair()
    key = jax.random.PRNGKey(5)

    def jfn(img):
        n = img.shape[0]
        return img.reshape(n, 3, 4, 16, 4, 16).mean(axis=(3, 5)).reshape(
            n, -1)

    def tfn(img):
        return torch.nn.functional.avg_pool2d(img, 16).reshape(
            img.shape[0], -1)

    want = jf.compute_generator_features(gj, pj, jfn, jsampler(gj),
                                         num_items=5, batch_size=3, key=key)
    draws = []
    for i in range(2):
        kz, kc = jax.random.split(jax.random.fold_in(key, i))
        draws.append((torch.from_numpy(np.array(
            jax.random.normal(kz, (3, 32)))),
            torch.from_numpy(np.array(jsampler(gj)(kc, 3)))))
    got = tf.compute_generator_features(
        gt, pt, tfn, default_camera_sampler(device="cpu"), num_items=5,
        batch_size=3, draws=draws)
    assert got.num_items == 5 and got.get_all().shape == (5, 48)
    np.testing.assert_allclose(got.get_all(), want.get_all(), rtol=0,
                               atol=ATOL)
    mu, cov = got.get_mean_cov()
    assert mu.dtype == np.float64 and np.isfinite(cov).all()

    # Its own draws: seeded, so two runs agree bit for bit.
    runs = [tf.compute_generator_features(
        gt, pt, tfn, default_camera_sampler(device="cpu"), num_items=4,
        batch_size=2, generator=torch.Generator().manual_seed(1)).get_all()
        for _ in range(2)]
    assert np.array_equal(*runs)


def test_camera_sampler_matches_tgi():
    """The port's sampler turns (yaw, pitch) draws into the cameras tgi's
    turns the same draws into."""
    from tgi.render.cameras import (fov_to_intrinsics, look_at_pose,
                                    pack_camera)
    from tgi_torch.apps.calc_metrics import default_camera_sampler
    gen = torch.Generator().manual_seed(4)
    got = default_camera_sampler(device="cpu")(gen, 5)
    gen = torch.Generator().manual_seed(4)
    yaw = np.pi / 2 + torch.randn(5, generator=gen).numpy() * 0.35
    pitch = np.pi / 2 + torch.randn(5, generator=gen).numpy() * 0.15
    want = pack_camera(look_at_pose(jnp.asarray(yaw), jnp.asarray(pitch),
                                    jnp.asarray([0, 0, 0.2]), radius=2.7),
                       fov_to_intrinsics(18.837))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
