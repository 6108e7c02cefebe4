"""Feature statistics for GAN metrics (twin of ``tgi/metrics/features.py``).

Behavioral parity target: metrics/metric_utils.py:25-281 — FeatureStats
(capture_all / running mean+cov), dataset and generator feature loops with
caching. The features come off the device each batch; the statistics are
host numpy in float64, as in ``tgi``, and a pickle that ``tgi`` saved
loads here (the same ``__dict__`` of numpy arrays and Python values).
"""

from __future__ import annotations

import hashlib
import os
import pickle

import numpy as np
import torch


class FeatureStats:
    """Accumulates raw features and/or mean+covariance
    (metric_utils.py:73-150)."""

    def __init__(self, capture_all=False, capture_mean_cov=False,
                 max_items=None):
        self.capture_all = capture_all
        self.capture_mean_cov = capture_mean_cov
        self.max_items = max_items
        self.num_items = 0
        self.num_features = None
        self.all_features = []
        self.raw_mean = None
        self.raw_cov = None

    def set_num_features(self, n):
        if self.num_features is None:
            self.num_features = n
            self.raw_mean = np.zeros(n, np.float64)
            self.raw_cov = np.zeros((n, n), np.float64)
        elif self.num_features != n:
            raise ValueError(f"features of width {n}, expected "
                             f"{self.num_features}")

    def is_full(self):
        return self.max_items is not None and self.num_items >= self.max_items

    def append(self, x):
        """Add a [N, F] batch (numpy or a tensor on any device)."""
        if isinstance(x, torch.Tensor):
            x = x.detach().float().cpu().numpy()
        x = np.asarray(x, np.float32)
        if x.ndim != 2:
            raise ValueError(f"features must be [N, F], got {x.shape}")
        if self.max_items is not None:
            if self.num_items >= self.max_items:
                return
            x = x[:self.max_items - self.num_items]
        self.set_num_features(x.shape[1])
        self.num_items += x.shape[0]
        if self.capture_all:
            self.all_features.append(x)
        if self.capture_mean_cov:
            x64 = x.astype(np.float64)
            self.raw_mean += x64.sum(axis=0)
            self.raw_cov += x64.T @ x64

    def get_all(self):
        assert self.capture_all
        return np.concatenate(self.all_features, axis=0)

    def get_mean_cov(self):
        assert self.capture_mean_cov
        mean = self.raw_mean / self.num_items
        cov = self.raw_cov / self.num_items - np.outer(mean, mean)
        return mean, cov

    def save(self, path):
        with open(path, "wb") as f:
            pickle.dump(self.__dict__, f)

    @classmethod
    def load(cls, path):
        """A file written by :meth:`save` (here or by ``tgi``): a pickled
        dict of numpy arrays and Python values, which this program or
        ``tgi`` wrote (unpickling runs what the file names)."""
        obj = cls()
        with open(path, "rb") as f:
            obj.__dict__.update(pickle.load(f))
        return obj


def compute_dataset_features(dataset, feature_fn, *, batch_size=16,
                             max_items=None, cache_dir=None, cache_tag="",
                             device=None):
    """Features for every dataset image, with pickle caching
    (metric_utils.py:198-232). ``feature_fn`` takes a [B, 3, H, W] float
    tensor in [-1, 1] on ``device`` (the CPU when absent)."""
    if cache_dir:
        tag = hashlib.md5(
            f"{dataset.path}|{len(dataset)}|{cache_tag}".encode()
        ).hexdigest()[:16]
        cache = os.path.join(cache_dir, f"feats-{tag}.pkl")
        if os.path.exists(cache):
            return FeatureStats.load(cache)
    stats = FeatureStats(capture_all=True, capture_mean_cov=True,
                         max_items=max_items)
    n = min(len(dataset), max_items or len(dataset))
    with torch.no_grad():
        for i in range(0, n, batch_size):
            imgs = np.stack([dataset[j][0] for j in
                             range(i, min(i + batch_size, n))])
            stats.append(feature_fn(torch.from_numpy(imgs).to(
                device or "cpu")))
            if stats.is_full():
                break
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        stats.save(cache)
    return stats


def generator_draws(G, camera_sampler, generator, batch_size, device):
    """One batch's (z, c) from ``generator`` (a CPU torch.Generator): z on
    ``device``, c as ``camera_sampler(generator, n)`` gives it."""
    z = torch.randn((batch_size, G.cfg.z_dim), generator=generator)
    return z.to(device), camera_sampler(generator, batch_size)


def compute_generator_features(G, params, feature_fn, camera_sampler, *,
                               num_items, batch_size=8, generator=None,
                               truncation_psi=1.0, draws=None):
    """Features of generated samples (metric_utils.py:236-281): batches of
    ``G(params, z, c, det=True)["image"]`` on the params' device.

    Batch ``i``'s (z, c) is ``draws[i]`` where given (e.g. ``tgi``'s), or
    else drawn from ``generator`` (a CPU torch.Generator, seed 0 when
    absent) by :func:`generator_draws`."""
    device = params["mapping"]["w_avg"].device
    generator = generator or torch.Generator().manual_seed(0)
    stats = FeatureStats(capture_all=True, capture_mean_cov=True,
                         max_items=num_items)
    i = 0
    with torch.no_grad():
        while not stats.is_full():
            z, c = (draws[i] if draws is not None else
                    generator_draws(G, camera_sampler, generator, batch_size,
                                    device))
            img = G(params, z, c, truncation_psi=truncation_psi,
                    det=True)["image"]
            stats.append(feature_fn(img))
            i += 1
    return stats
