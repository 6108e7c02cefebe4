"""FID / KID / precision-recall / IS / PPL and the metric registry (twin
of ``tgi/metrics/gan_metrics.py``).

Behavioral parity targets:
  frechet_inception_distance.py:22-41   (FID)
  kernel_inception_distance.py          (KID, poly kernel MMD)
  precision_recall.py                   (k-NN manifold precision/recall)
  inception_score.py                    (IS)
  perceptual_path_length.py             (PPL, w-space)
  metric_main.py:31-155                 (registry + harness + jsonl)

The distances are host numpy in float64 (``scipy.linalg.sqrtm`` for
FID), as in ``tgi``: the same features give the same numbers. Only PPL
runs on the device: two syntheses per segment through the generator
(the gather kernel on a card) and LPIPS. ``scipy`` is imported inside
:func:`frechet_distance`.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

_metric_registry = {}


def register_metric(fn):
    _metric_registry[fn.__name__] = fn
    return fn


def list_metrics():
    return sorted(_metric_registry)


def calc_metric(metric, **kwargs):
    """Harness with timing (metric_main.py:44-70)."""
    if metric not in _metric_registry:
        raise ValueError(f"unknown metric {metric!r} "
                         f"(known: {', '.join(list_metrics())})")
    t0 = time.time()
    results = _metric_registry[metric](**kwargs)
    return {
        "results": results,
        "metric": metric,
        "total_time": time.time() - t0,
    }


def report_metric(result, run_dir=None, snapshot=None):
    """jsonl reporting (metric_main.py:72-85)."""
    record = {**result, "snapshot": snapshot, "timestamp": time.time()}
    print(json.dumps(record))
    if run_dir:
        path = os.path.join(run_dir, f"metric-{result['metric']}.jsonl")
        with open(path, "a") as f:
            f.write(json.dumps(record) + "\n")
    return record


# ---------------------------------------------------------------------------
# Distances


def frechet_distance(mu1, sigma1, mu2, sigma2):
    """FID between two Gaussians (frechet_inception_distance.py:33-39)."""
    import scipy.linalg
    m = np.square(mu1 - mu2).sum()
    s = scipy.linalg.sqrtm(np.dot(sigma1, sigma2))
    return float(np.real(m + np.trace(sigma1 + sigma2 - s * 2)))


def kid_from_features(real, gen, num_subsets=100, max_subset_size=1000):
    """Polynomial-kernel MMD (kernel_inception_distance.py); subsets drawn
    by ``np.random.RandomState(0)``."""
    n = real.shape[1]
    m = min(min(real.shape[0], gen.shape[0]), max_subset_size)
    t = 0.0
    rng = np.random.RandomState(0)
    for _ in range(num_subsets):
        x = gen[rng.choice(gen.shape[0], m, replace=False)]
        y = real[rng.choice(real.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.trace(a)) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m)


def knn_precision_recall(real, gen, nhood_size=3, row_batch=1000):
    """Improved-precision-and-recall manifold test (precision_recall.py)."""
    def pairwise_sq(a, b):
        return (np.square(a).sum(1)[:, None] + np.square(b).sum(1)[None]
                - 2 * a @ b.T)

    def radii(feats):
        r = np.zeros(len(feats), np.float32)
        for i in range(0, len(feats), row_batch):
            d = pairwise_sq(feats[i:i + row_batch], feats)
            r[i:i + row_batch] = np.sort(d, axis=1)[:, nhood_size]
        return r

    def fraction_in_manifold(query, ref, ref_radii):
        hits = np.zeros(len(query), bool)
        for i in range(0, len(query), row_batch):
            d = pairwise_sq(query[i:i + row_batch], ref)
            hits[i:i + row_batch] = (d <= ref_radii[None]).any(axis=1)
        return float(hits.mean())

    precision = fraction_in_manifold(gen, real, radii(real))
    recall = fraction_in_manifold(real, gen, radii(gen))
    return precision, recall


def inception_score(probs, num_splits=10):
    """IS from [N, classes] class probabilities (inception_score.py)."""
    n = probs.shape[0]
    scores = []
    for i in range(num_splits):
        part = probs[i * n // num_splits:(i + 1) * n // num_splits]
        kl = part * (np.log(part + 1e-10)
                     - np.log(part.mean(axis=0, keepdims=True) + 1e-10))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def ppl_draws(G, camera_sampler, generator, batch, device):
    """One PPL segment's draws (z0, z1, c, t) from ``generator`` (a CPU
    torch.Generator), on ``device``."""
    z0 = torch.randn((batch, G.cfg.z_dim), generator=generator)
    z1 = torch.randn((batch, G.cfg.z_dim), generator=generator)
    c = camera_sampler(generator, batch)
    t = torch.rand((batch, 1, 1), generator=generator)
    return z0.to(device), z1.to(device), c, t.to(device)


def ppl_wend(G, params, lpips_loss, camera_sampler, *, num_samples=1000,
             epsilon=1e-4, batch=4, generator=None, draws=None):
    """Perceptual path length, w-space endpoints
    (perceptual_path_length.py).

    Each segment's (z0, z1, c, t) comes from ``draws`` (a sequence, one
    tuple per segment, e.g. ``tgi``'s draws) or else from ``generator``
    (a CPU torch.Generator, seed 0 when absent); ``camera_sampler(gen,
    n)`` returns packed cameras on the params' device."""
    device = params["mapping"]["w_avg"].device
    generator = generator or torch.Generator().manual_seed(0)
    vals = []
    with torch.no_grad():
        for i in range(num_samples // batch):
            z0, z1, c, t = (draws[i] if draws is not None else
                            ppl_draws(G, camera_sampler, generator, batch,
                                      device))
            w0 = G.mapping(params, z0, c)
            w1 = G.mapping(params, z1, c)
            wt0 = w0 + (w1 - w0) * t
            wt1 = w0 + (w1 - w0) * (t + epsilon)
            img0 = G.synthesis(params, wt0, c, det=True)["image"]
            img1 = G.synthesis(params, wt1, c, det=True)["image"]
            d = lpips_loss.from_unit(img0, img1) / (epsilon ** 2)
            vals.append(d.float().cpu().numpy())
    dist = np.concatenate(vals)
    lo, hi = np.percentile(dist, [1, 99])
    return float(dist[(dist >= lo) & (dist <= hi)].mean())


# ---------------------------------------------------------------------------
# Registered metrics (metric_main.py:88-153 equivalents)


@register_metric
def fid(real_stats=None, gen_stats=None, **_):
    mu_r, cov_r = real_stats.get_mean_cov()
    mu_g, cov_g = gen_stats.get_mean_cov()
    return {"fid": frechet_distance(mu_g, cov_g, mu_r, cov_r)}


@register_metric
def kid(real_stats=None, gen_stats=None, **_):
    return {"kid": kid_from_features(real_stats.get_all(),
                                     gen_stats.get_all())}


@register_metric
def pr(real_stats=None, gen_stats=None, nhood_size=3, **_):
    p, r = knn_precision_recall(real_stats.get_all(), gen_stats.get_all(),
                                nhood_size=nhood_size)
    return {"precision": p, "recall": r}


@register_metric
def ppl2_wend(G=None, params=None, lpips_loss=None, camera_sampler=None,
              num_samples=1000, generator=None, draws=None, **_):
    return {"ppl": ppl_wend(G, params, lpips_loss, camera_sampler,
                            num_samples=num_samples, generator=generator,
                            draws=draws)}


@register_metric
def is50k(gen_probs=None, num_splits=10, **_):
    """Inception Score over generated-sample class probabilities (capture
    them with ``metrics.inception.inception_logits`` and a softmax)."""
    probs = (gen_probs.detach().cpu().numpy()
             if isinstance(gen_probs, torch.Tensor) else
             np.asarray(gen_probs))
    mean, std = inception_score(probs, num_splits)
    return {"is_mean": mean, "is_std": std}


def equivariance_metrics(G3, params, *, num_samples=64, batch=8,
                         translate_frac=0.125, eqt_frac=False,
                         generator=None):
    """EQ-T / EQ-R (+ optional EQ-T_frac) for the alias-free (SG3)
    generator, through ``metrics.equivariance``. Returns {'eqt': dB,
    'eqr': dB[, 'eqt_frac': dB]}."""
    from tgi_torch.metrics.equivariance import compute_equivariance_metrics
    out = compute_equivariance_metrics(
        G3, params, num_samples=num_samples, batch_size=batch,
        translate_max=translate_frac, eqt_int=True, eqt_frac=eqt_frac,
        eqr=True, generator=generator)
    res = {"eqt": out["eqt_int"], "eqr": out["eqr"]}
    if eqt_frac:
        res["eqt_frac"] = out["eqt_frac"]
    return res
