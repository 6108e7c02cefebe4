"""The metric registry, the distances, IS and PPL (the port's
``metrics/gan_metrics.py``) against tgi's, on the CPU.

The distances are the same host numpy on the same features: FID, KID,
precision/recall and IS agree with tgi's to 1e-9 relative. PPL renders
on the tiny generator pair with tgi's draws handed in; its difference
quotient divides the LPIPS distance of two renders ``epsilon`` apart by
``epsilon²``, so a float32 difference between the two renders' pixels
is amplified by ``1 / epsilon`` relative. At epsilon 1e-2 the two agree
within 2e-3 relative."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_helpers import tiny_pair
from tgi.metrics import gan_metrics as jm
from tgi.metrics.features import FeatureStats as JStats
from tgi_torch.metrics import gan_metrics as tm
from tgi_torch.metrics.features import FeatureStats

REL = 1e-9


def _features(seed, n, f=64, shift=0.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, f) * (1 + 0.3 * rng.rand(f)) + shift).astype(
        np.float32)


def _stats(cls, feats):
    s = cls(capture_all=True, capture_mean_cov=True)
    for i in range(0, len(feats), 7):
        s.append(feats[i:i + 7])
    return s


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.mark.parametrize("n_real,n_gen", [(120, 80), (40, 150)])
def test_distances_match_tgi(n_real, n_gen):
    real = _features(0, n_real)
    gen = _features(1, n_gen, shift=0.2)
    jr, jg = _stats(JStats, real), _stats(JStats, gen)
    tr, tg = _stats(FeatureStats, real), _stats(FeatureStats, gen)
    for name in ("fid", "kid", "pr"):
        want = jm.calc_metric(name, real_stats=jr, gen_stats=jg)["results"]
        got = tm.calc_metric(name, real_stats=tr, gen_stats=tg)["results"]
        assert got.keys() == want.keys()
        for k in want:
            assert _rel(got[k], want[k]) <= REL, (name, k, got[k], want[k])
    mu1, s1 = tr.get_mean_cov()
    mu2, s2 = tg.get_mean_cov()
    assert _rel(tm.frechet_distance(mu1, s1, mu2, s2),
                jm.frechet_distance(mu1, s1, mu2, s2)) <= REL
    assert tm.knn_precision_recall(real, gen, nhood_size=5, row_batch=32) \
        == jm.knn_precision_recall(real, gen, nhood_size=5, row_batch=32)
    assert _rel(tm.kid_from_features(real, gen, num_subsets=7,
                                     max_subset_size=30),
                jm.kid_from_features(real, gen, num_subsets=7,
                                     max_subset_size=30)) <= REL


def test_fixed_points():
    """A set against itself: FID ~ 0 and precision = recall = 1."""
    real = _features(2, 100)
    s = _stats(FeatureStats, real)
    assert abs(tm.calc_metric("fid", real_stats=s, gen_stats=s)
               ["results"]["fid"]) < 1e-6
    assert tm.calc_metric("pr", real_stats=s, gen_stats=s)["results"] == {
        "precision": 1.0, "recall": 1.0}


@pytest.mark.parametrize("num_splits", [10, 3])
def test_inception_score_matches_tgi(num_splits):
    rng = np.random.RandomState(3)
    logits = rng.randn(60, 1008).astype(np.float32) * 3
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    want = jm.calc_metric("is50k", gen_probs=probs,
                          num_splits=num_splits)["results"]
    got = tm.calc_metric("is50k", gen_probs=torch.from_numpy(probs),
                         num_splits=num_splits)["results"]
    for k in ("is_mean", "is_std"):
        assert _rel(got[k], want[k]) <= REL, k
    assert 1 <= got["is_mean"] <= 1008


def test_registry_and_report(tmp_path, capsys):
    assert tm.list_metrics() == jm.list_metrics() == [
        "fid", "is50k", "kid", "ppl2_wend", "pr"]
    with pytest.raises(ValueError, match="unknown metric"):
        tm.calc_metric("fid50k")
    s = _stats(FeatureStats, _features(4, 30))
    res = tm.calc_metric("fid", real_stats=s, gen_stats=s)
    assert res["metric"] == "fid" and res["total_time"] >= 0
    recs = [tm.report_metric(res, run_dir=str(tmp_path), snapshot="G.pt")
            for _ in range(2)]
    lines = (tmp_path / "metric-fid.jsonl").read_text().splitlines()
    assert [json.loads(l) for l in lines] == recs
    assert recs[0]["snapshot"] == "G.pt" and recs[0]["results"] == \
        res["results"]
    assert json.loads(capsys.readouterr().out.splitlines()[0])["metric"] \
        == "fid"


def test_ppl_matches_tgi():
    """``ppl2_wend`` through ``calc_metric`` with tgi's draws: 3 segments
    of 2, the VGG/LPIPS drawn at 1/8 width and shared."""
    from tgi.apps.calc_metrics import default_camera_sampler as jsampler
    from tgi.losses.lpips import LPIPSLoss as JLPIPS
    from tgi_torch.apps.calc_metrics import default_camera_sampler
    from tgi_torch.losses.lpips import LPIPSLoss
    from tgi_torch.models import vgg
    gj, pj, gt, pt = tiny_pair()
    gen = torch.Generator().manual_seed(0)
    v, h = (vgg.vgg16_init(gen, "cpu", width_mult=0.125),
            vgg.lpips_head_init(gen, "cpu", width_mult=0.125))
    to_j = (lambda tree: jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                      tree))
    jl, tl = JLPIPS(to_j(v), to_j(h)), LPIPSLoss(v, h)
    eps, batch, n = 1e-2, 2, 6
    key = jax.random.PRNGKey(3)
    want = jm.ppl_wend(gj, pj, jl, jsampler(gj), num_samples=n,
                       epsilon=eps, batch=batch, key=key)
    draws = []
    for i in range(n // batch):
        kz0, kz1, kc, kt = jax.random.split(jax.random.fold_in(key, i), 4)
        draws.append(tuple(torch.from_numpy(np.array(a)) for a in (
            jax.random.normal(kz0, (batch, 32)),
            jax.random.normal(kz1, (batch, 32)),
            jsampler(gj)(kc, batch),
            jax.random.uniform(kt, (batch, 1, 1)))))
    got = tm.ppl_wend(gt, pt, tl, default_camera_sampler(device="cpu"),
                      num_samples=n, epsilon=eps, batch=batch, draws=draws)
    assert np.isfinite(got) and got > 0
    assert _rel(got, want) <= 2e-3, (got, want)
    # The registered form draws its own (seeded) segments.
    res = tm.calc_metric("ppl2_wend", G=gt, params=pt, lpips_loss=tl,
                         camera_sampler=default_camera_sampler(device="cpu"),
                         num_samples=4)["results"]
    assert np.isfinite(res["ppl"])
