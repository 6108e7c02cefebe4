"""``python -m tgi_torch.apps.calc_metrics`` (the port's twin of
tgi/apps/calc_metrics.py) and the metrics hook of the training loop, on
the CPU at tiny size.

The command line reads a tiny generator's ``.ckpt``, a folder of
``.npy`` images and an Inception detector saved with ``torch.save`` (in
torchvision's layout and in NVIDIA's names), writes each metric's jsonl
record, and hands ``calc_metric`` the features computed here directly
(the same seeded draws). It refuses is50k and ppl2_wend by name, and
warns when it falls back to random VGG features."""

import json
import os

import numpy as np
import pytest
import torch

from tests.torch_helpers import (TINY, TINY_D, TINY_RK, inception_params,
                                 tiny_camera)
from tgi_torch.apps import calc_metrics as app
from tgi_torch.io.checkpoints import save_checkpoint
from tgi_torch.metrics import inception as ti

N_ITEMS = 5


def _tiny_generator():
    from tgi_torch.models.generator import (GeneratorConfig,
                                            TriPlaneGenerator,
                                            default_rendering_kwargs)
    G = TriPlaneGenerator(GeneratorConfig(
        rendering_kwargs=default_rendering_kwargs(**TINY_RK), **TINY))
    return G, G.init(torch.Generator().manual_seed(0), device="cpu")


def _npy_images(path, n, res=64, seed=0):
    rng = np.random.RandomState(seed)
    os.makedirs(path, exist_ok=True)
    for i in range(n):
        np.save(os.path.join(path, f"img{i}.npy"),
                rng.uniform(-1, 1, (3, res, res)).astype(np.float32))
    return str(path)


def _detector(tmp_path, layout):
    """A drawn Inception (``torch_helpers.inception_params``) saved with
    ``torch.save`` in ``layout``; returns (its path, the params)."""
    p = _torch(inception_params(3, 1008 if layout == "nvidia" else 1000))
    sd = (ti.nvidia_state_dict(p) if layout == "nvidia"
          else ti.torch_state_dict(p))
    path = str(tmp_path / f"inception_{layout}.pt")
    torch.save(sd, path)
    return path, p


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


@pytest.fixture
def setup(tmp_path):
    G, params = _tiny_generator()
    net = str(tmp_path / "G.ckpt")
    save_checkpoint(net, params, config=G.cfg)
    data = _npy_images(tmp_path / "data", N_ITEMS)
    return dict(G=G, params=params, net=net, data=data, tmp=tmp_path)


def _records(run):
    return {f[len("metric-"):-len(".jsonl")]:
            [json.loads(l) for l in open(os.path.join(run, f))]
            for f in sorted(os.listdir(run)) if f.startswith("metric-")}


@pytest.mark.parametrize("layout", ["torchvision", "nvidia"])
def test_cli_end_to_end(setup, layout, monkeypatch):
    """The command line's records, finite, from the features of the data
    and of the generator's seed-0 draws: the statistics it hands
    ``calc_metric`` equal features computed here. kid and pr only: FID's
    2048² ``sqrtm`` takes ~20 s on one core; ``calc_metric``'s fid is
    held against tgi's in test_torch_gan_metrics.py, and the command
    line's fid runs at full width on the card (chip_smoke.py phase
    15b)."""
    metrics = "kid,pr"
    from tgi_torch.metrics import gan_metrics
    from tgi_torch.metrics.features import compute_generator_features
    from tgi_torch.train.dataset import ImageFolderDataset
    seen = []
    real_calc = gan_metrics.calc_metric

    def calc_metric(name, **kw):
        seen.append((name, kw["real_stats"], kw["gen_stats"]))
        return real_calc(name, **kw)

    monkeypatch.setattr(gan_metrics, "calc_metric", calc_metric)
    det, p = _detector(setup["tmp"], layout)
    run = str(setup["tmp"] / f"run_{layout}")
    os.makedirs(run)
    with pytest.raises(SystemExit) as e:
        app.main(["--network", setup["net"], "--data", setup["data"],
                  "--metrics", metrics, "--num-items", str(N_ITEMS),
                  "--run-dir", run, "--detector", det, "--device", "cpu"])
    assert e.value.code == 0
    recs = _records(run)
    assert sorted(recs) == sorted(metrics.split(","))
    got = {k: v for r in recs.values() for k, v in r[0]["results"].items()}
    assert all(np.isfinite(v) for v in got.values()), got
    assert [n for n, _, _ in seen] == metrics.split(",")
    assert any(f.startswith("feats-") for f in os.listdir(run))

    fn = (ti.inception_feature_fn(p) if layout == "torchvision" else
          (lambda x: ti.nvidia_detector_fn(p)((x + 1) * 127.5)))
    ds = ImageFolderDataset(setup["data"], resolution=64)
    with torch.no_grad():
        real = fn(torch.from_numpy(np.stack([ds[i][0]
                                             for i in range(N_ITEMS)])))
    gen = compute_generator_features(
        setup["G"], setup["params"], fn,
        app.default_camera_sampler(device="cpu"), num_items=N_ITEMS)
    _, real_stats, gen_stats = seen[0]
    assert real_stats.num_items == gen_stats.num_items == N_ITEMS
    np.testing.assert_allclose(real_stats.get_all(), real.numpy(), rtol=0,
                               atol=1e-6 * real.abs().max().item())
    assert np.array_equal(gen_stats.get_all(), gen.get_all())
    assert np.abs(real_stats.get_all() - gen_stats.get_all()).max() > 0


def test_cli_refuses_is_and_ppl(setup, capsys):
    for metrics in ("is50k", "fid,ppl2_wend", "fid,kid,is50k,ppl2_wend"):
        with pytest.raises(SystemExit) as e:
            app.main(["--network", setup["net"], "--data", setup["data"],
                      "--metrics", metrics, "--device", "cpu"])
        assert e.value.code == 2
        named = ",".join(m for m in metrics.split(",")
                         if m in ("is50k", "ppl2_wend"))
        assert f"--metrics {named}:" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        app.main(["--network", setup["net"], "--data", setup["data"],
                  "--metrics", "fid50k", "--device", "cpu"])
    assert e.value.code == 2 and "unknown" in capsys.readouterr().err


def test_cli_vgg_fallback_warns(setup, capsys):
    """No --detector and no --vgg-weights: tgi's warning, then the
    random VGG/LPIPS features (pooled), and a record per metric."""
    run = str(setup["tmp"] / "run_vgg")
    os.makedirs(run)
    with pytest.raises(SystemExit) as e:
        app.main(["--network", setup["net"], "--data", setup["data"],
                  "--metrics", "kid,pr", "--num-items", "4", "--run-dir",
                  run, "--device", "cpu"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "WARNING: random-init VGG detector" in out
    assert np.isfinite(_records(run)["kid"][0]["results"]["kid"])


def test_training_loop_metric_record(tmp_path):
    """``training_loop(metric_fns={"fid": ...})``: at the snapshot tick the
    fid of the EMA generator against the dataset's features is written
    to stats.jsonl beside the tick record."""
    from tgi_torch.metrics.features import (compute_dataset_features,
                                            compute_generator_features)
    from tgi_torch.metrics.gan_metrics import calc_metric
    from tgi_torch.nn.discriminator import DiscriminatorConfig
    from tgi_torch.train.dataset import ImageFolderDataset
    from tgi_torch.train.gan import GANTrainConfig
    from tgi_torch.train.loop import training_loop
    G, _ = _tiny_generator()
    data = _npy_images(tmp_path / "data", 4, seed=1)
    with open(os.path.join(data, "dataset.json"), "w") as f:
        json.dump({"labels": [[f"img{i}.npy",
                               tiny_camera(0.1 * i)[0].tolist()]
                              for i in range(4)]}, f)

    def pooled(img):
        return torch.nn.functional.avg_pool2d(img, 16).reshape(
            img.shape[0], -1)

    real = compute_dataset_features(ImageFolderDataset(data), pooled)
    seen = []

    def fid(g_ema):
        gen = compute_generator_features(
            G, g_ema, pooled, app.default_camera_sampler(device="cpu"),
            num_items=4, batch_size=2)
        seen.append(gen.num_items)
        return calc_metric("fid", real_stats=real,
                           gen_stats=gen)["results"]["fid"]

    cfg = GANTrainConfig(batch_size=2, blur_init_sigma=0,
                         density_reg_samples=16,
                         neural_rendering_resolution_initial=16)
    run = str(tmp_path / "run")
    training_loop(G=G, d_cfg=DiscriminatorConfig(**TINY_D), data_path=data,
                  run_dir=run, cfg=cfg, total_kimg=1, kimg_per_tick=0.004,
                  snapshot_ticks=1, image_snapshot_ticks=0, ada_target=None,
                  metric_fns={"fid": fid}, abort_fn=lambda: True,
                  device="cpu")
    recs = [json.loads(l) for l in open(os.path.join(run, "stats.jsonl"))]
    metric = [r for r in recs if r.get("metric") == "fid"]
    assert seen == [4] and len(metric) == 1
    assert np.isfinite(metric[0]["value"]) and metric[0]["kimg"] == 0.004
    assert any("g_loss" in r for r in recs)
