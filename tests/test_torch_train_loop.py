"""The port's dataset, statistics, training loop and ``train_gan`` (the
twins of tgi/train/dataset.py, tgi/utils/stats.py, tgi/train/loop.py and
tgi/apps/train_gan.py), on the CPU at tiny size."""

import io
import json
import os
import zipfile

import numpy as np
import pytest
import torch

from tests.torch_helpers import (TINY, TINY_D, TINY_RK, leaves_with_paths,
                                 tiny_camera)
from tgi_torch.train import dataset as td


def _labels(n):
    return [np.concatenate([tiny_camera(0.1 * i)[0]]).tolist()
            for i in range(n)]


def _png_bytes(arr):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _png_dataset(tmp_path, kind, n=6, res=48):
    """n random PNGs (in a folder or a zip) with dataset.json labels."""
    rng = np.random.RandomState(0)
    files = {f"sub/img{i}.png": _png_bytes(
        (rng.rand(res, res, 3) * 255).astype(np.uint8)) for i in range(n)}
    meta = json.dumps({"labels": [[f, l] for f, l in
                                  zip(sorted(files), _labels(n))]})
    if kind == "zip":
        path = str(tmp_path / "data.zip")
        with zipfile.ZipFile(path, "w") as z:
            for f, b in files.items():
                z.writestr(f, b)
            z.writestr("dataset.json", meta)
        return path
    path = tmp_path / "data"
    (path / "sub").mkdir(parents=True)
    for f, b in files.items():
        (path / f).write_bytes(b)
    (path / "dataset.json").write_text(meta)
    return str(path)


@pytest.mark.parametrize("resolution", [None, 32])
@pytest.mark.parametrize("kind", ["folder", "zip"])
def test_dataset_matches_tgi(tmp_path, kind, resolution):
    """Images (Pillow's decode and Lanczos resize), labels and the
    xflipped half with its mirrored pose, bit for bit."""
    from tgi.train.dataset import ImageFolderDataset as J
    path = _png_dataset(tmp_path, kind)
    want = J(path, resolution=resolution, xflip=True)
    got = td.ImageFolderDataset(path, resolution=resolution, xflip=True)
    assert len(got) == len(want) == 12 and got.label_dim == 25
    for i in range(len(want)):
        (wi, wl), (gi, gl) = want[i], got[i]
        assert np.array_equal(wi, gi) and np.array_equal(wl, gl), i
    assert not np.array_equal(got[0][1], got[6][1])
    got.close()


def test_npy_images(tmp_path):
    """A folder of ``.npy`` images ([3, H, W] in [-1, 1]) loads without
    Pillow's decode, flips and keeps its labels."""
    rng = np.random.RandomState(1)
    arrs = [rng.uniform(-1, 1, (3, 16, 16)).astype(np.float32)
            for _ in range(3)]
    for i, a in enumerate(arrs):
        np.save(tmp_path / f"im{i}.npy", a)
    (tmp_path / "dataset.json").write_text(json.dumps(
        {"labels": [[f"im{i}.npy", l] for i, l in enumerate(_labels(3))]}))
    ds = td.ImageFolderDataset(str(tmp_path), resolution=16, xflip=True)
    assert len(ds) == 6
    img, label = ds[1]
    assert np.array_equal(img, arrs[1])
    assert np.array_equal(label, np.asarray(_labels(3)[1], np.float32))
    flipped, _ = ds[4]
    assert np.array_equal(flipped, arrs[1][:, :, ::-1])
    small = td.ImageFolderDataset(str(tmp_path), resolution=8)
    assert small[0][0].shape == (3, 8, 8)


def test_infinite_batches_order(tmp_path):
    """Batches and their order from one seed, bit for bit, across epochs
    and host shards."""
    from tgi.train.dataset import ImageFolderDataset as J
    from tgi.train.dataset import infinite_batches as jib
    path = _png_dataset(tmp_path, "folder", n=5, res=8)
    want_ds, got_ds = J(path, xflip=True), td.ImageFolderDataset(
        path, xflip=True)
    for kw in (dict(seed=3), dict(seed=4, host_id=1, num_hosts=2)):
        want, got = jib(want_ds, 2, **kw), td.infinite_batches(got_ds, 2,
                                                               **kw)
        for _ in range(9):
            (wi, wl), (gi, gl) = next(want), next(got)
            assert np.array_equal(wi, gi) and np.array_equal(wl, gl)


def test_collector_and_logger(tmp_path):
    from tgi.utils.stats import Collector as JC
    from tgi_torch.utils.stats import Collector, JsonlLogger
    want, got = JC(), Collector(regex="loss.*")
    rng = np.random.RandomState(2)
    for _ in range(5):
        m = {"loss_a": float(rng.randn()), "loss_b": rng.randn(3),
             "other": 1.0}
        want.update(m)
        got.update({k: torch.as_tensor(v) for k, v in m.items()})
    for k in ("loss_a", "loss_b"):
        assert got.mean(k) == want.mean(k) and got.std(k) == want.std(k)
    assert set(got.as_dict()) == {"loss_a", "loss_b"}
    got.reset()
    assert np.isnan(got.mean("loss_a"))
    log = JsonlLogger(str(tmp_path / "s.jsonl"))
    log.write({"tick": 0, "g_loss": 0.5})
    log.write({"tick": 1})
    log.close()
    recs = [json.loads(l) for l in open(tmp_path / "s.jsonl")]
    assert [r["tick"] for r in recs] == [0, 1] and "timestamp" in recs[0]


def _tiny_models():
    from tgi_torch.models.generator import (GeneratorConfig,
                                            TriPlaneGenerator,
                                            default_rendering_kwargs)
    from tgi_torch.nn.discriminator import DiscriminatorConfig
    from tgi_torch.train.gan import GANTrainConfig
    G = TriPlaneGenerator(GeneratorConfig(
        rendering_kwargs=default_rendering_kwargs(**TINY_RK), **TINY))
    cfg = GANTrainConfig(batch_size=2, blur_init_sigma=1.0,
                         density_reg_samples=16, g_reg_interval=2,
                         d_reg_interval=2,
                         neural_rendering_resolution_initial=16)
    return G, DiscriminatorConfig(**TINY_D), cfg


def _tree_bits(tree):
    return {p: t.detach().clone() for p, t in leaves_with_paths(tree)}


def test_training_loop_ticks_checkpoint_resume(tmp_path):
    """Two ticks of two steps (ADA on from p = 0.2, lazy regularisers
    every other step): the tick records in stats.jsonl, a checkpoint and
    an image grid per tick, ``abort_fn`` stopping the loop; then a resume
    restores the whole train state (G, D, EMA, both Adams) bit for bit,
    and one more step runs from it."""
    from tgi_torch.train.gan import train_state_tree
    from tgi_torch.train.loop import training_loop
    data = _png_dataset(tmp_path, "zip", n=4, res=64)
    run = str(tmp_path / "run")
    G, d_cfg, cfg = _tiny_models()
    ticks, metrics = [], []
    common = dict(G=G, d_cfg=d_cfg, data_path=data, run_dir=run, cfg=cfg,
                  kimg_per_tick=0.004, snapshot_ticks=1, device="cpu",
                  augment_p=0.2)
    state = training_loop(total_kimg=1, image_snapshot_ticks=1,
                          metric_fns={"g_ema_norm": lambda g: float(
                              g["decoder"]["net0"]["weight"].norm())},
                          abort_fn=lambda: ticks.append(1) or len(ticks) >= 2,
                          **common)
    # Named by whole kimg as tgi names them: the second tick's files
    # replace the first's.
    files = sorted(os.listdir(run))
    assert files == ["fakes-000000.png", "network-000000.ckpt",
                     "stats.jsonl"], files
    recs = [json.loads(l) for l in open(os.path.join(run, "stats.jsonl"))]
    ticks_rec = [r for r in recs if "g_loss" in r]
    assert [r["kimg"] for r in ticks_rec] == [0.004, 0.008]
    for r in ticks_rec:
        assert all(np.isfinite(r[k]) for k in ("g_loss", "g_reg", "d_loss",
                                               "d_reg", "sec_per_kimg"))
        assert -1 <= r["signs_real"] <= 1 and r["ada_p"] >= 0
    assert [r["metric"] for r in recs if "metric" in r] == ["g_ema_norm"] * 2

    saved = _tree_bits(train_state_tree(state))
    assert saved[("g_opt", "step")] == 4 and saved[("d_opt", "step")] == 4
    ckpt = os.path.join(run, "network-000000.ckpt")
    resumed = training_loop(total_kimg=0.008, resume_ckpt=ckpt,
                            image_snapshot_ticks=0, **common)
    got = _tree_bits(train_state_tree(resumed))
    assert got.keys() == saved.keys()
    assert all(torch.equal(got[p], saved[p]) for p in saved)

    more = training_loop(total_kimg=0.010, resume_ckpt=ckpt,
                         image_snapshot_ticks=0, **common)
    after = _tree_bits(train_state_tree(more))
    assert after[("g_opt", "step")] == 5
    assert not torch.equal(after[("g_params", "decoder", "net0", "weight")],
                           saved[("g_params", "decoder", "net0", "weight")])


def test_unported_options_raise(tmp_path, monkeypatch):
    """Options refused until they were ported now run. Orbax snapshots
    (``io/orbax_io.py``'s counterpart): the step runs as without them,
    bit for bit, and leaves one finished step holding that state and its
    ``cur_nimg``. The mesh and ``--mesh-data`` (ROADMAP item 14) run on
    one CPU device: a step over the (1, 1) mesh is the step without it,
    bit for bit, through ``training_loop`` and ``train_gan``, and the
    command line takes ``--mesh-data 1``; ``--mesh-data 2`` without a
    process group of two is refused."""
    from tgi_torch.apps import train_gan as app
    from tgi_torch.io.orbax_io import make_manager, restore_latest
    from tgi_torch.parallel import make_mesh
    from tgi_torch.train.gan import train_state_tree
    from tgi_torch.train.loop import training_loop
    G, d_cfg, cfg = _tiny_models()
    data = _png_dataset(tmp_path, "zip", n=2, res=64)
    common = dict(G=G, d_cfg=d_cfg, data_path=data, cfg=cfg, device="cpu",
                  total_kimg=0.002, image_snapshot_ticks=0)
    snapped = _tree_bits(train_state_tree(training_loop(
        checkpoint_backend="orbax", kimg_per_tick=0.002, snapshot_ticks=1,
        run_dir=str(tmp_path / "o"), **common)))
    want = _tree_bits(train_state_tree(training_loop(
        run_dir=str(tmp_path / "a"), **common)))
    assert snapped.keys() == want.keys()
    assert all(torch.equal(snapped[p], want[p]) for p in want)
    manager = make_manager(str(tmp_path / "o" / "snapshots"))
    data_o, step = restore_latest(manager)
    assert manager.all_steps() == [2] and step == 2
    assert data_o["cur_nimg"] == 2
    saved = dict(leaves_with_paths(data_o["params"]))
    assert saved.keys() == want.keys()
    assert all(torch.equal(saved[p], want[p]) for p in want)
    got = _tree_bits(train_state_tree(training_loop(
        mesh=make_mesh(devices=["cpu"]), run_dir=str(tmp_path / "b"),
        **common)))
    assert got.keys() == want.keys()
    assert all(torch.equal(got[p], want[p]) for p in want)

    monkeypatch.setattr(app, "training_configs",
                        lambda **kw: (G, d_cfg, cfg))
    state = app.train_gan(data, str(tmp_path / "c"), mesh_data=1,
                          device="cpu", total_kimg=0.002,
                          image_snapshot_ticks=0)
    got = _tree_bits(train_state_tree(state))
    assert all(torch.equal(got[p], want[p]) for p in want)
    # The command line's --total-kimg is whole kimg, as tgi's: 0 builds
    # the mesh and the state and takes no step.
    with pytest.raises(SystemExit) as done:
        app.main(["--data", data, "--outdir", str(tmp_path / "d"),
                  "--mesh-data", "1", "--device", "cpu", "--total-kimg",
                  "0"])
    assert done.value.code == 0
    with pytest.raises(ValueError, match="data axis"):
        app.train_gan(data, str(tmp_path / "e"), mesh_data=2, device="cpu")
    with pytest.raises(ValueError, match="data axis"):
        app.main(["--data", data, "--outdir", str(tmp_path / "f"),
                  "--mesh-data", "2", "--device", "cpu"])


def test_training_configs_are_tgi_defaults():
    """``train_gan``'s configuration is tgi's launcher's: EG3D's FFHQ 512
    training setup in bf16 mixed precision."""
    from tgi_torch.apps.train_gan import training_configs
    G, d_cfg, cfg = training_configs()
    assert (G.cfg.img_resolution, G.cfg.neural_rendering_resolution,
            G.cfg.fused_dtype, G.cfg.backbone_resolution,
            G.cfg.plane_channels) == (512, 64, "bfloat16", 256, 32)
    rk = G.cfg.rendering_kwargs
    assert (rk["superresolution_module"], rk["density_reg"],
            rk["depth_resolution"], rk["depth_resolution_importance"]) == (
                "SuperresolutionHybrid8XDC", 0.25, 48, 48)
    assert (d_cfg.img_resolution, d_cfg.img_channels, d_cfg.c_dim) == (
        512, 6, 25)
    assert (cfg.batch_size, cfg.r1_gamma, cfg.gpc_reg_prob) == (4, 1.0, 0.5)


def test_profiling_utilities(tmp_path):
    """Named scopes, phase times, a trace file and the numerics check."""
    from tgi_torch.utils import profiling as pr

    @pr.profiled_function
    def double(x):
        return 2 * x

    timer = pr.PhaseTimer()
    for _ in range(2):
        with timer.phase("double", device="cpu"), pr.record_scope("inner"):
            double(torch.ones(3))
    assert timer.counts == {"double": 2} and timer.means_ms()["double"] >= 0
    with pr.trace(str(tmp_path / "trace")):
        double(torch.ones(3))
    assert os.listdir(tmp_path / "trace")
    pr.check_numerics({"a": {"b": torch.ones(2)}})
    with pytest.raises(FloatingPointError, match="'b'"):
        pr.check_numerics({"a": {"b": torch.tensor([1.0, float("nan")])}})
