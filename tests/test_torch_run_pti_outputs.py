"""What tgi_torch's ``run_pti`` writes at tgi's defaults and with its
output options, on the CPU at the tiny config (plane C = 8, 32²
backbone, 16² rays, 8 + 8 samples, 64² images): the pivot's and the
tuned generator's orbit videos (on by default, as in tgi; 60 frames,
GIFs where imageio has no ffmpeg), through the function and the command
line; the mesh, the locality regulariser, stage 1's snapshots and the
metric writers. The functions behind them are held against tgi's in
``test_torch_shape.py``, ``test_torch_gen_videos.py``,
``test_torch_locality.py`` and ``test_torch_opt_viz.py``."""

import json
import os

import numpy as np
import pytest
import torch

from tgi_torch.apps import gen_videos, shape
from tgi_torch.apps import run_pti as app
from tgi_torch.io.checkpoints import save_checkpoint
from tgi_torch.losses import locality
from tgi_torch.models.generator import (GeneratorConfig, TriPlaneGenerator,
                                        default_rendering_kwargs)
from tgi_torch.utils import opt_viz

from torch_helpers import TINY, TINY_RK, tiny_aux_nets, tiny_camera


@pytest.fixture(scope="module")
def setup():
    gt = TriPlaneGenerator(GeneratorConfig(
        rendering_kwargs=default_rendering_kwargs(**TINY_RK), **TINY))
    return {"gt": gt,
            "pt": gt.init(torch.Generator().manual_seed(0), device="cpu")}


def _images(tmp_path, gt, pt, pivots=True):
    """A 64² target rendered from another w, saved as .npy, and (with
    ``pivots``) a saved pivot."""
    rng = np.random.RandomState(21)
    cam = tiny_camera(0.3)
    with torch.no_grad():
        w = torch.from_numpy(rng.randn(1, gt.cfg.num_ws, 32).astype(
            np.float32))
        img = gt.synthesis(pt, w, torch.from_numpy(cam))["image"]
    imgs, out = tmp_path / "images", tmp_path / "out"
    imgs.mkdir()
    out.mkdir()
    np.save(imgs / "face.npy", img[0].clamp(-1, 1).numpy())
    if pivots:
        np.save(out / "face_ws.npy",
                (0.5 * rng.randn(1, gt.cfg.num_ws, 32)).astype(np.float32))
        np.save(out / "face_cam.npy", cam)
    return imgs, out


def _video(out, stem):
    """The video ``stem`` (mp4, or its GIF fallback) read back."""
    imageio = pytest.importorskip("imageio")
    paths = [out / f"{stem}.{ext}" for ext in ("mp4", "gif")
             if (out / f"{stem}.{ext}").exists()]
    assert len(paths) == 1, os.listdir(out)
    return np.stack(imageio.mimread(str(paths[0]), memtest=False))


def test_run_pti_writes_orbit_videos_by_default(setup, tmp_path,
                                                monkeypatch):
    pytest.importorskip("imageio")
    gt, pt = setup["gt"], setup["pt"]
    imgs, out = _images(tmp_path, gt, pt)
    written = {}
    real_write = gen_videos.write_video

    def keep(path, frames, **kw):
        written[os.path.basename(path)] = frames
        return real_write(path, frames, **kw)

    monkeypatch.setattr(gen_videos, "write_video", keep)
    res = app.run_pti(str(imgs), str(out), G=gt, gen_params=pt,
                      use_last_w_pivots=True, max_pti_steps=1, device="cpu")
    assert res[0]["pti_steps"] == 1
    pivot, tuned = _video(out, "face_pivot"), _video(out, "face")
    assert pivot.shape[0] == tuned.shape[0] == 60
    assert pivot.shape[1:3] == (64, 64)
    # The pivot video is the untuned generator's orbit (the GIF
    # fallback's palette changes the pixels, so the frames handed to the
    # writer are compared), and the orbit turns.
    ws = torch.from_numpy(np.load(out / "face_ws.npy"))
    want = gen_videos.render_orbit(gt, pt, ws, num_frames=60, batch=4)
    np.testing.assert_array_equal(written["face_pivot.mp4"], want)
    assert np.abs(want[0].astype(int) - want[15]).mean() > 0.1
    assert np.abs(written["face.mp4"].astype(int) - want).mean() > 0


def test_run_pti_cli_defaults_write_orbit_videos(setup, tmp_path, capsys):
    pytest.importorskip("click")
    pytest.importorskip("imageio")
    gt, pt = setup["gt"], setup["pt"]
    imgs, out = _images(tmp_path, gt, pt)
    net = tmp_path / "G.pt"
    save_checkpoint(str(net), pt, config=gt.cfg)
    with pytest.raises(SystemExit) as e:
        app.main(["--network", str(net), "--images", str(imgs), "--outdir",
                  str(out), "--use-last-w-pivots", "--allow-random-init",
                  "--max-pti-steps", "1", "--device", "cpu"])
    assert e.value.code == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])[
        "pti_steps"] == 1
    assert _video(out, "face_pivot").shape[0] == 60
    assert _video(out, "face").shape[0] == 60
    with pytest.raises(SystemExit) as e:
        app.main(["--help"])
    help_text = capsys.readouterr().out
    for opt in ("--video / --no-video", "--mesh", "--use-locality-reg",
                "--visualize-opt", "--tensorboard", "--wandb"):
        assert opt in help_text


def test_run_pti_without_imageio_refuses_videos_first(setup, tmp_path,
                                                     monkeypatch):
    """Without imageio, run_pti's default videos raise before any work
    (tgi's would raise after both stages); --no-video runs."""
    import sys
    gt, pt = setup["gt"], setup["pt"]
    imgs, out = _images(tmp_path, gt, pt)
    monkeypatch.setitem(sys.modules, "imageio", None)
    with pytest.raises(ImportError, match="--no-video"):
        app.run_pti(str(imgs), str(out), G=gt, gen_params=pt,
                    use_last_w_pivots=True, max_pti_steps=1, device="cpu")
    assert not (out / "face_G.pt").exists()
    app.run_pti(str(imgs), str(out), G=gt, gen_params=pt, gen_video=False,
                use_last_w_pivots=True, max_pti_steps=1, device="cpu")
    assert (out / "face_G.pt").exists()


def test_run_pti_mesh_locality_snapshots_and_writers(setup, tmp_path,
                                                     monkeypatch):
    """Stage 1 with snapshots, stage 2 with the locality regulariser
    under the image's pivot camera, the mesh, and the writers' scalars."""
    pytest.importorskip("PIL")
    gt, pt = setup["gt"], setup["pt"]
    imgs, out = _images(tmp_path, gt, pt, pivots=False)
    pose, vgg, head = tiny_aux_nets(5)
    seen = []
    real_call = locality.SpaceRegularizer.__call__

    def spy(self, new_params, w_pivot, **kw):
        seen.append(kw["camera"])
        return real_call(self, new_params, w_pivot, **kw)

    monkeypatch.setattr(locality.SpaceRegularizer, "__call__", spy)
    writer = []

    class Recorder(opt_viz.FanoutWriter):
        def __init__(self, logdir):
            super().__init__([])
            self.logdir, self.calls = logdir, []
            writer.append(self)

        def scalar(self, tag, value, step):
            self.calls.append((tag, step))

        def scalars(self, values, step, prefix=""):
            self.calls.append((prefix, sorted(values), step))

    monkeypatch.setattr(opt_viz, "TBWriter", Recorder)
    # run_pti asks for tgi's 256³ mesh; a 16³ one keeps the CPU run short.
    meshes = []
    real_mesh = shape.extract_mesh

    def small_mesh(G, params, ws, resolution, **kw):
        meshes.append(resolution)
        return real_mesh(G, params, ws, resolution=16, **kw)

    monkeypatch.setattr(shape, "extract_mesh", small_mesh)
    res = app.run_pti(str(imgs), str(out), G=gt, gen_params=pt,
                      pose_params=pose, vgg_params=vgg, lpips_head=head,
                      first_inv_steps=2, max_pti_steps=2, gen_video=False,
                      gen_mesh=True, use_locality_reg=True,
                      visualize_opt=True, tensorboard=True, use_wandb=True,
                      device="cpu")
    assert meshes == [256]
    cam = np.load(out / "face_cam.npy")
    # One term per render of the tuning loop, under the pivot camera.
    assert len(seen) == res[0]["pti_steps"] + (res[0]["pti_steps"] < 2)
    assert all(np.array_equal(c.numpy(), cam) for c in seen)
    assert sorted(os.listdir(f"{out}_pivot/face")) == ["2.png",
                                                       "warp_2.png"]
    ply = (out / "face.ply").read_text()
    assert ply.startswith("ply\n") and "element face" in ply
    assert not (out / "face.mp4").exists() and not (out / "face.gif").exists()
    assert [w.logdir for w in writer] == [str(out / "tb")]
    assert writer[0].calls == [("face/projection_loss", 0),
                               ("face/projection_loss", 1),
                               ("face/", ["final_lpips", "pti_steps", "sec"],
                                0)]
    assert json.loads((out / "results.json").read_text()) == res
