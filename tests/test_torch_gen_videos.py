"""tgi_torch's orbit videos against tgi's, on the CPU, at the tiny config
(plane C = 8, 32² backbone, 16² rays, 8 + 8 samples x ``sample_mult``,
64² images): the orbit's cameras and the w spline (1e-6), three frames
rendered two at a time (so the last batch is padded) within 1 of tgi's
uint8 frames, the per-frame shape export's sigma grid (1e-5 relative),
the video file and the command line."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tgi.apps import gen_videos as jgen_videos
from tgi_torch.apps import gen_videos
from tgi_torch.io.checkpoints import save_checkpoint

from torch_helpers import TOL, close, jit_ref, tiny_pair


@pytest.fixture(scope="module")
def setup():
    gj, pj, gt, pt = tiny_pair()
    rng = np.random.RandomState(11)
    ws = (0.5 * rng.randn(1, gt.cfg.num_ws, 32)).astype(np.float32)
    return dict(gj=gj, pj=pj, gt=gt, pt=pt, ws=ws)


def test_orbit_cameras_match_tgi():
    want = jgen_videos.orbit_cameras(7, (0, 0, 0.2), radius=2.6)
    got = gen_videos.orbit_cameras(7, (0, 0, 0.2), radius=2.6, device="cpu")
    assert got.shape == (7, 25)
    close(got, want, 1e-6)


def test_interp_ws_matches_tgi():
    keys = np.random.RandomState(12).randn(3, 4, 5).astype(np.float32)
    got = gen_videos.interp_ws(keys, 11)
    close(got, jgen_videos.interp_ws(keys, 11), 1e-6)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(gen_videos.interp_ws(keys[:1], 4),
                                  np.repeat(keys[:1], 4, axis=0))


def test_render_orbit_matches_tgi(setup, monkeypatch):
    """3 frames in batches of 2: the second batch is padded with the first
    frame's code and camera."""
    s = setup
    jit = jax.jit
    monkeypatch.setattr(jax, "jit", lambda fn: jit(
        fn, compiler_options={"xla_backend_optimization_level": 0}))
    want = jgen_videos.render_orbit(s["gj"], s["pj"], jnp.asarray(s["ws"]),
                                    num_frames=3, batch=2)
    got = gen_videos.render_orbit(s["gt"], s["pt"], torch.from_numpy(s["ws"]),
                                  num_frames=3, batch=2)
    assert got.shape == (3, 64, 64, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert np.abs(got[0].astype(int) - got[1].astype(int)).mean() > 0.1


def test_render_orbit_interpolates_keyframes(setup, monkeypatch):
    """K > 1 codes are splined over the frames (interp_ws) and rendered
    frame by frame with the frame's code."""
    s = setup
    keys = np.concatenate([s["ws"], -s["ws"]])
    seen = []
    real = type(s["gt"]).synthesis

    def spy(self, params, ws, c, **kw):
        seen.append(ws.clone())
        return real(self, params, ws, c, **kw)

    monkeypatch.setattr(type(s["gt"]), "synthesis", spy)
    frames = gen_videos.render_orbit(s["gt"], s["pt"], torch.from_numpy(keys),
                                     num_frames=4, batch=4, sample_mult=1)
    assert frames.shape == (4, 64, 64, 3)
    np.testing.assert_array_equal(torch.cat(seen).numpy(),
                                  gen_videos.interp_ws(keys, 4))


def test_export_frame_shape_matches_tgi(setup, tmp_path, monkeypatch):
    """The grid handed to marching tetrahedra: tgi's sigma grid, flipped
    and with its borders zeroed (res 16: 1 voxel, 2 at the top)."""
    from tgi.utils import marching as jmarching
    from tgi_torch.utils import marching
    s = setup
    grids = {}
    for name, mod in (("tgi", jmarching), ("port", marching)):
        real = mod.marching_tetrahedra

        def capture(grid, *a, _real=real, _name=name, **kw):
            grids[_name] = grid.copy()
            return _real(grid, *a, **kw)

        monkeypatch.setattr(mod, "marching_tetrahedra", capture)
    monkeypatch.setattr(s["gj"], "backbone_planes",
                        jit_ref(s["gj"].backbone_planes))
    jgen_videos.export_frame_shape(s["gj"], s["pj"], jnp.asarray(s["ws"]),
                                   str(tmp_path / "j.ply"), resolution=16,
                                   level=0.1)
    out = gen_videos.export_frame_shape(
        s["gt"], s["pt"], torch.from_numpy(s["ws"]), str(tmp_path / "t.ply"),
        resolution=16, level=0.1)
    close(grids["port"], grids["tgi"], TOL)
    assert (grids["port"][:1] == 0).all() and (grids["port"][:, -2:] == 0).all()
    assert out == str(tmp_path / "t.ply")
    assert (tmp_path / "t.ply").read_text().startswith("ply\n")


def test_write_video_and_gen_interp_video(setup, tmp_path):
    """An mp4 where imageio has ffmpeg, else the GIF beside it."""
    imageio = pytest.importorskip("imageio")
    s = setup
    path = gen_videos.gen_interp_video(s["gt"], s["pt"],
                                       torch.from_numpy(s["ws"]),
                                       str(tmp_path / "v.mp4"), num_frames=3,
                                       batch=3, sample_mult=1)
    assert path in (str(tmp_path / "v.mp4"), str(tmp_path / "v.gif"))
    back = imageio.mimread(path)
    assert len(back) == 3 and back[0].shape[:2] == (64, 64)


def test_gen_videos_cli(setup, tmp_path, capsys):
    pytest.importorskip("click")
    pytest.importorskip("imageio")
    s = setup
    net = tmp_path / "G.pt"
    save_checkpoint(str(net), s["pt"], config=s["gt"].cfg)
    np.save(tmp_path / "face_ws.npy", s["ws"])
    for extra in (["--ws", str(tmp_path / "face_ws.npy"), "--shapes",
                   "--shape-res", "8"], ["--seeds", "1-2"]):
        with pytest.raises(SystemExit) as e:
            gen_videos.main(["--network", str(net), "--output",
                             str(tmp_path / "o.mp4"), "--frames", "2",
                             "--sample-mult", "1", "--device", "cpu",
                             *extra])
        assert e.value.code == 0
        assert "wrote " in capsys.readouterr().out
    assert sorted(p.name for p in (tmp_path / "o_shapes").iterdir()) == [
        "0000_shape.ply", "0001_shape.ply"]
    with pytest.raises(SystemExit) as e:
        gen_videos.main(["--network", str(net), "--output",
                         str(tmp_path / "o.mp4"), "--device", "cpu"])
    assert e.value.code != 0
