"""``run_pti`` with ``batch`` > 1 on the CPU at the tiny config (plane
C = 8, 32² backbone, 16² rays, 8 + 8 samples, SuperresolutionTiny, 64²
images) with small stage-1 nets: three images in chunks of two (a full
chunk and a ragged one of one), through the function and the command
line; every image's pivots, tuned generator and ``results.json`` entry;
saved pivots reused only when every image of a chunk has them; each
chunk's stages through ``project_batch`` and ``tune_batch``, rendering
the chunk in one synthesis call per view."""

import json
import os

import numpy as np
import pytest
import torch

from tgi_torch.apps import run_pti as app
from tgi_torch.invert.coach import PTICoach
from tgi_torch.invert.projector import Projector
from tgi_torch.io.checkpoints import save_checkpoint
from tgi_torch.models.generator import (GeneratorConfig, TriPlaneGenerator,
                                        default_rendering_kwargs)
from tgi_torch.render.cameras import (fov_to_intrinsics, look_at_pose,
                                      pack_camera)

from torch_helpers import (TINY, TINY_RK, check_aux_at_tiny_scale,
                           leaves_with_paths, tiny_aux_nets)

NAMES = ("a", "b", "c")


@pytest.fixture(scope="module")
def setup():
    gt = TriPlaneGenerator(GeneratorConfig(
        rendering_kwargs=default_rendering_kwargs(**TINY_RK), **TINY))
    return {"gt": gt,
            "pt": gt.init(torch.Generator().manual_seed(0), device="cpu")}


def _images(tmp_path, gt, pt):
    """Three targets rendered from other w's at three yaws, as .npy."""
    rng = np.random.RandomState(14)
    imgs = tmp_path / "images"
    imgs.mkdir()
    for i, name in enumerate(NAMES):
        cam = look_at_pose(np.pi / 2 + 0.2 * i - 0.2, np.pi / 2,
                           torch.tensor([0, 0, 0.2]), radius=2.7,
                           device="cpu")
        c = pack_camera(cam[None], fov_to_intrinsics(18.837, device="cpu"))
        with torch.no_grad():
            w = torch.from_numpy(rng.randn(1, gt.cfg.num_ws, 32).astype(
                np.float32))
            img = gt.synthesis(pt, w, c)["image"].clamp(-1, 1)
        np.save(imgs / f"{name}.npy", img[0].numpy())
    return imgs


def _spy(monkeypatch):
    calls = []
    for cls, name in ((Projector, "project_batch"),
                      (PTICoach, "tune_batch")):
        real = getattr(cls, name)

        def wrapped(self, *a, real=real, name=name, **kw):
            calls.append((name, a[0].shape[0] if name == "project_batch"
                          else a[1].shape[0]))
            return real(self, *a, **kw)
        monkeypatch.setattr(cls, name, wrapped)
    return calls


def test_run_pti_batch_with_a_ragged_chunk(setup, tmp_path, monkeypatch):
    gt, pt = setup["gt"], setup["pt"]
    imgs = _images(tmp_path, gt, pt)
    out = tmp_path / "out"
    calls = _spy(monkeypatch)
    renders = []
    real_syn = gt.synthesis

    def count(params, ws, c, **kw):
        renders.append(ws.shape[0])
        return real_syn(params, ws, c, **kw)
    monkeypatch.setattr(gt, "synthesis", count)
    pose, vgg, head = tiny_aux_nets(3)
    kw = dict(G=gt, gen_params=pt, pose_params=pose, vgg_params=vgg,
              lpips_head=head, first_inv_steps=3, max_pti_steps=2,
              gen_video=False, batch=2, device="cpu")
    res = app.run_pti(str(imgs), str(out), **kw)
    assert [r["image"] for r in res] == list(NAMES)
    assert json.loads((out / "results.json").read_text()) == res
    for r in res:
        # The full budget, or stopped by the 0.06 LPIPS threshold.
        assert np.isfinite(r["final_lpips"])
        assert r["pti_steps"] == 2 or (r["pti_steps"] < 2
                                       and r["final_lpips"] <= 0.06)
        assert r["sec"] > 0
    for name in NAMES:
        ws = np.load(out / f"{name}_ws.npy")
        cam = np.load(out / f"{name}_cam.npy")
        assert ws.shape == (1, gt.cfg.num_ws, 32) and cam.shape == (1, 25)
        assert np.isfinite(ws).all() and np.isfinite(cam).all()
        assert (out / f"{name}_G.pt").stat().st_size > 0
    assert calls == [("project_batch", 2), ("tune_batch", 2),
                     ("project_batch", 1), ("tune_batch", 1)]
    # Stage 1 renders both views of a chunk in one call a step (3 steps),
    # stage 2 the chunk in one call a step (2 steps, remat recomputing
    # the render in the backward pass adds one more each).
    assert renders[:2 * 3] == [2] * 6
    # Saved pivots: reused when every image of a chunk has them.
    saved = {n: np.load(out / f"{n}_ws.npy") for n in NAMES}
    os.remove(out / "c_ws.npy")
    del calls[:]
    app.run_pti(str(imgs), str(out), use_last_w_pivots=True, **kw)
    assert calls == [("tune_batch", 2), ("project_batch", 1),
                     ("tune_batch", 1)]
    for n in ("a", "b"):
        np.testing.assert_array_equal(np.load(out / f"{n}_ws.npy"),
                                      saved[n])
    assert (out / "c_ws.npy").exists()


def test_run_pti_cli_batch(setup, tmp_path, capsys, monkeypatch):
    pytest.importorskip("click")
    gt, pt = setup["gt"], setup["pt"]
    imgs = _images(tmp_path, gt, pt)
    out = tmp_path / "out"
    net = tmp_path / "G.pt"
    save_checkpoint(str(net), pt, config=gt.cfg)
    pose, vgg, head = tiny_aux_nets(4)
    pose_f, vgg_f = tmp_path / "pose.pt", tmp_path / "vgg.pt"
    vgg_sd = {".".join(p): t for p, t in leaves_with_paths(vgg)}
    vgg_sd.update({f"lin{i}.model.1.weight": head[f"lin{i}"]["weight"]
                   .reshape(-1, 1, 1, 1) for i in range(5)})
    torch.save({".".join(p): t for p, t in leaves_with_paths(pose)}, pose_f)
    torch.save({"state_dict": vgg_sd}, vgg_f)
    check_aux_at_tiny_scale(monkeypatch)
    with pytest.raises(SystemExit) as e:
        app.main(["--network", str(net), "--images", str(imgs), "--outdir",
                  str(out), "--pose-weights", str(pose_f), "--vgg-weights",
                  str(vgg_f), "--allow-random-init", "--lpips-type", "vgg",
                  "--first-inv-steps", "2", "--max-pti-steps", "1",
                  "--no-video", "--batch", "2", "--device", "cpu"])
    assert e.value.code == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [r["image"] for r in lines] == list(NAMES)
    assert all(r["pti_steps"] == 1 or r["final_lpips"] <= 0.06
               for r in lines)
    assert all((out / f"{n}_ws.npy").exists() for n in NAMES)
    with pytest.raises(ValueError, match="batch=1"):
        app.main(["--network", str(net), "--images", str(imgs), "--outdir",
                  str(out), "--allow-random-init", "--visualize-opt",
                  "--batch", "2", "--no-video", "--device", "cpu"])
