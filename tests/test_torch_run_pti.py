"""tgi_torch's stage-2 ``run_pti`` app, its command line and the port's
checkpoints, on the CPU at the tiny config (plane C = 8, 32² backbone,
16² rays, 8 + 8 samples, SuperresolutionTiny, 64² images). The coach it
drives is held against tgi's in ``test_torch_coach.py``; here the app's
own contract: pivots in (or stage 1 without them), ``{name}_G.pt``,
PNGs, orbit videos and ``results.json`` out, batched or one image at a
time (``test_torch_run_pti_batch.py`` runs a batch).
"""

import json
import os

import numpy as np
import pytest
import torch

from tgi_torch.apps import run_pti as app
from tgi_torch.io.checkpoints import load_checkpoint, save_checkpoint
from tgi_torch.models.generator import (GeneratorConfig, TriPlaneGenerator,
                                        default_rendering_kwargs)
from tgi_torch.render.cameras import (fov_to_intrinsics, look_at_pose,
                                      pack_camera)

from torch_helpers import TINY, TINY_RK, leaves_with_paths, tiny_aux_nets


@pytest.fixture(scope="module")
def setup():
    gt = TriPlaneGenerator(GeneratorConfig(
        rendering_kwargs=default_rendering_kwargs(**TINY_RK), **TINY))
    return {"gt": gt,
            "pt": gt.init(torch.Generator().manual_seed(0), device="cpu")}


def _camera(yaw):
    cam = look_at_pose(np.pi / 2 + yaw, np.pi / 2, torch.tensor([0, 0, 0.2]),
                       radius=2.7, device="cpu")
    return pack_camera(cam[None], fov_to_intrinsics(18.837, device="cpu"))


def _write_target(tmp_path, gt, pt, name="face"):
    """A target image rendered from another w, and the saved pivot."""
    pytest.importorskip("PIL")
    from tgi_torch.utils.image import save_image
    rng = np.random.RandomState(12)
    cam = _camera(0.3)
    with torch.no_grad():
        w_t = torch.from_numpy(rng.randn(1, gt.cfg.num_ws, 32).astype(
            np.float32))
        target = gt.synthesis(pt, w_t, cam)["image"]
    imgs = tmp_path / "images"
    out = tmp_path / "out"
    imgs.mkdir()
    out.mkdir()
    save_image(str(imgs / f"{name}.png"), target.clamp(-1, 1))
    ws = (0.5 * rng.randn(1, gt.cfg.num_ws, 32)).astype(np.float32)
    np.save(out / f"{name}_ws.npy", ws)
    np.save(out / f"{name}_cam.npy", cam.numpy())
    return imgs, out


def test_run_pti_stage2_from_saved_pivots(setup, tmp_path):
    gt, pt = setup["gt"], setup["pt"]
    imgs, out = _write_target(tmp_path, gt, pt)
    res = app.run_pti(str(imgs), str(out), G=gt, gen_params=pt,
                      max_pti_steps=2, use_last_w_pivots=True, device="cpu")
    assert [r["image"] for r in res] == ["face"]
    assert res[0]["pti_steps"] == 2 and np.isfinite(res[0]["final_lpips"])
    assert json.loads((out / "results.json").read_text()) == res
    for f in ("face.png", "face_pivot.png", "face_G.pt"):
        assert (out / f).stat().st_size > 0
    data = load_checkpoint(str(out / "face_G.pt"))
    assert data["config"]["plane_channels"] == 8
    assert not all(torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves_with_paths(data["params"]), leaves_with_paths(pt)))
    # Without pivots (or without asking for them) stage 1 runs and
    # writes new ones (``test_torch_run_pti_stage1.py`` checks them).
    pose, vgg, head = tiny_aux_nets()
    saved = np.load(out / "face_ws.npy")
    stage1 = dict(G=gt, gen_params=pt, pose_params=pose, vgg_params=vgg,
                  lpips_head=head, first_inv_steps=1, max_pti_steps=1,
                  device="cpu")
    app.run_pti(str(imgs), str(out), **stage1)
    assert not np.array_equal(np.load(out / "face_ws.npy"), saved)
    os.remove(out / "face_ws.npy")
    app.run_pti(str(imgs), str(out), use_last_w_pivots=True, **stage1)
    assert np.load(out / "face_ws.npy").shape == saved.shape


@pytest.mark.parametrize("flag", ["gen_video", "gen_mesh", "visualize_opt",
                                  "use_locality_reg", "tensorboard",
                                  "use_wandb"])
def test_run_pti_refuses_what_is_not_ported(setup, tmp_path, flag):
    """Each of these outputs is ported and accepted, one image at a time
    and in batches; only ``visualize_opt`` needs a batch of 1 (its
    snapshots are per image) and raises ``ValueError`` with a batch, as
    tgi's run_pti does."""
    assert app.run_pti(str(tmp_path), str(tmp_path / "out"), G=setup["gt"],
                       gen_params=setup["pt"], device="cpu",
                       **{flag: True}) == []
    assert json.loads((tmp_path / "out" / "results.json").read_text()) == []
    batched = dict(G=setup["gt"], gen_params=setup["pt"], device="cpu",
                   batch=2, **{flag: True})
    if flag == "visualize_opt":
        with pytest.raises(ValueError, match="batch=1"):
            app.run_pti(str(tmp_path), str(tmp_path / "b"), **batched)
    else:
        assert app.run_pti(str(tmp_path), str(tmp_path / "b"),
                           **batched) == []
        assert json.loads((tmp_path / "b" / "results.json")
                          .read_text()) == []


def test_run_pti_cli(setup, tmp_path, capsys):
    pytest.importorskip("click")
    gt, pt = setup["gt"], setup["pt"]
    imgs, out = _write_target(tmp_path, gt, pt)
    net = tmp_path / "G.pt"
    save_checkpoint(str(net), pt, config=gt.cfg)
    with pytest.raises(SystemExit) as e:
        app.main(["--network", str(net), "--images", str(imgs), "--outdir",
                  str(out), "--use-last-w-pivots", "--allow-random-init",
                  "--max-pti-steps", "1", "--device", "cpu"])
    assert e.value.code == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])[
        "pti_steps"] == 1
    assert (out / "face_G.pt").exists()


def test_run_pti_cli_help(capsys):
    pytest.importorskip("click")
    with pytest.raises(SystemExit) as e:
        app.main(["--help"])
    assert e.value.code == 0
    assert "--use-last-w-pivots" in capsys.readouterr().out


def test_checkpoint_round_trip(setup, tmp_path):
    gt, pt = setup["gt"], setup["pt"]
    path = str(tmp_path / "g.pt")
    save_checkpoint(path, pt, config=gt.cfg, metadata={"step": 3})
    data = load_checkpoint(path)
    assert data["metadata"] == {"step": 3}
    assert data["config"]["rendering_kwargs"]["depth_resolution"] == 8
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves_with_paths(data["params"]), leaves_with_paths(pt)))
    G, params = app.load_any_generator(path, device="cpu")
    assert G.cfg == gt.cfg       # a .pt keeps its stored config (fp32)
    # A .pkl goes to the reference-pickle reader
    # (tests/test_torch_pickle_import.py, tests/test_torch_pkl_apps.py).
    with pytest.raises(FileNotFoundError):
        app.load_any_generator(str(tmp_path / "g.pkl"), device="cpu")
