"""tgi_torch's ``run_pti`` without saved pivots, on the CPU: stage 1 then
stage 2 on a synthetic PNG, through the function and the command line,
at the tiny config (plane C = 8, 32² backbone, 16² rays, 8 + 8 samples,
SuperresolutionTiny, 64² images) with small stage-1 networks
(``width_mult`` 1/8). The projector itself is held against tgi's in
``test_torch_projector.py``; here the app's contract: the pivots
``{name}_ws.npy`` and ``{name}_cam.npy`` written in tgi's format, stage 2
tuned around them, weight files read through the converters, and the
part not ported yet (batched inversion) refused."""

import json

import numpy as np
import pytest
import torch

from tgi_torch.apps import run_pti as app
from tgi_torch.invert.coach import PTICoach
from tgi_torch.io.checkpoints import save_checkpoint
from tgi_torch.models.generator import (GeneratorConfig, TriPlaneGenerator,
                                        default_rendering_kwargs)

from torch_helpers import (TINY, TINY_RK, check_aux_at_tiny_scale,
                           leaves_with_paths, tiny_aux_nets, tiny_camera)


@pytest.fixture(scope="module")
def setup():
    gt = TriPlaneGenerator(GeneratorConfig(
        rendering_kwargs=default_rendering_kwargs(**TINY_RK), **TINY))
    return {"gt": gt,
            "pt": gt.init(torch.Generator().manual_seed(0), device="cpu")}


def _target(tmp_path, gt, pt):
    """A target PNG rendered from another w at yaw 0.3; no pivots."""
    pytest.importorskip("PIL")
    from tgi_torch.utils.image import save_image
    rng = np.random.RandomState(41)
    with torch.no_grad():
        w = torch.from_numpy(rng.randn(1, gt.cfg.num_ws, 32).astype(
            np.float32))
        img = gt.synthesis(pt, w, torch.from_numpy(tiny_camera(0.3)))["image"]
    imgs, out = tmp_path / "images", tmp_path / "out"
    imgs.mkdir()
    save_image(str(imgs / "face.png"), img.clamp(-1, 1))
    return imgs, out


def _check_pivots(out, gt):
    ws = np.load(out / "face_ws.npy")
    cam = np.load(out / "face_cam.npy")
    assert ws.shape == (1, gt.cfg.num_ws, 32) and ws.dtype == np.float32
    assert (ws == ws[:, :1]).all()          # one w tiled to every layer
    assert cam.shape == (1, 25) and np.isfinite(cam).all()
    ext = cam[0, :16].reshape(4, 4)
    np.testing.assert_allclose(np.linalg.norm(ext[:3, 3]), 2.7, rtol=1e-5)
    # A random pose head saturates its tanh, so the 6d mode's two
    # vectors are nearly parallel and Gram-Schmidt loses digits.
    np.testing.assert_allclose(ext[:3, :3] @ ext[:3, :3].T, np.eye(3),
                               atol=1e-3)
    return ws, cam


def test_run_pti_runs_stage1_then_stage2(setup, tmp_path, monkeypatch):
    gt, pt = setup["gt"], setup["pt"]
    imgs, out = _target(tmp_path, gt, pt)
    tuned_around = []
    real_tune = PTICoach.tune

    def spy(self, params, ws, cam, *args, **kw):
        tuned_around.append((ws.numpy().copy(), cam.numpy().copy()))
        return real_tune(self, params, ws, cam, *args, **kw)

    monkeypatch.setattr(PTICoach, "tune", spy)
    pose, vgg, head = tiny_aux_nets(1)
    res = app.run_pti(str(imgs), str(out), G=gt, gen_params=pt,
                      pose_params=pose, vgg_params=vgg, lpips_head=head,
                      first_inv_steps=3, max_pti_steps=2, device="cpu")
    assert [r["image"] for r in res] == ["face"]
    assert res[0]["pti_steps"] == 2 and np.isfinite(res[0]["final_lpips"])
    assert json.loads((out / "results.json").read_text()) == res
    ws, cam = _check_pivots(out, gt)
    # Stage 2 tuned around the pivots stage 1 wrote.
    assert len(tuned_around) == 1
    np.testing.assert_array_equal(tuned_around[0][0], ws)
    np.testing.assert_array_equal(tuned_around[0][1], cam)
    for f in ("face.png", "face_pivot.png", "face_G.pt"):
        assert (out / f).stat().st_size > 0
    # The caller's weights are untouched.
    assert torch.equal(pose["bn1"]["running_mean"],
                       torch.zeros_like(pose["bn1"]["running_mean"]))


@pytest.mark.parametrize("mode,dims", [("2d", 2), ("6d", 6)])
def test_run_pti_stage1_camera_modes(setup, tmp_path, mode, dims):
    gt, pt = setup["gt"], setup["pt"]
    imgs, out = _target(tmp_path, gt, pt)
    pose, vgg, head = tiny_aux_nets(2, camera_dims=dims)
    app.run_pti(str(imgs), str(out), G=gt, gen_params=pt, pose_params=pose,
                vgg_params=vgg, lpips_head=head, camera_mode=mode,
                first_inv_steps=1, max_pti_steps=1, device="cpu")
    _check_pivots(out, gt)


def _state_dict(tree):
    return {".".join(p): t for p, t in leaves_with_paths(tree)}


def test_run_pti_cli_without_pivots(setup, tmp_path, capsys, monkeypatch):
    """The CLI reads the pose net and VGG (with its LPIPS head) from
    torch state dicts, checks them against their inits' trees at the
    small nets' scale, runs stage 1 and stage 2, and writes the pivots."""
    pytest.importorskip("click")
    check_aux_at_tiny_scale(monkeypatch)
    gt, pt = setup["gt"], setup["pt"]
    imgs, out = _target(tmp_path, gt, pt)
    net = tmp_path / "G.pt"
    save_checkpoint(str(net), pt, config=gt.cfg)
    pose, vgg, head = tiny_aux_nets(3)
    vgg_sd = _state_dict(vgg)
    vgg_sd.update({f"lin{i}.model.1.weight": head[f"lin{i}"]["weight"]
                   .reshape(-1, 1, 1, 1) for i in range(5)})
    torch.save(_state_dict(pose), tmp_path / "pose.pt")
    torch.save({"state_dict": vgg_sd}, tmp_path / "vgg.pt")
    with pytest.raises(SystemExit) as e:
        app.main(["--network", str(net), "--images", str(imgs), "--outdir",
                  str(out), "--pose-weights", str(tmp_path / "pose.pt"),
                  "--vgg-weights", str(tmp_path / "vgg.pt"),
                  "--allow-random-init", "--camera-mode", "quat",
                  "--first-inv-steps", "2", "--max-pti-steps", "1",
                  "--seed", "4", "--device", "cpu"])
    assert e.value.code == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])[
        "pti_steps"] == 1
    _check_pivots(out, gt)


def test_run_pti_cli_refuses_a_missing_weight_file(setup, tmp_path):
    pytest.importorskip("click")
    net = tmp_path / "G.pt"
    save_checkpoint(str(net), setup["pt"], config=setup["gt"].cfg)
    args = ["--network", str(net), "--images", str(tmp_path), "--outdir",
            str(tmp_path / "out"), "--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        app.main(args + ["--pose-weights", str(tmp_path / "none.pt")])
    assert e.value.code != 0
    with pytest.raises(SystemExit) as e:     # absent, and no random init
        app.main(args)
    assert e.value.code != 0
    with pytest.raises(SystemExit) as e:     # a missing e4e file
        app.main(args + ["--allow-random-init", "--e4e-weights",
                         str(tmp_path / "none.pt")])
    assert e.value.code != 0
    with pytest.raises(ValueError, match="e4e encoder"):  # a wrong one
        app.main(args + ["--allow-random-init", "--e4e-weights", str(net)])


@pytest.mark.parametrize("kw,item", [({"visualize_opt": True}, "item 7"),
                                     ({"batch": 2}, "item 18")])
def test_run_pti_refuses_stage1_parts_not_ported(setup, tmp_path, kw, item):
    """Stage 1's snapshots (item 7) and batched inversion (item 18) are
    both ported now and accepted on an empty directory."""
    assert app.run_pti(str(tmp_path), str(tmp_path), G=setup["gt"],
                       gen_params=setup["pt"], device="cpu", **kw) == []


def test_invert_one_needs_a_projector_without_pivots(setup, tmp_path):
    img = torch.zeros(1, 3, 64, 64)
    with pytest.raises(ValueError, match="stage 1 needs"):
        app.invert_one("face", img, G=setup["gt"], gen_params=setup["pt"],
                       coach=None, out_dir=str(tmp_path))


def test_run_pti_help_lists_the_stage1_options(capsys):
    pytest.importorskip("click")
    with pytest.raises(SystemExit) as e:
        app.main(["--help"])
    assert e.value.code == 0
    text = capsys.readouterr().out
    for opt in ("--pose-weights", "--vgg-weights", "--camera-mode",
                "--first-inv-steps", "--seed"):
        assert opt in text
