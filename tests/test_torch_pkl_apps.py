"""``run_pti`` and ``gen_samples`` from a reference ``.pkl``, on the CPU,
through their command lines: the pickle is written by
``chip_smoke.reference_pickle`` from the tiny pair's weights (plane C = 8,
32² backbone, SuperresolutionTiny, 64² images). A ``.pkl`` runs in
``tgi``'s mixed precision: the generator comes back with
``fused_dtype="bfloat16"``, stage 1 renders in float32 and stage 2 in the
bf16 blocks (their numbers are held against tgi's in
``test_torch_bf16.py``); here the apps' contract."""

import json

import numpy as np
import pytest
import torch

from tgi_torch.apps import gen_samples
from tgi_torch.apps import run_pti as app
from tgi_torch.invert.coach import PTICoach

import chip_smoke
from torch_helpers import (TINY_AUX, check_aux_at_tiny_scale,
                           leaves_with_paths, tiny_aux_nets, tiny_camera)


@pytest.fixture(scope="module")
def tiny_pkl(tmp_path_factory):
    from tgi_torch.models.generator import (GeneratorConfig,
                                            TriPlaneGenerator,
                                            default_rendering_kwargs)
    from torch_helpers import TINY, TINY_RK
    gt = TriPlaneGenerator(GeneratorConfig(
        rendering_kwargs=default_rendering_kwargs(**TINY_RK), **TINY))
    pt = gt.init(torch.Generator().manual_seed(0), device="cpu")
    path = tmp_path_factory.mktemp("pkl") / "tiny.pkl"
    path.write_bytes(chip_smoke.reference_pickle(gt.cfg, pt))
    return {"path": str(path), "gt": gt, "pt": pt}


def test_load_any_generator_reads_a_pkl_in_bf16(tiny_pkl):
    G, params = app.load_any_generator(tiny_pkl["path"], device="cpu")
    assert G.cfg.fused_dtype == "bfloat16" and G.cfg.sr_num_fp16_res == 4
    assert G.cfg.plane_dtype == "float32"
    src = dict(leaves_with_paths(tiny_pkl["pt"]))
    assert all(torch.equal(t, src[p]) for p, t in leaves_with_paths(params))
    G32, _ = app.load_any_generator(tiny_pkl["path"],
                                    fused_dtype="float32", device="cpu")
    assert G32.cfg == tiny_pkl["gt"].cfg


def _state_dict(tree):
    return {".".join(p): t for p, t in leaves_with_paths(tree)}


def test_run_pti_cli_from_a_pkl(tiny_pkl, tmp_path, capsys, monkeypatch):
    """``--network tiny.pkl``: one stage-1 step, rendered in float32, and
    one stage-2 step, rendered in bf16; the pivots and the tuned
    generator are written."""
    pytest.importorskip("click")
    pytest.importorskip("PIL")
    from tgi_torch.utils.image import save_image
    gt, pt = tiny_pkl["gt"], tiny_pkl["pt"]
    imgs, out = tmp_path / "images", tmp_path / "out"
    imgs.mkdir()
    with torch.no_grad():
        w = torch.from_numpy(np.random.RandomState(41).randn(
            1, gt.cfg.num_ws, 32).astype(np.float32))
        img = gt.synthesis(pt, w, torch.from_numpy(tiny_camera(0.3)))["image"]
    save_image(str(imgs / "face.png"), img.clamp(-1, 1))
    pose, vgg, head = tiny_aux_nets(3)
    vgg_sd = _state_dict(vgg)
    vgg_sd.update({f"lin{i}.model.1.weight": head[f"lin{i}"]["weight"]
                   .reshape(-1, 1, 1, 1) for i in range(5)})
    torch.save(_state_dict(pose), tmp_path / "pose.pt")
    torch.save({"state_dict": vgg_sd}, tmp_path / "vgg.pt")

    seen = {}
    real_synthesis = type(gt).synthesis

    def synthesis(self, *args, force_fp32=False, **kw):
        seen.setdefault(force_fp32, 0)
        seen[force_fp32] += 1
        assert self.cfg.fused_dtype == "bfloat16"
        return real_synthesis(self, *args, force_fp32=force_fp32, **kw)

    monkeypatch.setattr(type(gt), "synthesis", synthesis)
    tuned_dtypes = []
    real_tune = PTICoach.tune

    def tune(self, params, *args, **kw):
        out = real_tune(self, params, *args, **kw)
        tuned_dtypes.extend({t.dtype for _, t in leaves_with_paths(out[0])})
        return out

    monkeypatch.setattr(PTICoach, "tune", tune)
    check_aux_at_tiny_scale(monkeypatch)
    with pytest.raises(SystemExit) as e:
        app.main(["--network", tiny_pkl["path"], "--images", str(imgs),
                  "--outdir", str(out), "--pose-weights",
                  str(tmp_path / "pose.pt"), "--vgg-weights",
                  str(tmp_path / "vgg.pt"), "--allow-random-init",
                  "--first-inv-steps", "1", "--max-pti-steps", "1",
                  "--device", "cpu"])
    assert e.value.code == 0
    entry = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert entry["pti_steps"] == 1
    # Stage 1: two float32 renders; stage 2, the two PNG renders and the
    # two orbit videos (on by default: 15 renders of 4 frames each): bf16.
    assert seen == {True: 2, False: 3 + 2 * 15}
    assert tuned_dtypes == [torch.float32]
    ws, cam = np.load(out / "face_ws.npy"), np.load(out / "face_cam.npy")
    assert ws.shape == (1, gt.cfg.num_ws, 32) and cam.shape == (1, 25)
    assert np.isfinite(ws).all() and np.isfinite(cam).all()
    saved = torch.load(out / "face_G.pt", weights_only=True)
    assert json.loads(saved["config_json"])["fused_dtype"] == "bfloat16"


def test_run_pti_cli_validates_weight_files(tiny_pkl, tmp_path,
                                            monkeypatch):
    """The weight files are checked against their inits' trees before
    anything runs: at full width, so the small pose net is refused as it
    is in tgi; and, checked at its own scale, a pose-net file of the
    wrong layout is refused too."""
    pytest.importorskip("click")
    pose, _, _ = tiny_aux_nets(3)
    sd = _state_dict(pose)
    torch.save(sd, tmp_path / "pose.pt")
    argv = ["--network", tiny_pkl["path"], "--images", str(tmp_path),
            "--outdir", str(tmp_path / "out"), "--pose-weights",
            str(tmp_path / "pose.pt"), "--allow-random-init",
            "--device", "cpu"]
    with pytest.raises(ValueError, match="(?s)pose estimator.*missing"):
        app.main(argv)
    del sd["layer2.0.bn1.running_var"]
    torch.save(sd, tmp_path / "pose.pt")
    check_aux_at_tiny_scale(monkeypatch)
    with pytest.raises(ValueError, match="(?s)pose estimator.*missing 1 "):
        app.main(argv)


def test_validate_aux_holds_nets_to_full_width():
    """Full width by default, as tgi checks: the small nets fail there
    and pass at their own scale; a pose head of another size and a VGG
    layer of another shape fail at any scale."""
    pose, vgg, head = tiny_aux_nets(3)
    for kw in (dict(pose_params=pose), dict(vgg_params=vgg),
               dict(lpips_head=head)):
        with pytest.raises(ValueError):
            app.validate_aux(**kw)
    app.validate_aux(pose, vgg, head, camera_dims=4, **TINY_AUX)
    with pytest.raises(ValueError, match="pose estimator"):
        app.validate_aux(pose, camera_dims=6, **TINY_AUX)  # another head
    bad = {"features": dict(vgg["features"])}
    bad["features"]["2"] = {"weight": torch.zeros(8, 9, 3, 3),
                            "bias": torch.zeros(8)}
    with pytest.raises(ValueError, match="(?s)vgg16.*shape mismatches"):
        app.validate_aux(vgg_params=bad, **TINY_AUX)


def test_gen_samples_cli_from_a_pkl(tiny_pkl, tmp_path, capsys):
    """``gen_samples --network tiny.pkl`` renders in bf16 and writes a
    PNG per seed and angle."""
    pytest.importorskip("click")
    pytest.importorskip("PIL")
    with pytest.raises(SystemExit) as e:
        gen_samples.main(["--network", tiny_pkl["path"], "--seeds", "0-1",
                          "--outdir", str(tmp_path), "--device", "cpu"])
    assert e.value.code == 0
    paths = capsys.readouterr().out.split()
    assert len(paths) == 6
    for p in paths:
        assert p.startswith(str(tmp_path)) and p.endswith(".png")
    from PIL import Image
    with Image.open(paths[0]) as im:
        assert im.size == (64, 64)
