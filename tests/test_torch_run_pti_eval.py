"""``run_pti``'s e4e start and ``--eval`` on the CPU, at the tiny generator
(64² renders, w_dim 32) with small stage-1 nets (``width_mult`` 1/8) and
small face nets (e4e and ArcFace at depth 50, channels / 16, so e4e's
codes are 32 wide):

* ``evaluate_reconstruction`` against tgi's (MSE, LPIPS, MS-SSIM, ID
  similarity), 1e-4 relative;
* the command line with ``--e4e-weights`` (an e4e full dump, the
  official repo's layout) ``--arcface-weights --eval``: the weight files
  checked against the nets' trees (at the small nets' scale, as
  ``torch_helpers.check_aux_at_tiny_scale`` does for the stage-1 nets),
  stage 1 started from the encoder's code for the 256² [0, 255] target,
  and each image's metrics in ``results.json`` and ``{name}metrics.txt``;
* ``.npy`` images, which ``run_pti`` reads where Pillow is absent."""

import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tgi.apps.run_pti import evaluate_reconstruction as jevaluate
from tgi.losses.lpips import LPIPSLoss as JLPIPSLoss
from tgi_torch.apps import run_pti as app
from tgi_torch.io.checkpoints import save_checkpoint
from tgi_torch.losses.lpips import LPIPSLoss
from tgi_torch.models import arcface, e4e
from tgi_torch.models.generator import (GeneratorConfig, TriPlaneGenerator,
                                        default_rendering_kwargs)
from tgi_torch.utils.image import load_image

from torch_helpers import (TINY, TINY_AUX, TINY_RK, leaves_with_paths,
                           tiny_aux_nets, tiny_camera)

FACE_WIDTH = 1 / 16


def _j(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), tree)


def _state_dict(tree):
    return {".".join(p): t for p, t in leaves_with_paths(tree)}


@pytest.fixture(scope="module")
def setup():
    gt = TriPlaneGenerator(GeneratorConfig(
        rendering_kwargs=default_rendering_kwargs(**TINY_RK), **TINY))
    gen = torch.Generator().manual_seed(91)
    enc = e4e.e4e_init(gen, device="cpu", width_mult=FACE_WIDTH)
    # A random IR-SE trunk's activations grow to ~1e6; scale the first
    # code's linear so the encoder's start lies within ~0.1 of w_avg, as
    # a trained encoder's does.
    with torch.no_grad():
        w0 = e4e.e4e_encode_w0(enc, torch.full((1, 3, 256, 256), 128.0))
    enc["styles"]["0"]["linear"]["weight"] *= 0.1 / float(w0.abs().max())
    return {"gt": gt, "pt": gt.init(gen, device="cpu"), "e4e": enc,
            "arc": arcface.arcface_init(gen, device="cpu",
                                        width_mult=FACE_WIDTH)}


def test_evaluate_reconstruction_matches_tgi(setup):
    rng = np.random.RandomState(92)
    a = rng.uniform(-1, 1, (1, 3, 256, 256)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.randn(*a.shape), -1, 1).astype(np.float32)
    _, v, head = tiny_aux_nets(93)
    got = app.evaluate_reconstruction(torch.from_numpy(a),
                                      torch.from_numpy(b),
                                      LPIPSLoss(v, head), setup["arc"])
    want = jevaluate(jnp.asarray(a), jnp.asarray(b),
                     JLPIPSLoss(_j(v), _j(head)), _j(setup["arc"]))
    assert got.keys() == want.keys() == {"mse", "lpips", "ms_ssim",
                                         "id_similarity"}
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-4 * max(abs(want[k]), 1e-3), k
    no_id = app.evaluate_reconstruction(torch.from_numpy(a),
                                        torch.from_numpy(b),
                                        LPIPSLoss(v, head), None)
    assert "id_similarity" not in no_id


def _target(tmp_path, gt, pt, suffix):
    rng = np.random.RandomState(94)
    with torch.no_grad():
        w = torch.from_numpy(0.5 * rng.randn(1, gt.cfg.num_ws, 32).astype(
            np.float32))
        img = gt.synthesis(pt, w, torch.from_numpy(tiny_camera(0.3)))[
            "image"].clamp(-1, 1)
    imgs = tmp_path / "images"
    imgs.mkdir()
    if suffix == ".npy":
        np.save(imgs / "face.npy", img[0].numpy())
    else:
        pytest.importorskip("PIL")
        from tgi_torch.utils.image import save_image
        save_image(str(imgs / "face.png"), img)
    return imgs, tmp_path / "out", img


def test_run_pti_cli_e4e_arcface_eval(setup, tmp_path, capsys, monkeypatch):
    pytest.importorskip("click")
    monkeypatch.setattr(app, "validate_aux", functools.partial(
        app.validate_aux, face_width_mult=FACE_WIDTH, **TINY_AUX))
    seen = []
    real_encode = e4e.e4e_encode_w0

    def spy(params, x, *a, **kw):
        out = real_encode(params, x, *a, **kw)
        seen.append((x.shape, float(x.max()), out))
        return out

    monkeypatch.setattr(e4e, "e4e_encode_w0", spy)
    gt, pt = setup["gt"], setup["pt"]
    imgs, out, _ = _target(tmp_path, gt, pt, ".png")
    net = tmp_path / "G.pt"
    save_checkpoint(str(net), pt, config=gt.cfg)
    pose, vgg, head = tiny_aux_nets(95)
    vgg_sd = _state_dict(vgg)
    vgg_sd.update({f"lin{i}.model.1.weight": head[f"lin{i}"]["weight"]
                   .reshape(-1, 1, 1, 1) for i in range(5)})
    torch.save(_state_dict(pose), tmp_path / "pose.pt")
    torch.save({"state_dict": vgg_sd}, tmp_path / "vgg.pt")
    enc = _state_dict(setup["e4e"])
    torch.save({"state_dict": {f"encoder.{k}": v for k, v in enc.items()},
                "latent_avg": torch.zeros(18, 32),
                "opts": {"encoder_type": "Encoder4Editing"}},
               tmp_path / "e4e.pt")
    torch.save(_state_dict(setup["arc"]), tmp_path / "arcface.pt")
    with pytest.raises(SystemExit) as e:
        app.main(["--network", str(net), "--images", str(imgs), "--outdir",
                  str(out), "--pose-weights", str(tmp_path / "pose.pt"),
                  "--vgg-weights", str(tmp_path / "vgg.pt"),
                  "--e4e-weights", str(tmp_path / "e4e.pt"),
                  "--arcface-weights", str(tmp_path / "arcface.pt"),
                  "--eval", "--allow-random-init", "--lpips-type", "vgg",
                  "--first-inv-steps", "2", "--max-pti-steps", "1",
                  "--device", "cpu"])
    assert e.value.code == 0
    entry = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert entry == json.loads((out / "results.json").read_text())[0]
    assert entry == json.loads((out / "facemetrics.txt").read_text())
    for k in ("mse", "lpips", "ms_ssim", "id_similarity", "final_lpips"):
        assert np.isfinite(entry[k]), k
    assert 0 <= entry["ms_ssim"] <= 1 and -1 <= entry["id_similarity"] <= 1
    # Stage 1 started from the encoder's code for the [0, 255] 256²
    # target: the encoder ran once, on it.
    assert len(seen) == 1
    assert seen[0][0] == (1, 3, 256, 256) and seen[0][1] > 2.0
    # The ArcFace file at the wrong scale is refused.
    monkeypatch.setattr(app, "validate_aux", functools.partial(
        app.validate_aux.func, **TINY_AUX))
    with pytest.raises(ValueError, match="arcface"):
        app.main(["--network", str(net), "--images", str(imgs), "--outdir",
                  str(out), "--allow-random-init", "--arcface-weights",
                  str(tmp_path / "arcface.pt"), "--device", "cpu"])


def test_run_pti_reads_npy_images_and_evaluates(setup, tmp_path):
    """A ``.npy`` target (no Pillow needed) through both stages with the
    e4e start; the 256² target is its antialiased bilinear enlargement."""
    gt, pt = setup["gt"], setup["pt"]
    imgs, out, img = _target(tmp_path, gt, pt, ".npy")
    arr = load_image(str(imgs / "face.npy"), size=64)
    np.testing.assert_array_equal(arr, img.numpy())
    t255 = load_image(str(imgs / "face.npy"), size=256, to_range=(0, 255))
    assert t255.shape == (1, 3, 256, 256)
    pose, vgg, head = tiny_aux_nets(96)
    res = app.run_pti(str(imgs), str(out), G=gt, gen_params=pt,
                      pose_params=pose, vgg_params=vgg, lpips_head=head,
                      e4e_params=setup["e4e"], do_evaluation=True,
                      lpips_type="vgg", first_inv_steps=1, max_pti_steps=1,
                      device="cpu")
    assert [r["image"] for r in res] == ["face"]
    assert {"mse", "lpips", "ms_ssim"} <= res[0].keys()
    assert all(np.isfinite(res[0][k]) for k in ("mse", "lpips", "ms_ssim"))
    assert "id_similarity" not in res[0]
    assert json.loads((out / "facemetrics.txt").read_text()) == res[0]
