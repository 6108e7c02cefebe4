"""The batched self-inversion gate (``self_inversion_eval_batch``) on the
CPU at the tiny generator (64² renders) with small stage-1 nets
(``width_mult`` 1/8, one block per pose-net stage), end to end at B = 4
(the four ``_BATCH_POSE_OFFSETS`` cameras): per-image metrics that are
finite, each image's aimed pose net 3 degrees off its truth, every image
tuned the full budget; and image 0 equal to ``self_inversion_eval`` on
the same seed, whose target, camera and draws it shares.

Tolerances: image 0 against the one-image gate, 1e-4 relative on the
stage-1 results (the pose error and w's error) and on the tuned images'
MSE, LPIPS and MS-SSIM: the batched and one-image steps differ only in
how the grouped convs and the batched matmuls sum (``test_torch_project_
batch.py`` and ``test_torch_tune_batch.py`` hold them step by step).
"""

import numpy as np
import pytest

from tgi_torch.invert import selfinv
from tgi_torch.invert import self_inversion_eval, self_inversion_eval_batch
from tgi_torch.losses.lpips import LPIPSLoss

from torch_helpers import tiny_aux_nets, tiny_pair

KW = dict(first_inv_steps=6, max_pti_steps=4, w_avg_samples=16,
          proj_overrides={"cam_preheat_steps": 2})


@pytest.fixture(scope="module")
def gate():
    _, _, gt, pt = tiny_pair()
    pose, v, head = tiny_aux_nets(81)
    nets = dict(vgg_params=v, lpips_head=head, pose_params=pose,
                lpips_loss=LPIPSLoss(v, head))
    batch = self_inversion_eval_batch(gt, pt, seed=21, batch_size=4,
                                      **nets, **KW)
    single = self_inversion_eval(gt, pt, seed=21, **nets, **KW)
    return batch, single


def test_batched_gate_end_to_end(gate):
    batch, _ = gate
    per = batch["per_image"]
    assert len(per) == 4
    for p in per:
        assert set(p) == {"final_mse", "final_lpips", "final_ms_ssim",
                          "pivot_mse", "pivot_ms_ssim", "pose_err_deg",
                          "pti_steps",
                          "w_err", "init_pose_err_deg"}
        assert all(np.isfinite(v) for v in p.values()), p
        assert p["pti_steps"] == KW["max_pti_steps"]
        assert abs(p["init_pose_err_deg"] - 3.0) < 0.1
    assert batch["mean_final_ms_ssim"] == pytest.approx(
        np.mean([p["final_ms_ssim"] for p in per]))
    assert batch["mean_final_mse"] == pytest.approx(
        np.mean([p["final_mse"] for p in per]))
    assert batch["max_pose_err_deg"] == max(p["pose_err_deg"] for p in per)
    assert batch["stage1_s"] > 0 and batch["stage2_s"] > 0
    assert batch["seconds_per_image"] == pytest.approx(
        (batch["stage1_s"] + batch["stage2_s"]) / 4)
    # Four targets, four cameras: the images differ.
    assert len({round(p["final_mse"], 9) for p in per}) == 4
    assert len(selfinv._BATCH_POSE_OFFSETS) == 4


@pytest.mark.parametrize("key,single_key", [
    ("pose_err_deg", "pose_err_deg"), ("w_err", "w_err"),
    ("final_mse", "final_mse"), ("final_lpips", "final_lpips"),
    ("final_ms_ssim", "final_ms_ssim"), ("pivot_ms_ssim", "pivot_ms_ssim"),
    ("pivot_mse", "pivot_mse"),
    ("init_pose_err_deg", "init_pose_err_deg")])
def test_image0_equals_the_single_gate(gate, key, single_key):
    batch, single = gate
    got, want = batch["per_image"][0][key], single[single_key]
    assert abs(got - want) <= 1e-4 * max(abs(want), 1e-6), (key, got, want)
    assert batch["per_image"][0]["pti_steps"] == single["pti_steps"]
