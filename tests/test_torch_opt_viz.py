"""tgi_torch's optimisation snapshots and metric writers, on the CPU at
the tiny config with small stage-1 networks: the snapshot cadence of
``Projector.project`` (every ``snapshot_every`` steps, at the end of the
camera preheat and at the last step), the PNGs the snapshotter writes
(the current state's reconstruction and the canonical view warped to its
camera, as ``tgi``'s snapshotter renders them), and the tensorboard,
wandb and fan-out writers."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from tgi_torch.invert.projector import (Projector, ProjectorConfig,
                                        merge_noise)
from tgi_torch.models.generator import (GeneratorConfig, TriPlaneGenerator,
                                        default_rendering_kwargs)
from tgi_torch.utils import opt_viz
from tgi_torch.utils.image import to_uint8

from torch_helpers import TINY, TINY_RK, tiny_aux_nets


class Recorder:
    """A writer with TBWriter's methods that keeps what it is given."""

    active = True

    def __init__(self):
        self.calls = []

    def scalar(self, tag, value, step):
        self.calls.append(("scalar", tag, float(value), step))

    def scalars(self, values, step, prefix=""):
        self.calls.append(("scalars", prefix, dict(values), step))

    def image(self, tag, img_chw, step, input_range=(-1, 1)):
        self.calls.append(("image", tag, tuple(img_chw.shape), step))

    def flush(self):
        self.calls.append(("flush",))

    def close(self):
        self.calls.append(("close",))


@pytest.fixture(scope="module")
def setup():
    gt = TriPlaneGenerator(GeneratorConfig(
        rendering_kwargs=default_rendering_kwargs(**TINY_RK), **TINY))
    pt = gt.init(torch.Generator().manual_seed(0), device="cpu")
    pose, vgg, head = tiny_aux_nets(4)
    proj = Projector(gt, pt, vgg, head, pose,
                     ProjectorConfig(num_steps=12, cam_preheat_steps=5,
                                     w_avg_samples=64))
    rng = np.random.RandomState(5)
    target = torch.from_numpy((rng.rand(1, 3, 256, 256) * 255).astype(
        np.float32))
    return dict(gt=gt, pt=pt, proj=proj, target=target)


def test_snapshot_cadence_and_pngs(setup, tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image
    s = setup
    tb = Recorder()
    out = str(tmp_path / "out")
    snap = opt_viz.make_projection_snapshotter(s["proj"], out, "face", tb=tb)
    ws, cam, state, _ = s["proj"].project(
        s["target"], generator=torch.Generator().manual_seed(1),
        snapshot_fn=snap, snapshot_every=10)
    pivot_dir = f"{out}_pivot/face"
    assert sorted(os.listdir(pivot_dir)) == sorted(
        [f"{k}.png" for k in (5, 10, 12)]
        + [f"warp_{k}.png" for k in (5, 10, 12)])
    # The warp is at the depth map's resolution (16² rays).
    assert [c[1:] for c in tb.calls] == [
        (tag, shape, k) for k in (5, 10, 12)
        for tag, shape in (("face/reconstruction", (3, 64, 64)),
                           ("face/warp", (3, 16, 16)))]
    # The last snapshot is the final state's deterministic fp32 render.
    with torch.no_grad():
        _, pred_cam = s["proj"].camera(state["pose"], state["translation"],
                                       s["target"])
        want = s["gt"].synthesis(merge_noise(s["pt"], state["noise"]), ws,
                                 pred_cam, det=True)["image"]
    got = np.asarray(Image.open(os.path.join(pivot_dir, "12.png")))
    assert np.abs(got.astype(int) - to_uint8(want).astype(int)).max() <= 1
    warp = np.asarray(Image.open(os.path.join(pivot_dir, "warp_12.png")))
    assert warp.shape == (16, 16, 3)


def test_one_snapshot_writes_both_pngs(setup, tmp_path):
    pytest.importorskip("PIL")
    s = setup
    snap = opt_viz.make_projection_snapshotter(s["proj"], str(tmp_path / "o"),
                                               "x")
    state, _, _ = s["proj"].init_state(
        generator=torch.Generator().manual_seed(2))
    snap(3, state, s["target"])
    assert sorted(os.listdir(f"{tmp_path / 'o'}_pivot/x")) == [
        "3.png", "warp_3.png"]


def test_tensorboard_writer(tmp_path):
    tb = opt_viz.TBWriter(str(tmp_path / "tb"))
    if importlib.util.find_spec("tensorboard") is None:
        assert not tb.active
        tb.scalar("a", 1.0, 0)          # a no-op
        return
    assert tb.active
    tb.scalars({"loss": torch.tensor(0.5), "cam": np.zeros(25), "n": 3}, 1,
               prefix="face/")
    tb.image("img", torch.zeros(3, 8, 8), 1)
    tb.flush()
    tb.close()
    assert any(f.startswith("events.") for f in os.listdir(tmp_path / "tb"))


def test_wandb_and_fanout_writers():
    wb = opt_viz.WandbWriter(project="tgi-test")
    if importlib.util.find_spec("wandb") is None:
        assert not wb.active
        wb.scalars({"a": 1.0}, 0)       # no-ops
        wb.image("img", np.zeros((3, 4, 4)), 0)
    a, b = Recorder(), Recorder()
    fan = opt_viz.FanoutWriter([a, None, b])
    assert fan.active
    fan.scalar("x", 2, 3)
    fan.scalars({"y": 1.0}, 4, prefix="p/")
    fan.image("i", np.zeros((3, 2, 2)), 5)
    fan.flush()
    fan.close()
    assert a.calls == b.calls == [
        ("scalar", "x", 2.0, 3), ("scalars", "p/", {"y": 1.0}, 4),
        ("image", "i", (3, 2, 2), 5), ("flush",), ("close",)]
