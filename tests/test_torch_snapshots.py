"""tgi_torch's managed training snapshots (``io/orbax_io.py``, the
counterpart of ``tgi/io/orbax_io.py``), on the CPU.

* The manager against ``tgi``'s orbax manager on the same save sequence
  (steps 0, 4, 8, 12 at ``max_to_keep=2``): the same finished steps and
  newest step, the newest restored bit for bit, (None, None) on an empty
  directory, and a left-over temporary step ignored by both. No jit is
  involved on either side.
* The port's own guarantees: the state is copied when ``save`` returns,
  so an in-place update after it does not reach the file; an error of
  the background writer surfaces at ``wait_until_finished`` or at the
  next ``save`` and leaves no finished step.
* ``training_loop(checkpoint_backend="orbax")`` at the tiny size over 3
  ticks: at most ``snapshot_keep`` steps, the newest the returned state
  bit for bit with its ``cur_nimg``, a resumed loop continuing from it
  (``tests/test_train_loop.py`` runs ``tgi``'s loop with its backend).
"""

import os
import sys

import numpy as np
import pytest
import torch

from tgi_torch.io import orbax_io
from tgi_torch.io.orbax_io import make_manager, restore_latest, save_step

from tests.torch_helpers import TINY, TINY_D, TINY_RK, leaves_with_paths

STEPS = (0, 4, 8, 12)


def _tree(step):
    rng = np.random.RandomState(step)
    return {"params": {"g": {"w": rng.randn(3, 4).astype(np.float32),
                             "b": rng.randn(4).astype(np.float32)},
                       "step": np.asarray(step, np.float32)},
            "cur_nimg": np.asarray(step * 1000)}


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _leftover(directory):
    """A save cut by a kill, as each library names its temporary step."""
    for name in ("16.orbax-checkpoint-tmp-1700000000000000",
                 "16.tmp-1700000000000000000"):
        os.makedirs(os.path.join(directory, name))


def test_manager_matches_tgi(tmp_path):
    from tgi.io import orbax_io as jorbax
    want_m = jorbax.make_manager(str(tmp_path / "tgi"), max_to_keep=2)
    got_m = make_manager(str(tmp_path / "port"), max_to_keep=2)
    template = _tree(0)
    assert jorbax.restore_latest(want_m, template) == (None, None)
    assert restore_latest(got_m, {"params": _tensors(template["params"])}
                          ) == (None, None)
    for step in STEPS:
        jorbax.save_step(want_m, step, _tree(step))
        tree = _tree(step)
        assert save_step(got_m, step, {"params": _tensors(tree["params"]),
                                       "cur_nimg": int(tree["cur_nimg"])})
    want_m.wait_until_finished()
    got_m.wait_until_finished()
    assert list(got_m.all_steps()) == list(want_m.all_steps()) == [8, 12]
    assert got_m.latest_step() == want_m.latest_step() == 12

    _leftover(str(tmp_path / "tgi"))
    _leftover(str(tmp_path / "port"))
    want_m = jorbax.make_manager(str(tmp_path / "tgi"), max_to_keep=2)
    got_m = make_manager(str(tmp_path / "port"), max_to_keep=2)
    assert list(got_m.all_steps()) == list(want_m.all_steps()) == [8, 12]
    want, want_step = jorbax.restore_latest(want_m, template)
    got, got_step = restore_latest(got_m,
                                   {"params": _tensors(template["params"])})
    assert got_step == want_step == 12
    assert got["cur_nimg"] == int(want["cur_nimg"]) == 12000
    saved = dict(leaves_with_paths(_tree(12)["params"]))
    got_leaves = dict(leaves_with_paths(got["params"]))
    want_leaves = dict(leaves_with_paths(want["params"]))
    assert got_leaves.keys() == want_leaves.keys() == saved.keys()
    for path, a in saved.items():
        assert np.array_equal(np.asarray(want_leaves[path]), a), path
        assert got_leaves[path].dtype == torch.float32, path
        assert np.array_equal(got_leaves[path].numpy(), a), path


def test_save_copies_the_state_before_returning(tmp_path):
    """Saves in quick succession, each followed by an in-place update (as
    Adam's), with the interpreter switching threads often: every step
    holds the state its save was handed."""
    m = make_manager(str(tmp_path), max_to_keep=20)
    w = torch.zeros(4096)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for step in range(1, 21):
            save_step(m, step, {"params": {"w": w}, "cur_nimg": step})
            w.add_(1.0)
        m.wait_until_finished()
    finally:
        sys.setswitchinterval(switch)
    assert m.all_steps() == list(range(1, 21))
    for step in (1, 7, 20):
        got = m.restore(step)
        assert got["cur_nimg"] == step
        assert torch.equal(got["params"]["w"], torch.full((4096,), step - 1.0))
    with pytest.raises(ValueError, match="already exists"):
        save_step(m, 20, {"params": {"w": w}, "cur_nimg": 20})
    with pytest.raises(ValueError, match="template"):
        m.restore(20, {"params": {"v": w}})


@pytest.mark.parametrize("surfaces_at", ["wait_until_finished", "save"])
def test_writer_error_surfaces(tmp_path, monkeypatch, surfaces_at):
    m = make_manager(str(tmp_path), max_to_keep=2)

    def broken(path, params, config=None, metadata=None):
        raise OSError("disk full")

    monkeypatch.setattr(orbax_io, "save_checkpoint", broken)
    assert save_step(m, 3, {"params": {"w": torch.ones(2)}, "cur_nimg": 3})
    with pytest.raises(OSError, match="disk full"):
        if surfaces_at == "save":
            save_step(m, 4, {"params": {"w": torch.ones(2)}, "cur_nimg": 4})
        else:
            m.wait_until_finished()
    assert m.all_steps() == [] and restore_latest(m) == (None, None)
    monkeypatch.undo()
    m.wait_until_finished()         # raised once, not again
    save_step(m, 5, {"params": {"w": torch.ones(2)}, "cur_nimg": 5})
    m.wait_until_finished()
    assert m.all_steps() == [5]


def _png_dataset(tmp_path, n=2, res=64):
    import io
    import json
    import zipfile

    from PIL import Image

    from tests.torch_helpers import tiny_camera
    rng = np.random.RandomState(0)
    path = str(tmp_path / "data.zip")
    with zipfile.ZipFile(path, "w") as z:
        labels = []
        for i in range(n):
            buf = io.BytesIO()
            Image.fromarray((rng.rand(res, res, 3) * 255).astype(
                np.uint8)).save(buf, format="PNG")
            z.writestr(f"img{i}.png", buf.getvalue())
            labels.append([f"img{i}.png", tiny_camera(0.1 * i)[0].tolist()])
        z.writestr("dataset.json", json.dumps({"labels": labels}))
    return path


def _bits(tree):
    return {p: t.detach().clone() for p, t in leaves_with_paths(tree)}


def test_training_loop_keeps_and_resumes_snapshots(tmp_path):
    """One step a tick, a snapshot a tick, two kept: after 3 ticks steps
    4 and 6 (cur_nimg at batch 2); the newest is the returned state bit
    for bit. A loop resumed from the run's snapshots continues at 6,
    writes 8 and keeps 6 and 8; an empty directory starts afresh."""
    from tgi_torch.models.generator import (GeneratorConfig,
                                            TriPlaneGenerator,
                                            default_rendering_kwargs)
    from tgi_torch.nn.discriminator import DiscriminatorConfig
    from tgi_torch.train.gan import GANTrainConfig, train_state_tree
    from tgi_torch.train.loop import training_loop
    G = TriPlaneGenerator(GeneratorConfig(
        rendering_kwargs=default_rendering_kwargs(**TINY_RK), **TINY))
    cfg = GANTrainConfig(batch_size=2, blur_init_sigma=1.0,
                         density_reg_samples=16, g_reg_interval=4,
                         d_reg_interval=4,
                         neural_rendering_resolution_initial=16)
    run = str(tmp_path / "run")
    snapshots = os.path.join(run, "snapshots")
    common = dict(G=G, d_cfg=DiscriminatorConfig(**TINY_D),
                  data_path=_png_dataset(tmp_path), run_dir=run, cfg=cfg,
                  kimg_per_tick=0.002, snapshot_ticks=1,
                  image_snapshot_ticks=0, device="cpu", ada_target=None,
                  checkpoint_backend="orbax", snapshot_keep=2)
    state = training_loop(total_kimg=0.006, **common)
    m = make_manager(snapshots)
    assert m.all_steps() == [4, 6]
    data, step = restore_latest(m)
    assert step == 6 and data["cur_nimg"] == 6
    want = _bits(train_state_tree(state))
    got = dict(leaves_with_paths(data["params"]))
    assert got.keys() == want.keys()
    assert all(torch.equal(got[p], want[p]) for p in want)
    assert want[("g_opt", "step")] == 3

    more = training_loop(total_kimg=0.008, resume_ckpt=snapshots, **common)
    assert m.all_steps() == [6, 8]
    after = _bits(train_state_tree(more))
    assert after[("g_opt", "step")] == 4
    data, _ = restore_latest(m)
    assert data["cur_nimg"] == 8
    saved = dict(leaves_with_paths(data["params"]))
    assert all(torch.equal(saved[p], after[p]) for p in after)

    empty = str(tmp_path / "empty")
    fresh = training_loop(total_kimg=0.002, resume_ckpt=empty,
                          **{**common, "run_dir": str(tmp_path / "fresh")})
    assert _bits(train_state_tree(fresh))[("g_opt", "step")] == 1
    assert make_manager(empty).all_steps() == []
