"""Data parallelism over two gloo ranks on the CPU (tgi_torch.parallel's
data axis; twin of tests/test_parallel.py's data-sharded tests).

The file spawns two ranks once (``tests/torch_dist.py``), whose group's
store is a file in a temporary directory; they run every job below in
turn, and each test holds what they computed on their rows against the
same work unsharded in the test's own process:

* one ``GANTrainer.train_step`` at batch 4 where the pose swap (always
  on), the minibatch-std group of 4, the style-mixing cutoff, the augment
  pipe's draws and R1's double backward all cross ranks: metrics within
  1e-5 relative, each gradient the Adams applied within 1e-5 of its
  leaf's largest value, and the updated weights through
  ``torch_helpers.assert_updates_match`` (the unsharded step is held
  against tgi by tests/test_torch_gan_step.py);
* ``training_loop(mesh=...)`` for 2 steps against ``mesh=None``: the
  tick's means within 1e-5 relative, every weight within 2 · steps · lr
  of the unsharded run's and those whose gradient is at least 1e-2 of
  their leaf's largest at both steps within 2e-2 · steps · lr
  (``assert_updates_match`` without its clause that such a weight moves
  by lr / 4: the GAN's Adams have b1 = 0, so two opposite steps may
  cancel), only rank 0 writing (stats.jsonl and the checkpoint);
* one data-sharded ``project_batch`` step of 4 images against the
  unsharded one (tests/test_parallel.py's data-sharded inversion step):
  ws, w and the loss within 1e-5, the cameras 1e-4 (their pose nets'
  BatchNorm statistics are each image's own, but the convolutions'
  sums run over another batch size).
"""

import json
import os

import numpy as np
import pytest
import torch

from tests import torch_dist
from tests.torch_helpers import assert_updates_match, leaves_with_paths
from tests.torch_tiny import port_camera, port_generator
from tgi_torch.nn.discriminator import DiscriminatorConfig
from tgi_torch.train import gan


def _grad_trees(params, steps):
    """Per-step flat gradient lists as trees shaped like ``params``."""
    out = []
    for flat in steps:
        tree = {}
        for (path, _), g in zip(leaves_with_paths(params), flat):
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = g.numpy()
        out.append(tree)
    return out


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _npy_dataset(root, n=4, res=64):
    """n ``.npy`` images in [-1, 1] with a dataset.json of cameras."""
    os.makedirs(root)
    rng = np.random.RandomState(0)
    cams = port_camera([0.1 * i for i in range(n)]).numpy()
    labels = []
    for i in range(n):
        np.save(os.path.join(root, f"img{i}.npy"),
                rng.uniform(-1, 1, (3, res, res)).astype(np.float32))
        labels.append([f"img{i}.npy", cams[i].tolist()])
    with open(os.path.join(root, "dataset.json"), "w") as f:
        json.dump({"labels": labels}, f)
    return root


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The directory where the two ranks left their results."""
    tmp = tmp_path_factory.mktemp("ranks")
    data = _npy_dataset(str(tmp / "data"))
    torch_dist.spawn([(torch_dist.mesh_checks, ()),
                      (torch_dist.gan_step, ()),
                      (torch_dist.training_run, (data,)),
                      (torch_dist.project_step, ())], 2, tmp)
    return tmp


def test_mesh_inside_a_group(ranks):
    """The data axis is the group's 2 ranks; each rank's rows are its own
    and ``replicate`` gives both rank 0's weights."""
    got = torch.load(ranks / "mesh_checks.pt")
    assert got["shape"] == {"data": 2, "rays": 1}
    assert got["rays2"] == {"data": 2, "rays": 2}
    assert got["rows_equal"]
    x = torch.arange(8 * 3.0).reshape(8, 3)
    seen = got["seen"]
    assert torch.equal(seen[:, :12], x.reshape(2, 12))
    assert torch.equal(seen[:, 12:], torch.zeros(2, 12))


def test_sharded_train_step_matches_unsharded(ranks):
    got = torch.load(ranks / "gan_step.pt")
    want = torch_dist.gan_step(None)
    assert set(got["metrics"]) == set(want["metrics"]) == {
        "g_loss", "g_reg", "d_loss", "signs_real", "d_reg"}
    for k, w in want["metrics"].items():
        assert abs(got["metrics"][k] - w) <= 1e-5 * max(1.0, abs(w)), k
    assert len(got["grads"]) == len(want["grads"]) == 2
    for phase_got, phase_want in zip(got["grads"], want["grads"]):
        for g, w in zip(phase_got, phase_want):
            assert (g - w).abs().max() <= 1e-5 * max(w.abs().max(), 1e-30)
    cfg = gan.GANTrainConfig(**torch_dist.STEP_GAN)
    for key, start, grads, lr in (
            ("g", want["start_g"], want["grads"][0],
             cfg.lazy_adjusted(cfg.g_lr, cfg.g_reg_interval)[0]),
            ("d", want["start_d"], want["grads"][1],
             cfg.lazy_adjusted(cfg.d_lr, cfg.d_reg_interval)[0])):
        assert_updates_match(got[key], _numpy(want[key]), _numpy(start), 1,
                             _grad_trees(start, [grads]), lr=lr)


def test_sharded_training_loop_matches_unsharded(ranks, tmp_path):
    got = torch.load(ranks / "training_run.pt")
    steps = []
    real_apply = gan._apply

    def record(opt, params, grads):
        steps.append([gan._sanitize(g).detach().clone() for g in grads])
        return real_apply(opt, params, grads)

    gan._apply = record
    try:
        want = torch_dist.training_run(None, str(tmp_path),
                                       str(ranks / "data"))
    finally:
        gan._apply = real_apply
    # Only rank 0 wrote.
    assert sorted(os.listdir(ranks / "run0")) == sorted(
        os.listdir(tmp_path / "run")) == ["network-000000.ckpt",
                                          "stats.jsonl"]
    assert not os.path.exists(ranks / "run1")
    rec0, rec = (json.loads(open(d / "stats.jsonl").readline())
                 for d in (ranks / "run0", tmp_path / "run"))
    for k in ("g_loss", "d_loss", "signs_real"):
        assert abs(rec0[k] - rec[k]) <= 1e-5 * max(1.0, abs(rec[k])), k
    # The loop's starting weights: G, then D, from one CPU generator of
    # its seed (0).
    cfg = gan.GANTrainConfig(**torch_dist.LOOP_GAN)
    G, d_cfg = port_generator()[0], DiscriminatorConfig(**torch_dist.STEP_D)
    start = gan.init_train_state(torch.Generator().manual_seed(0), G, d_cfg,
                                 gan.GANTrainer(G, d_cfg, cfg), device="cpu")
    for key, lr, grads in (("g_params", cfg.g_lr, steps[0::2]),
                           ("d_params", cfg.d_lr, steps[1::2])):
        lr = cfg.lazy_adjusted(lr, 2)[0]
        moved = 0
        for (path, s0), (_, g), (_, w), *per_step in zip(
                leaves_with_paths(start[key]), leaves_with_paths(got[key]),
                leaves_with_paths(want[key]),
                *(leaves_with_paths(t) for t in _grad_trees(start[key],
                                                            grads))):
            s0 = s0.detach().numpy()
            err = np.abs(g.numpy() - w.numpy())
            assert err.max() <= 2 * 2 * lr, (path, err.max())
            sure = np.ones(err.shape, bool)
            for _, gr in per_step:
                sure &= np.abs(gr) >= 1e-2 * np.abs(gr).max()
            assert (err[sure] <= 2e-2 * 2 * lr).all(), path
            moved += int(np.abs(w.numpy() - s0).max() > 0)
        assert moved > 10, moved


def test_data_sharded_project_batch_step(ranks):
    got = torch.load(ranks / "project_step.pt")
    want = torch_dist.project_step(None)
    for k, tol in (("ws", 1e-5), ("w", 1e-5), ("loss", 1e-5),
                   ("cams", 1e-4)):
        assert got[k].shape == want[k].shape, k
        assert (got[k] - want[k]).abs().max() <= tol * max(
            1.0, want[k].abs().max()), k
