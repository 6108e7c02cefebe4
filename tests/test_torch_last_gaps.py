"""The last public signatures tgi_torch takes over from ``tgi``, on the
CPU: ``nn/mapping.py::update_w_avg`` (the functional EMA of ``w_avg``)
and ``utils/opt_viz.py::make_projection_snapshotter(save_warp=False)``
(the reconstruction alone, no canonical render, no ``warp_<step>.png``),
each against ``tgi``'s on the same inputs at the tiny config with small
stage-1 networks (``width_mult`` 1/8).

Tolerances: ``update_w_avg`` 1e-6 relative (one mean and one fma per
element); the snapshot's PNG within one level of 255 (fp32 renders of
the two packages rounded to uint8).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tgi.invert import projector as jproj
from tgi.nn.mapping import update_w_avg as jupdate_w_avg
from tgi.utils import opt_viz as jopt_viz
from tgi_torch.invert import projector as proj
from tgi_torch.nn.mapping import update_w_avg
from tgi_torch.utils import opt_viz

from torch_helpers import tiny_aux_nets, tiny_camera, tiny_pair


def _j(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


@pytest.mark.parametrize("beta", [0.998, 0.5])
def test_update_w_avg_matches_tgi(beta):
    rng = np.random.RandomState(3)
    params = {"w_avg": rng.randn(32).astype(np.float32),
              "fc0": {"weight": rng.randn(32, 32).astype(np.float32)}}
    ws = rng.randn(5, 32).astype(np.float32)
    want = jupdate_w_avg(jax.tree.map(jnp.asarray, params), jnp.asarray(ws),
                         beta)
    tparams = jax.tree.map(torch.from_numpy, params)
    got = update_w_avg(tparams, torch.from_numpy(ws), beta)
    w = np.asarray(want["w_avg"])
    assert np.abs(got["w_avg"].numpy() - w).max() <= 1e-6 * np.abs(w).max()
    # The other leaves are the same objects and the input is unchanged.
    assert got["fc0"] is tparams["fc0"]
    assert np.array_equal(tparams["w_avg"].numpy(), params["w_avg"])


def test_snapshot_without_warp_matches_tgi(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image
    gj, pj, gt, pt = tiny_pair()
    pose, v, head = tiny_aux_nets(4)
    kw = dict(num_steps=4, cam_preheat_steps=2, w_avg_samples=16)
    pr_j = jproj.Projector(gj, pj, _j(v), _j(head), _j(pose),
                           jproj.ProjectorConfig(**kw))
    pr_t = proj.Projector(gt, pt, v, head, pose, proj.ProjectorConfig(**kw))
    rng = np.random.RandomState(4)
    state = {
        "w": (0.5 * rng.randn(1, 1, 32)).astype(np.float32),
        "noise": {"/".join(p): rng.randn(*proj.get_path(
            pr_t.base_params, p).shape).astype(np.float32)
            for p in pr_t.noise_paths},
        "translation": (0.02 * rng.randn(1, 3)).astype(np.float32),
        "pose": jax.tree.map(lambda t: t.numpy(), pose)}
    with torch.no_grad():
        target = ((gt.synthesis(pt, torch.from_numpy(state["w"]).repeat(
            1, gt.cfg.num_ws, 1), torch.from_numpy(tiny_camera(0.2)))[
                "image"].clamp(-1, 1) + 1) * 127.5)
    target = torch.nn.functional.interpolate(target, size=(256, 256),
                                             mode="bilinear")
    jopt_viz.make_projection_snapshotter(
        pr_j, str(tmp_path / "tgi"), "x", save_warp=False)(
        7, jax.tree.map(jnp.asarray, state), jnp.asarray(target.numpy()))
    opt_viz.make_projection_snapshotter(
        pr_t, str(tmp_path / "port"), "x", save_warp=False)(
        7, jax.tree.map(torch.from_numpy, state), target)
    want_dir, got_dir = (f"{tmp_path / k}_pivot/x" for k in ("tgi", "port"))
    assert os.listdir(got_dir) == os.listdir(want_dir) == ["7.png"]
    want = np.asarray(Image.open(os.path.join(want_dir, "7.png")), int)
    got = np.asarray(Image.open(os.path.join(got_dir, "7.png")), int)
    assert got.shape == want.shape == (64, 64, 3)
    assert np.abs(got - want).max() <= 1
