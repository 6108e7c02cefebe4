"""tgi_torch's GANSpace against tgi's, on the CPU, at the tiny config
(z/w 32, 2 mapping layers): the PCA of mapped w from tgi's z batches
(mean and covariance 1e-5 relative; components, unique only up to sign,
compared by |cos| where their variances stand apart), ``edit_ws``
exactly, the curated directions, the basis loader and the edit renders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tgi.apps import ganspace as jganspace
from tgi_torch.apps import ganspace

from torch_helpers import TOL, close, tiny_camera, tiny_pair

NUM, BATCH = 600, 128      # 5 batches, 640 samples (tgi counts them all)


@pytest.fixture(scope="module")
def setup():
    gj, pj, gt, pt = tiny_pair()
    key = jax.random.PRNGKey(5)
    want = jganspace.compute_pca(gj, pj, num_samples=NUM, batch=BATCH,
                                 key=key)
    zs = [torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(key, i), (BATCH, 32)))) for i in range(5)]
    got = ganspace.compute_pca(gt, pt, num_samples=NUM, batch=BATCH,
                               z_batches=zs)
    return dict(gj=gj, pj=pj, gt=gt, pt=pt, want=want, got=got)


def test_compute_pca_matches_tgi(setup):
    (comps, stdev, mean), (jcomps, jstdev, jmean) = (setup["got"],
                                                     setup["want"])
    assert comps.shape == (32, 32) and stdev.shape == mean.shape == (32,)
    close(mean, jmean, TOL)
    close(stdev, jstdev, 1e-4)
    assert (np.diff(stdev) <= 0).all()
    # The covariance both bases span.
    close(comps.T @ np.diag(stdev ** 2) @ comps,
          jcomps.T @ np.diag(jstdev ** 2) @ jcomps, 1e-4)
    np.testing.assert_allclose(comps @ comps.T, np.eye(32), atol=1e-5)
    # Each component whose variance stands apart from its neighbours'
    # is tgi's, up to sign.
    var = jstdev ** 2
    gap = np.minimum(np.abs(np.diff(var, prepend=np.inf)),
                     np.abs(np.diff(var, append=-np.inf)))
    apart = gap > 1e-2 * var[0]
    assert apart.sum() >= 8
    cos = np.abs(np.sum(comps * jcomps, axis=1))
    assert (cos[apart] > 1 - 1e-4).all(), cos[apart]


def test_compute_pca_draws_from_a_generator(setup):
    """Without z batches, z comes from the generator: the same seed gives
    the same basis."""
    runs = [ganspace.compute_pca(setup["gt"], setup["pt"], num_samples=200,
                                 batch=100,
                                 generator=torch.Generator().manual_seed(1))
            for _ in range(2)]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def test_edit_ws_is_tgis_exactly(setup):
    comps = setup["want"][0]
    ws = np.random.RandomState(2).randn(2, 6, 32).astype(np.float32)
    for idx, strength, layers in ((3, 2.5, (0, 4)), (0, -1.7, (2, 6))):
        want = jganspace.edit_ws(jnp.asarray(ws), comps, idx, strength,
                                 layers)
        got = ganspace.edit_ws(torch.from_numpy(ws), comps, idx, strength,
                               layers)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The caller's ws is not changed.
    np.testing.assert_array_equal(
        ws, np.random.RandomState(2).randn(2, 6, 32).astype(np.float32))


def test_directions_are_tgis():
    assert ganspace.DIRECTIONS == jganspace.DIRECTIONS


def test_load_components(setup, tmp_path):
    comps = setup["got"][0]
    np.save(tmp_path / "pcs.npy", comps)
    np.testing.assert_array_equal(
        ganspace.load_components(str(tmp_path / "pcs.npy"), w_dim=32), comps)
    np.save(tmp_path / "short.npy", comps[:, :16])
    with pytest.raises(ValueError, match="expected"):
        ganspace.load_components(str(tmp_path / "short.npy"), w_dim=32)
    np.save(tmp_path / "scaled.npy", 2 * comps)
    with pytest.raises(ValueError, match="unit-norm"):
        ganspace.load_components(str(tmp_path / "scaled.npy"), w_dim=32)


def test_edit_and_render_and_sweep(setup, tmp_path):
    """The edit renders are the generator's renders of the edited codes;
    a named direction takes its component, layers and strength."""
    pytest.importorskip("PIL")
    s = setup
    gt, pt = s["gt"], s["pt"]
    comps = np.concatenate([s["got"][0]] * 2)          # 64 rows
    ws = torch.from_numpy(np.random.RandomState(3).randn(
        1, gt.cfg.num_ws, 32).astype(np.float32))
    cam = torch.from_numpy(tiny_camera(0.1))
    orig, edit = ganspace.edit_and_render(gt, pt, ws, cam, comps,
                                          direction="smile",
                                          outdir=str(tmp_path))
    spec = ganspace.DIRECTIONS["smile"]
    edited = ganspace.edit_ws(ws, comps, spec["comp"], spec["strength"],
                              spec["layers"])
    with torch.no_grad():
        torch.testing.assert_close(
            edit, gt.synthesis(pt, edited, cam, det=True)["image"],
            rtol=0, atol=0)
        torch.testing.assert_close(
            orig, gt.synthesis(pt, ws, cam, det=True)["image"], rtol=0,
            atol=0)
    assert (edit - orig).abs().max() > 1e-3
    assert (tmp_path / "edit.png").exists()
    imgs, dirs = ganspace.edit_sweep(gt, pt, ws, cam, comps, comp_idx=1,
                                     layers=(0, 3), edit_power=2.0,
                                     num_imgs=3, outdir=str(tmp_path))
    assert imgs.shape == (3, 3, 64, 64)
    assert dirs.shape == (3, gt.cfg.num_ws, 32)
    np.testing.assert_allclose(dirs[0, :3], np.broadcast_to(
        -2.0 * comps[1], (3, 32)), atol=1e-6)
    assert (dirs[:, 3:] == 0).all()
    assert (tmp_path / "sweep_grid.png").exists()
