"""tgi_torch's shape path against tgi's, on the CPU, at the tiny config
(plane C = 8, 32² backbone): ``sample_mixed`` / ``sample`` at arbitrary
points, ``sigma_grid`` at a 12³ grid in chunks smaller than the grid (so
the last chunk is padded), ``sigma_cross_section``, and the mesh written
by ``extract_mesh`` and ``gen_samples --shapes``.

Tolerance 1e-5 relative to the largest value (one tri-plane sample and
the decoder MLP in fp32, summed in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tgi.apps import shape as jshape
from tgi_torch.apps import gen_samples, shape
from tgi_torch.utils import marching

from torch_helpers import TOL, close, jit_ref, tiny_camera, tiny_pair


@pytest.fixture(scope="module")
def setup():
    gj, pj, gt, pt = tiny_pair()
    rng = np.random.RandomState(3)
    ws = (0.5 * rng.randn(1, gt.cfg.num_ws, 32)).astype(np.float32)
    planes = jit_ref(gj.backbone_planes)(pj, jnp.asarray(ws))
    return dict(gj=gj, pj=pj, gt=gt, pt=pt, ws=ws, planes=planes)


def test_sample_mixed_matches_tgi(setup):
    s = setup
    pts = (np.random.RandomState(4).rand(1, 700, 3) * 1.2 - 0.6).astype(
        np.float32)
    want = jit_ref(s["gj"].sample_mixed)(s["pj"], jnp.asarray(pts),
                                         jnp.asarray(s["ws"]))
    with torch.no_grad():
        got = s["gt"].sample_mixed(s["pt"], torch.from_numpy(pts),
                                   torch.from_numpy(s["ws"]))
    close(got["sigma"], want["sigma"], TOL)
    close(got["rgb"], want["rgb"], TOL)


def test_sample_from_z_matches_tgi(setup):
    s = setup
    pts = (np.random.RandomState(5).rand(1, 300, 3) - 0.5).astype(np.float32)
    z = np.random.RandomState(6).randn(1, 32).astype(np.float32)
    cam = tiny_camera(0.2)
    want = jit_ref(lambda p, x, z, c: s["gj"].sample(p, x, z, c, 0.7))(
        s["pj"], jnp.asarray(pts), jnp.asarray(z), jnp.asarray(cam))
    with torch.no_grad():
        got = s["gt"].sample(s["pt"], torch.from_numpy(pts),
                             torch.from_numpy(z), torch.from_numpy(cam),
                             truncation_psi=0.7)
    close(got["sigma"], want["sigma"], TOL)
    close(got["rgb"], want["rgb"], TOL)


@pytest.mark.parametrize("chunk", [500, 1 << 20])
def test_sigma_grid_matches_tgi(setup, chunk):
    """12³ = 1728 points: four chunks of 500, the last padded with 272
    points at the origin, or one chunk of the whole grid."""
    s = setup
    want = jshape.sigma_grid(s["gj"], s["pj"], None, resolution=12,
                             chunk=chunk, planes=s["planes"])
    got = shape.sigma_grid(s["gt"], s["pt"], torch.from_numpy(s["ws"]),
                           resolution=12, chunk=chunk)
    assert got.shape == (12, 12, 12) and got.dtype == np.float32
    close(got, want, TOL)


def test_sigma_cross_section_matches_tgi(setup, monkeypatch):
    s = setup
    # tgi renders it through its sample_mixed, unjitted: jit it here.
    monkeypatch.setattr(s["gj"], "sample_mixed", jit_ref(s["gj"].sample_mixed))
    for axis, offset in (("x", 0.1), ("z", -0.2)):
        want = jshape.sigma_cross_section(
            s["gj"], s["pj"], jnp.asarray(s["ws"]), axis=axis,
            offset=offset, resolution=16, shape_scale=0.8)
        got = shape.sigma_cross_section(
            s["gt"], s["pt"], torch.from_numpy(s["ws"]), axis=axis,
            offset=offset, resolution=16, shape_scale=0.8)
        assert got.shape == (16, 16)
        close(got, want, TOL)


def _level(s, res):
    """An iso level inside the tiny generator's sigma range (its sigma
    stays far below the reference's level of 10)."""
    grid = shape.sigma_grid(s["gt"], s["pt"], torch.from_numpy(s["ws"]),
                            resolution=res)
    return float(np.quantile(grid, 0.7))


def test_extract_mesh_writes_its_grid_and_mesh(setup, tmp_path):
    s = setup
    level = _level(s, 16)
    ply, mrc = tmp_path / "m.ply", tmp_path / "m.mrc"
    verts, faces = shape.extract_mesh(
        s["gt"], s["pt"], torch.from_numpy(s["ws"]), resolution=16,
        level=level, out_ply=str(ply), out_mrc=str(mrc), chunk=1000)
    grid = shape.sigma_grid(s["gt"], s["pt"], torch.from_numpy(s["ws"]),
                            resolution=16)
    want_v, want_f = marching.marching_tetrahedra(grid, level=level,
                                                  spacing=1 / 16)
    assert len(faces) > 0
    np.testing.assert_array_equal(verts, want_v)
    np.testing.assert_array_equal(faces, want_f)
    head = ply.read_text().split("end_header\n")[0]
    assert f"element vertex {len(verts)}" in head
    assert f"element face {len(faces)}" in head
    assert mrc.stat().st_size == 1024 + 16 ** 3 * 4


def test_generate_samples_writes_shapes(setup, tmp_path, monkeypatch):
    """``gen_samples --shapes``: one mesh per seed, of the seed's ws."""
    s = setup
    got = []
    monkeypatch.setattr(shape, "extract_mesh",
                        lambda G, p, ws, **kw: got.append((ws, kw)))
    res = gen_samples.generate_samples(s["gt"], s["pt"], [3, 5],
                                       outdir=str(tmp_path), shapes=True,
                                       shape_res=8, device="cpu")
    assert len(res) == 2 and [kw["resolution"] for _, kw in got] == [8, 8]
    assert [kw["out_ply"] for _, kw in got] == [
        str(tmp_path / "seed0003.ply"), str(tmp_path / "seed0005.ply")]
    from tgi_torch.apps.ganspace import front_camera
    z = gen_samples.seed_z(5, 32, "cpu")
    with torch.no_grad():
        ws = s["gt"].mapping(s["pt"], z, front_camera(device="cpu"),
                             truncation_psi=0.7, truncation_cutoff=14)
    torch.testing.assert_close(got[1][0], ws, rtol=0, atol=0)
    with pytest.raises(ValueError, match="outdir"):
        gen_samples.generate_samples(s["gt"], s["pt"], [3], shapes=True,
                                     device="cpu")


def test_gen_samples_cli_shapes(setup, tmp_path):
    pytest.importorskip("click")
    pytest.importorskip("PIL")
    from tgi_torch.io.checkpoints import save_checkpoint
    net = tmp_path / "G.pt"
    save_checkpoint(str(net), setup["pt"], config=setup["gt"].cfg)
    with pytest.raises(SystemExit) as e:
        gen_samples.main(["--network", str(net), "--seeds", "2",
                          "--outdir", str(tmp_path / "out"), "--shapes",
                          "--shape-res", "12", "--device", "cpu"])
    assert e.value.code == 0
    head = (tmp_path / "out" / "seed0002.ply").read_text()
    assert head.startswith("ply\n") and "element face" in head
