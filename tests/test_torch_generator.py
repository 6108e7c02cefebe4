"""tgi_torch's generator against tgi's, on the CPU, at the tiny config of
``__graft_entry__.py`` (plane C = 8, 32² backbone, 16² rays, 8 + 8
samples, SuperresolutionTiny), with tgi's weights carried over by name.

Tolerance 1e-4 abs on every output; the largest errors measured in
test_synthesis_matches_tgi on an x86 CPU were 6.0e-6 (image), 3.6e-7
(image_raw), 1.2e-6 (image_depth) and 7.6e-6 (planes, whose values
reach ~9).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tgi.models import GeneratorConfig as JGeneratorConfig
from tgi.models import TriPlaneGenerator as JTriPlaneGenerator
from tgi.models import default_rendering_kwargs as jdefault_rendering_kwargs
from tgi.render import cameras as jcameras
from tgi_torch.apps.gen_samples import generate_samples, parse_range
from tgi_torch.io.from_jax import params_from_numpy
from tgi_torch.models.generator import (GeneratorConfig, TriPlaneGenerator,
                                        default_rendering_kwargs)

ATOL = 1e-4
TINY = dict(z_dim=32, c_dim=25, w_dim=32, img_resolution=64,
            backbone_resolution=32, plane_channels=8, mapping_layers=2,
            channel_base=512, channel_max=32, neural_rendering_resolution=16)
TINY_RK = dict(superresolution_module="SuperresolutionTiny",
               depth_resolution=8, depth_resolution_importance=8,
               image_resolution=64)


@pytest.fixture(scope="module")
def pair():
    """(tgi generator, its params, port generator, the same params)."""
    gj = JTriPlaneGenerator(JGeneratorConfig(
        rendering_kwargs=jdefault_rendering_kwargs(**TINY_RK), **TINY))
    pj = jax.jit(gj.init)(jax.random.PRNGKey(0))
    # Nonzero noise strengths and w_avg, so those paths carry signal.
    pj = jax.tree_util.tree_map_with_path(
        lambda path, v: (jnp.full_like(v, 0.3) if "noise_strength" in
                         jax.tree_util.keystr(path) else v), pj)
    pj["mapping"]["w_avg"] = 0.5 * jnp.ones_like(pj["mapping"]["w_avg"])
    gt = TriPlaneGenerator(GeneratorConfig(
        rendering_kwargs=default_rendering_kwargs(**TINY_RK), **TINY))
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")
    return gj, pj, gt, pt


def _inputs(seed, yaw=0.0):
    z = np.random.RandomState(seed).randn(1, 32).astype(np.float32)
    cam = jcameras.look_at_pose(np.pi / 2 + yaw, np.pi / 2,
                                jnp.asarray([0., 0., 0.2]), radius=2.7)
    c = np.array(jcameras.pack_camera(cam[None],
                                      jcameras.fov_to_intrinsics(18.837)))
    return z, c


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_params_cross_by_name(pair):
    _, pj, gt, pt = pair
    flat_j = jax.tree_util.tree_flatten_with_path(pj)[0]
    assert len(flat_j) > 0
    for path, leaf in flat_j:
        node = pt
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
    # The port's own init draws the same tree of names and shapes.
    own = gt.init(torch.Generator().manual_seed(0), device="cpu")
    assert (jax.tree.map(lambda t: tuple(t.shape), own)
            == jax.tree.map(lambda t: tuple(t.shape), pt))


@pytest.mark.parametrize("psi,cutoff", [(1.0, None), (0.7, None), (0.5, 3)])
def test_mapping_matches_tgi(pair, psi, cutoff):
    gj, pj, gt, pt = pair
    z, c = _inputs(1)
    want = jax.jit(lambda p, z, c: gj.mapping(
        p, z, c, truncation_psi=psi, truncation_cutoff=cutoff))(pj, z, c)
    got = gt.mapping(pt, torch.from_numpy(z), torch.from_numpy(c),
                     truncation_psi=psi, truncation_cutoff=cutoff)
    _close(got, want)


def test_backbone_planes_match_tgi(pair):
    gj, pj, gt, pt = pair
    ws = np.random.RandomState(2).randn(1, gt.cfg.num_ws, 32).astype(
        np.float32)
    want = jax.jit(gj.backbone_planes)(pj, ws)
    got = gt.backbone_planes(pt, torch.from_numpy(ws))
    assert tuple(got.shape) == (1, 3, 8, 32, 32)
    _close(got, want)


@pytest.mark.parametrize("yaw", [0.0, 0.45])
def test_synthesis_matches_tgi(pair, yaw):
    gj, pj, gt, pt = pair
    z, c = _inputs(3, yaw)
    want = jax.jit(lambda p, z, c: gj(p, z, c, truncation_psi=0.7,
                                      truncation_cutoff=14, det=True))(
                                          pj, z, c)
    got = gt(pt, torch.from_numpy(z), torch.from_numpy(c),
             truncation_psi=0.7, truncation_cutoff=14, det=True)
    for k in ("image", "image_raw", "image_depth", "planes"):
        assert tuple(got[k].shape) == want[k].shape, k
        _close(got[k], want[k])
    # The planes short-cut skips the backbone and renders the same.
    ws = gt.mapping(pt, torch.from_numpy(z), torch.from_numpy(c), 0.7, 14)
    again = gt.synthesis(pt, ws, torch.from_numpy(c), planes=got["planes"])
    assert torch.equal(again["image"], got["image"])


def test_synthesis_sr_max_res_matches_tgi(pair):
    """sr_max_res=32 stops the SR pyramid at its input (level-0 exit)."""
    gj, pj, gt, pt = pair
    z, c = _inputs(4)
    want = jax.jit(lambda p, z, c: gj(p, z, c, det=True, sr_max_res=32))(
        pj, z, c)
    got = gt(pt, torch.from_numpy(z), torch.from_numpy(c), sr_max_res=32)
    assert tuple(got["image"].shape) == want["image"].shape == (1, 3, 32, 32)
    _close(got["image"], want["image"])


def test_generate_samples_writes_pngs(pair, tmp_path):
    pytest.importorskip("PIL")
    _, _, gt, pt = pair
    res = generate_samples(gt, pt, parse_range("0-1"), outdir=str(tmp_path),
                           angles=((0.35, 0.0), (-0.35, 0.0)), device="cpu")
    assert [r["seed"] for r in res] == [0, 0, 1, 1]
    for r in res:
        assert tuple(r["image"].shape) == (1, 3, 64, 64)
        assert torch.isfinite(r["image"]).all()
        d = r["image_depth"]
        assert ((d >= 2.25) & (d <= 3.3)).all()
        assert (tmp_path / f"seed{r['seed']:04d}_a{res.index(r) % 2}.png"
                ).stat().st_size > 0
    assert not torch.equal(res[0]["image"], res[1]["image"])
    # Without an outdir nothing is written.
    none = generate_samples(gt, pt, [2], outdir=None, device="cpu")
    assert none[0]["path"] is None


def test_refuses_reduced_precision(pair):
    """bf16 is no longer refused: ``fused_dtype="bfloat16"`` builds, and
    its backbone's blocks at ``fp16_resolution`` and above (8-32 here)
    return bf16 activations while the 4² block and the planes stay
    float32; any other dtype is refused."""
    from tgi_torch.nn.synthesis import block_dtype, synthesis_block_apply
    _, _, gt, pt = pair
    cfg = GeneratorConfig(**{**gt.cfg.__dict__, "fused_dtype": "bfloat16"})
    bb = cfg.backbone_cfg
    assert bb.fused_dtype == "bfloat16" and bb.fp16_resolution == 8
    ws = torch.from_numpy(np.random.RandomState(6).randn(
        1, cfg.num_ws, 32).astype(np.float32))
    x = img = None
    w_idx = 0
    for res in bb.resolutions:
        n = 1 if res == 4 else 2
        x, img = synthesis_block_apply(
            pt["backbone"][f"b{res}"], x, img, ws[:, w_idx:w_idx + n + 1],
            in_channels=bb.channels[res // 2] if res > 4 else 0,
            dtype=block_dtype("bfloat16", res >= bb.fp16_resolution))
        w_idx += n
        assert x.dtype == (torch.bfloat16 if res >= 8 else torch.float32)
        assert img.dtype == torch.float32
    planes = TriPlaneGenerator(cfg).backbone_planes(pt, ws)
    assert planes.dtype == torch.float32
    torch.testing.assert_close(planes.reshape(img.shape), img, rtol=0,
                               atol=0)
    # float16 mixed precision builds, as in tgi; other dtypes are refused.
    half = GeneratorConfig(fused_dtype="float16")
    assert half.backbone_cfg.fused_dtype == "float16"
    assert block_dtype(half.fused_dtype, True) == torch.float16
    for field, dtype in (("fused_dtype", "float64"),
                         ("plane_dtype", "float16")):
        with pytest.raises(ValueError):
            GeneratorConfig(**{field: dtype})


def test_gen_samples_cli_help(capsys):
    pytest.importorskip("click")
    from tgi_torch.apps.gen_samples import main
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    assert "--weights-seed" in capsys.readouterr().out
