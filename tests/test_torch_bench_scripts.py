"""The port's kernel benches (``tgi_torch/scripts/``) on the CPU.

Each bench's ``main`` runs at a tiny shape with ``--device cpu``, where
every kernel wrapper takes its plain version: its correctness lines must
be 0 and it must report every variant. Its input helpers are held
against those of the TPU script it twins (``scripts/bench_gather_vmem.py``
and ``scripts/bench_splat_sched.py``, executed from their syntax trees at
small shapes, since both run their bench at import; the files are only
read).
"""

import importlib
import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tgi.ops.pallas.splat_pack import reorder_perm_shape
from tgi_torch.ops.pack import block_local_perm
from tgi_torch.scripts import bench_gather_vmem as bgv
from tgi_torch.scripts import bench_splat_sched as bss

from torch_helpers import script_defs

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")
TINY = ["--device", "cpu", "--rays", "8", "16", "--samples", "4"]


def test_gather_bench_main_on_the_cpu(capsys):
    res = bgv.main(TINY + ["--res", "32"])
    out = capsys.readouterr().out
    assert res["P"] == 8 * 16 * 4
    assert set(res["max_abs"].values()) == {0.0}
    assert [k[0] for k in res["ms"]][:7] == list("ABCDEFG")
    assert len(res["ms"]) == 8 and all(
        math.isfinite(v) and v > 0 for v in res["ms"].values())
    assert 1 <= res["passes"]["block-local"] <= res["passes"]["ray-major"]
    for name in res["ms"]:
        assert name in out
    assert out.count("max|d| vs indexing: 0.0") == 4


def test_splat_bench_main_on_the_cpu(capsys):
    res = bss.main(TINY + ["--res", "64"])
    out = capsys.readouterr().out
    assert set(res["max_abs"].values()) == {0.0}
    assert [k[0] for k in res["ms"]][:3] == list("ABC")
    assert len(res["ms"]) == 5
    assert "C max|d| vs A: 0.0" in out


def test_importing_a_bench_runs_nothing(capsys):
    importlib.reload(bgv)
    importlib.reload(bss)
    assert capsys.readouterr().out == ""


def test_importing_the_variants_script_runs_nothing(capsys):
    from tgi_torch.scripts import triplane_variants as tv
    importlib.reload(tv)
    assert capsys.readouterr().out == ""
    assert "gather_tilewalk.cu" in tv.SOURCES
    assert [math.prod(layout) for layout in tv.TILEWALK_LAYOUTS] == [
        786_432, 196_608]
    with pytest.raises(SystemExit, match="CUDA"):
        tv.main([])


@pytest.mark.parametrize("Ry,Rx,S,H", [(8, 8, 4, 32), (16, 8, 6, 64)])
def test_gather_bench_inputs_match_the_tpu_script(Ry, Rx, S, H):
    P = Ry * Rx * S
    dims, axes = reorder_perm_shape(P, (Ry, Rx, S))
    ns = script_defs(os.path.join(SCRIPTS, "bench_gather_vmem.py"), Ry=Ry,
                     Rx=Rx, S=S, P=P, H=H, W=H, dims=dims, axes=axes)
    np.testing.assert_array_equal(bgv.ray_coords(Ry, Rx, S).numpy(),
                                  np.asarray(ns["ray_coords"]()))
    e = np.random.RandomState(0).randn(3, H * H, 8).astype(np.float32)
    np.testing.assert_array_equal(
        bgv.untile_plane(torch.from_numpy(e), H, H).numpy(),
        np.asarray(ns["untile_plane"](jnp.asarray(e))))
    o = np.random.RandomState(1).randn(3, P, 4).astype(np.float32)
    np.testing.assert_array_equal(
        bgv.unperm(torch.from_numpy(o), (Ry, Rx, S)).numpy(),
        np.asarray(ns["unperm"](jnp.asarray(o))))
    # The cells the twin fetches are the script's.
    t = bgv.make_inputs("cpu", Ry, Rx, S, H)
    x0, y0, _, _ = ns["_point_indices"](ns["ray_coords"](), H, H)
    y0c, x0c = np.clip(y0, 0, H - 1), np.clip(x0, 0, H - 1)
    np.testing.assert_array_equal(t["cells"].numpy(), y0c * H + x0c)
    np.testing.assert_array_equal(
        t["cells_tiled"].numpy(),
        np.asarray(ns["_tiled_cell"](jnp.asarray(y0c), jnp.asarray(x0c), H)))


def test_splat_bench_inputs_match_the_tpu_script():
    Ry, Rx, S, H = 8, 16, 4, 64
    ns = script_defs(os.path.join(SCRIPTS, "bench_splat_sched.py"), Ry=Ry,
                     Rx=Rx, S=S, P=Ry * Rx * S, H=H, W=H)
    y0, x0 = bss.ray_cells(Ry, Rx, S, H, H)
    j_y0, j_x0 = ns["ray_cells"]()
    np.testing.assert_array_equal(y0.numpy(), np.asarray(j_y0))
    np.testing.assert_array_equal(x0.numpy(), np.asarray(j_x0))
    t = bss.make_inputs("cpu", Ry, Rx, S, H)
    perm = block_local_perm((Ry, Rx, S))
    want = ns["pack_footprint"](j_y0, j_x0, jnp.zeros((3, Ry * Rx * S, 4)),
                                H, H)[0]
    np.testing.assert_array_equal(t["rows"].numpy(),
                                  np.asarray(want)[:, perm.numpy()])
