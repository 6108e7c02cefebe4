"""tgi_torch's scheduled packed splat (``tgi_torch/ops/splat_sched.py``)
and layout helpers (``tgi_torch/ops/pack.py``) on the CPU.

``splat_sched_plain`` is what ``csrc/splat_sched.cu`` is held against on
the card. Here each schedule is held against tgi's Pallas bodies, run
through ``scripts/bench_splat_sched.py``'s ``run_kernel`` in interpret
mode: ``walk`` against ``splat_pack._kernel``, ``static9`` against the
script's ``_kernel_static`` and ``nbhd`` against its ``_kernel_nbhd``,
within 1e-5 x max(1, max|ref|) (the same bf16 payloads summed in fp32 in
another order). The script runs its bench at import, so it is not
imported: its functions are executed from its syntax tree with
H and W set small. Ragged entry counts are padded for the TPU as
``plane_splat_pack`` pads them (row H*W-1, zero payload).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tgi.ops.pallas import splat_pack
from tgi_torch.ops import pack
from tgi_torch.ops import splat_sched as ss
from tgi_torch.scripts import bench_splat_sched as bench

from torch_helpers import close, script_defs

TOL = 1e-5
G = 3
SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts", "bench_splat_sched.py")
BODIES = {"walk": lambda ns: splat_pack._kernel,
          "static9": lambda ns: ns["_kernel_static"],
          "nbhd": lambda ns: ns["_kernel_nbhd"]}


def _random_entries(seed, H, W, E):
    rng = np.random.RandomState(seed)
    rows = torch.from_numpy(rng.randint(0, H * W, (G, E)).astype(np.int32))
    wg = torch.from_numpy(rng.randn(G, E, 128).astype(np.float32))
    return rows, wg.bfloat16()


def _bench_entries(H, W):
    """The port bench's frustum-march entries, block-local order."""
    t = bench.make_inputs("cpu", 8, 8, 16, H)
    return t["rows"], t["wg"]


def _tpu(schedule, rows, wg, H, W):
    """tgi's body for ``schedule`` through the script's ``run_kernel``,
    in interpret mode, with the entries padded to 512-entry blocks."""
    ns = script_defs(SCRIPT, H=H, W=W)
    E = rows.shape[1]
    pad = (-E) % 512
    r = np.pad(rows.numpy(), ((0, 0), (0, pad)), constant_values=H * W - 1)
    w = np.pad(wg.float().numpy(), ((0, 0), (0, pad), (0, 0)))
    with pltpu.force_tpu_interpret_mode():
        out = ns["run_kernel"](BODIES[schedule](ns), jnp.asarray(r),
                               jnp.asarray(w).astype(jnp.bfloat16))
    return np.asarray(out)


CASES = [("bench", 64, 64, None), ("random", 64, 64, 1024),
         ("random", 64, 128, 1037)]


@pytest.mark.parametrize("schedule", ss.SCHEDULES)
@pytest.mark.parametrize("kind,H,W,E", CASES)
def test_plain_matches_tgi_bodies(schedule, kind, H, W, E):
    rows, wg = (_bench_entries(H, W) if kind == "bench"
                else _random_entries(E + W, H, W, E))
    got = ss.splat_sched(rows, wg, H, W, schedule)
    assert got.shape == (G, H * W, 128) and got.dtype == torch.float32
    close(got, _tpu(schedule, rows, wg, H, W), TOL)


def test_static9_drops_what_its_windows_miss():
    """static9 is wrong by design: on entries spread over the plane it
    drops some, which walk and nbhd keep."""
    rows, wg = _random_entries(1, 64, 128, 1024)
    full = ss.splat_sched(rows, wg, 64, 128, "walk")
    mask = ss.schedule_mask(rows, 64, 128, "static9")
    assert 0 < mask.sum() < mask.numel()
    assert not torch.allclose(ss.splat_sched(rows, wg, 64, 128, "static9"),
                              full)
    close(ss.splat_sched(rows, wg, 64, 128, "nbhd"), full.numpy(), TOL)


def test_out_of_range_rows_are_dropped():
    rows, wg = _random_entries(2, 64, 64, 600)
    bad = rows.clone()
    bad[:, 5] = -3
    bad[:, 7] = 64 * 64
    keep = torch.ones(600, dtype=torch.bool)
    keep[[5, 7]] = False
    for schedule in ("walk", "nbhd"):
        want = ss.splat_sched(rows[:, keep].contiguous(),
                              wg[:, keep].contiguous(), 64, 64, schedule)
        close(ss.splat_sched(bad, wg, 64, 64, schedule), want.numpy(), TOL)


def test_schedules_and_layouts_are_checked():
    rows, wg = _random_entries(3, 64, 64, 100)
    with pytest.raises(ValueError, match="unknown schedule"):
        ss.splat_sched(rows, wg, 64, 64, "static16")
    with pytest.raises(ValueError, match="unknown schedule"):
        ss.splat_sched_cuda(rows, wg, 64, 64, "walk9")
    with pytest.raises(ValueError, match="CUDA"):
        ss.splat_sched_cuda(rows, wg, 64, 64, "walk")
    with pytest.raises(ValueError, match="nbhd needs"):
        ss.splat_sched(rows, wg, 32, 32, "nbhd")
    with pytest.raises(ValueError, match="multiples of 16"):
        ss.splat_sched(rows, wg, 60, 64, "walk")
    with pytest.raises(TypeError):
        ss.splat_sched(rows, wg.float(), 64, 64, "walk")
    ss.splat_sched(rows % 256, wg, 16, 16, "walk")   # walk takes any 16x16


def test_cuda_wrapper_refuses_a_misaligned_payload():
    """The kernel loads four bf16 of a row at once, so the wrapper
    refuses a payload that does not start on an 8-byte boundary, before
    it looks for a card, and launches nothing."""
    rows, wg = _random_entries(4, 64, 64, 100)
    flat = torch.zeros(wg.numel() + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(wg.shape)
    shifted.copy_(wg)
    before = ss.SPLAT_SCHED_LAUNCHES
    with pytest.raises(ValueError, match="8-byte"):
        ss.splat_sched_cuda(rows, shifted, 64, 64, "walk")
    with pytest.raises(ValueError, match="CUDA"):
        ss.splat_sched_cuda(rows, wg, 64, 64, "walk")
    assert ss.SPLAT_SCHED_LAUNCHES == before
    close(ss.splat_sched(rows, shifted, 64, 64, "walk"),
          ss.splat_sched(rows, wg, 64, 64, "walk").numpy(), 0)


@pytest.mark.parametrize("H,W", [(32, 48), (64, 64)])
def test_pack_helpers_match_splat_pack(H, W):
    rng = np.random.RandomState(H + W)
    P = 300
    y0 = rng.randint(-1, H, (G, P)).astype(np.int32)
    x0 = rng.randint(-1, W, (G, P)).astype(np.int32)
    w4 = rng.rand(G, P, 4).astype(np.float32)
    ty, tx = torch.from_numpy(y0), torch.from_numpy(x0)
    want = splat_pack.corner_slots(jnp.asarray(y0), jnp.asarray(x0), H, W)
    for g_, w_ in zip(pack.corner_slots(ty, tx, H, W), want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    cell, w4s = pack.pack_footprint(ty, tx, torch.from_numpy(w4), H, W)
    j_cell, j_w4s = splat_pack.pack_footprint(
        jnp.asarray(y0), jnp.asarray(x0), jnp.asarray(w4), H, W)
    np.testing.assert_array_equal(cell.numpy(), np.asarray(j_cell))
    np.testing.assert_array_equal(w4s.numpy(), np.asarray(j_w4s))
    yc, xc = ty.clamp(0, H - 1), tx.clamp(0, W - 1)
    np.testing.assert_array_equal(
        pack.tiled_cell(yc, xc, W).numpy(),
        np.asarray(splat_pack._tiled_cell(jnp.asarray(yc.numpy()),
                                          jnp.asarray(xc.numpy()), W)))
    acc = rng.randn(2, H * W, 128).astype(np.float32)
    np.testing.assert_array_equal(
        pack.untile_rows(torch.from_numpy(acc), H, W).numpy(),
        np.asarray(splat_pack.untile_rows(jnp.asarray(acc), H, W)))


@pytest.mark.parametrize("P,layout", [(8 * 16 * 5, (8, 16, 5)),
                                      (8 * 12 * 2, (8, 12, 2)),
                                      (100, None)])
def test_reorder_perm_shape_matches_splat_pack(P, layout):
    assert (pack.reorder_perm_shape(P, layout)
            == splat_pack.reorder_perm_shape(P, layout))
    if pack.reorder_perm_shape(P, layout) is not None:
        dims, axes = splat_pack.reorder_perm_shape(P, layout)
        want = np.arange(P).reshape(dims).transpose(axes).reshape(P)
        np.testing.assert_array_equal(pack.block_local_perm(layout).numpy(),
                                      want)
