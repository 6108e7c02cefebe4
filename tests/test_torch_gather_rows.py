"""tgi_torch's row fetches (``tgi_torch/ops/gather_rows.py``) on the CPU.

``gather_rows_plain`` and the tile walk's plain version are what the
CUDA kernels ``csrc/gather_rows.cu`` and ``csrc/gather_tilewalk.cu`` are
held against on the card. Here they are held, bit for bit, against
tgi's Pallas kernels run in interpret mode: ``gather_rows_vmem`` (fp32,
rows of 128 and 64), ``gather_rows_vmem_bf16`` and ``gather_rows_mxu``
(bf16 and fp32, block-local and random point order). The walk's pass
count per 512-point block is held against a step-by-step replay of the
TPU kernel's walk, also on a one-window plane, a 1,024-window plane and
blocks whose first cell is out of range. Point counts are ragged for the
512-point blocks.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tgi.ops import grid_sample as jgs
from tgi.ops.pallas import gather_vmem
from tgi_torch.ops import _native
from tgi_torch.ops import gather_rows as gr
from tgi_torch.ops import pack

G = 3


def _bits(x):
    """A tensor or array's bits as a numpy array (bf16 as int16)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


def _plane(seed, HW, L, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(G, HW, L).astype(np.float32)).to(dtype)


def _local_cells(seed, H, W, P):
    """Tile-numbered cells with spatial locality: random walks."""
    rng = np.random.RandomState(seed)
    y = np.clip(np.cumsum(rng.randint(-1, 2, (G, P)), 1) + H // 2, 0, H - 1)
    x = np.clip(np.cumsum(rng.randint(-1, 2, (G, P)), 1) + W // 2, 0, W - 1)
    return pack.tiled_cell(torch.from_numpy(y), torch.from_numpy(x), W).int()


def _interpret(fn, *args):
    with pltpu.force_tpu_interpret_mode():
        return fn(*args)


@pytest.mark.parametrize("HW,L,P", [(1024, 128, 1037), (4096, 64, 520)])
def test_gather_rows_fp32_matches_gather_rows_vmem(HW, L, P):
    exp = _plane(1, HW, L)
    cells = torch.from_numpy(
        np.random.RandomState(2).randint(0, HW, (G, P)).astype(np.int32))
    want = _interpret(gather_vmem.gather_rows_vmem, jnp.asarray(exp.numpy()),
                      jnp.asarray(cells.numpy()))
    got = gr.gather_rows(exp, cells)
    assert got.dtype == torch.float32 and got.shape == (G, P, L)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_gather_rows_bf16_matches_gather_rows_vmem_bf16():
    exp = _plane(3, 1024, 128, torch.bfloat16)
    cells = torch.from_numpy(
        np.random.RandomState(4).randint(0, 1024, (G, 600)).astype(np.int32))
    want = _interpret(gather_vmem.gather_rows_vmem_bf16,
                      jnp.asarray(exp.float().numpy()).astype(jnp.bfloat16),
                      jnp.asarray(cells.numpy()))
    got = gr.gather_rows(exp, cells)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("order", ["local", "random"])
def test_tilewalk_matches_gather_rows_mxu(dtype, order):
    """Bitwise equal to tgi's one-hot tile walk, in either point order,
    and the same rows as the row-major fetch of the untiled plane."""
    H = W = 32
    P = 1037
    exp_t = _plane(5, H * W, 128, dtype)
    cells_t = _local_cells(6, H, W, P)
    if order == "random":
        cells_t = cells_t[:, torch.from_numpy(
            np.random.RandomState(7).permutation(P))].contiguous()
    j_exp = jnp.asarray(exp_t.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = _interpret(gather_vmem.gather_rows_mxu, j_exp,
                      jnp.asarray(cells_t.numpy()))
    got, passes = gr.gather_rows_tilewalk(exp_t, cells_t, return_passes=True)
    assert got.dtype == dtype and passes.shape == (G, 3)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # Tile numbering is a relabelling of the row-major cells.
    exp = pack.untile_rows(exp_t, H, W)
    flat = torch.arange(H * W).reshape(H // 16, 16, W // 16, 16)
    row_major = flat.permute(0, 2, 1, 3).reshape(-1)   # tiled row -> cell
    cells = row_major[cells_t.long()].int()
    assert torch.equal(gr.gather_rows(exp, cells), got)


def _tpu_walk_passes(rows, nrows, block=512, window=256):
    """Replay of gather_rows_mxu's while loop, per block: the passes. The
    walk is taken over the block's rows in [0, nrows) (on any other row
    the TPU kernel never finishes), from the first of them."""
    out = []
    for b in range(0, len(rows), block):
        r = [x for x in rows[b:b + block] if 0 <= x < nrows]
        undone = set(r)
        base = min(r[0] // window * window, nrows - window) if r else 0
        n = 0
        while undone:
            undone -= {x for x in undone if base <= x < base + window}
            n += 1
            if undone:
                base = min(min(undone) // window * window, nrows - window)
        out.append(n)
    return out


def test_tilewalk_passes_replay_the_tpu_walk():
    H = W = 64
    cells_t = _local_cells(8, H, W, 2000)
    rand = torch.from_numpy(np.random.RandomState(9).randint(
        0, H * W, (G, 2000)).astype(np.int32))
    for cells in (cells_t, rand):
        got = gr.tilewalk_passes_plain(cells, H * W)
        want = [_tpu_walk_passes(c.tolist(), H * W) for c in cells]
        assert got.tolist() == want
    # Locality is what the walk pays for: the random order takes more.
    assert (gr.tilewalk_passes_plain(cells_t, H * W).float().mean()
            < gr.tilewalk_passes_plain(rand, H * W).float().mean())


@pytest.mark.parametrize("case", ["one window", "1024 windows",
                                  "first cells out of range"])
def test_tilewalk_passes_replay_the_tpu_walk_at_edge_shapes(case):
    """A 16x16 plane (one window), a 512x512 plane (1,024 windows; cells
    drawn uniformly, so a block names hundreds, and by walks), and
    blocks whose first cell lies below or above the plane."""
    rng = np.random.RandomState(14)
    if case == "one window":
        H = W = 16
        cells = np.concatenate([_local_cells(15, H, W, 1037).numpy(),
                                rng.randint(-2, H * W + 2, (G, 1037))], 1)
    elif case == "1024 windows":
        H = W = 512
        cells = np.concatenate([rng.randint(0, H * W, (G, 1100)),
                                _local_cells(16, H, W, 900).numpy()], 1)
    else:
        H = W = 32
        cells = _local_cells(17, H, W, 1600).numpy()
        cells[:, ::512] = -1
        cells[1, 512] = H * W
    cells = torch.from_numpy(cells.astype(np.int32))
    got = gr.tilewalk_passes_plain(cells, H * W)
    want = [_tpu_walk_passes(c.tolist(), H * W) for c in cells]
    assert got.tolist() == want
    top = {"one window": 1, "1024 windows": 512,
           "first cells out of range": 4}[case]
    assert 1 <= got.max() <= top
    if case == "1024 windows":
        assert got.max() > 256   # more windows than a 256² plane has


def test_tilewalk_matches_gather_rows_mxu_on_one_window():
    """A 16x16 plane is one 256-row window: the TPU walk's one pass."""
    exp_t = _plane(19, 256, 128)
    cells_t = _local_cells(20, 16, 16, 700)
    want = _interpret(gather_vmem.gather_rows_mxu, jnp.asarray(exp_t.numpy()),
                      jnp.asarray(cells_t.numpy()))
    got, passes = gr.gather_rows_tilewalk(exp_t, cells_t, return_passes=True)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert passes.tolist() == [[1, 1]] * G


def test_tilewalk_wrapper_takes_rows_of_any_width(monkeypatch):
    """The kernel stages no window in shared memory, so the wrapper hands
    rows whose 256-row window is 1 MB (fp32 rows of 1024) to the C entry
    point, with their width in bytes."""
    calls = []

    class Lib:
        def tgi_gather_tilewalk(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(gr, "_cuda_args", lambda exp, cells: (
        exp.shape[0], exp.shape[1], cells.shape[1],
        exp.shape[2] * exp.element_size()))
    monkeypatch.setattr(_native, "library", lambda src: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(gr, "TILEWALK_LAUNCHES", 0)
    exp = torch.zeros(G, 256, 1024)
    out, passes = gr.gather_rows_tilewalk_cuda(
        exp, torch.zeros(G, 600, dtype=torch.int32), return_passes=True)
    assert out.shape == (G, 600, 1024) and passes.shape == (G, 2)
    assert calls[0][4:8] == (G, 256, 600, 4096)
    assert gr.TILEWALK_LAUNCHES == 1


def test_out_of_range_cells_give_zero_rows():
    exp = _plane(10, 512, 128) + 5.0
    cells = torch.tensor([[0, -1, 511, 512, 7]] * G, dtype=torch.int32)
    for got in (gr.gather_rows(exp, cells),
                gr.gather_rows_tilewalk(exp, cells)):
        assert torch.equal(got[:, [1, 3]], torch.zeros(G, 2, 128))
        assert torch.equal(got[:, [0, 2, 4]], exp[:, [0, 511, 7]])
    _, passes = gr.gather_rows_tilewalk(exp, cells, return_passes=True)
    assert passes.tolist() == [[2]] * G


def test_expand_footprint_matches_tgi():
    img = np.random.RandomState(11).randn(2, 8, 5, 7).astype(np.float32)
    want = jgs._expand_footprint(jnp.asarray(img))
    got = pack.expand_footprint(torch.from_numpy(img))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cuda_wrappers_raise_without_a_cuda_tensor():
    exp = _plane(12, 256, 128)
    cells = torch.zeros(G, 10, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        gr.gather_rows_cuda(exp, cells)
    with pytest.raises(ValueError, match="CUDA"):
        gr.gather_rows_tilewalk_cuda(exp, cells)


def test_arguments_are_checked():
    exp = _plane(13, 256, 128)
    with pytest.raises(TypeError):
        gr.gather_rows(exp, torch.zeros(G, 4, dtype=torch.int64))
    with pytest.raises(TypeError):
        gr.gather_rows(exp.double(), torch.zeros(G, 4, dtype=torch.int32))
    with pytest.raises(ValueError):
        gr.gather_rows(exp, torch.zeros(2, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of 256"):
        gr.gather_rows_tilewalk(exp[:, :100], torch.zeros(G, 4,
                                                          dtype=torch.int32))
