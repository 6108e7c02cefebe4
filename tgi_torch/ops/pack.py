"""Layout helpers of the packed tri-plane splat and the tile-walk gather
(twin of the helpers in ``tgi/ops/pallas/splat_pack.py`` and of
``tgi/ops/grid_sample.py::_expand_footprint``).

A plane of ``H x W`` cells is "expanded" to ``[G, H*W, 4C]``: each cell
carries its 2x2 bilinear footprint, so one row fetch reads a point's
four corners. The expanded rows are numbered either row-major (``y*W +
x``) or in 16x16-cell tiles (:func:`tiled_cell`), 256 rows per tile, so
that a spatially local block of points touches a handful of 256-row
windows. ``ENTRY_BLOCK`` points or splat entries make one block of the
tile-walk kernels. Every function takes and returns torch tensors.
"""

from __future__ import annotations

import torch

ENTRY_BLOCK = 512      # points (gather) or entries (splat) per block
TILE = 16              # cells per tile side
WINDOW = TILE * TILE   # rows per tile, the tile walk's window


def expand_footprint(img: torch.Tensor) -> torch.Tensor:
    """``[N, C, H, W]`` -> ``[N, H*W, 4C]``: each cell carries its 2x2
    bilinear footprint (self, right, down, down-right; zeros past the
    border), row-major."""
    N, C, H, W = img.shape
    nhwc = img.permute(0, 2, 3, 1)
    e = torch.zeros((N, H, W, 4, C), dtype=img.dtype, device=img.device)
    e[:, :, :, 0] = nhwc
    e[:, :, :-1, 1] = nhwc[:, :, 1:]
    e[:, :-1, :, 2] = nhwc[:, 1:]
    e[:, :-1, :-1, 3] = nhwc[:, 1:, 1:]
    return e.reshape(N, H * W, 4 * C)


def tiled_cell(y: torch.Tensor, x: torch.Tensor, W: int) -> torch.Tensor:
    """Row-major cell ``(y, x)`` -> its row in 16x16-tile numbering."""
    return (((y // TILE) * (W // TILE) + (x // TILE)) * WINDOW
            + (y % TILE) * TILE + (x % TILE))


def untile_rows(acc: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """``[G, H*W, L]`` in tile numbering -> row-major cell order."""
    G, L = acc.shape[0], acc.shape[-1]
    acc = acc.reshape(G, H // TILE, W // TILE, TILE, TILE, L)
    return acc.permute(0, 1, 3, 2, 4, 5).reshape(G, H * W, L)


def corner_slots(y0: torch.Tensor, x0: torch.Tensor, H: int, W: int):
    """Per-corner slot of the footprint relative to the CLIPPED anchor.

    Returns ``(y0c, x0c, slots [..., 4] in 0..3, valid [..., 4])``:
    corner k (tl, tr, bl, br order) of the true footprint lives at slot
    ``slots[..., k]`` of the expanded cell ``(y0c, x0c)`` when valid;
    only the y0 = -1 / x0 = -1 borders remap (the clip shifts the
    anchor)."""
    y0c = y0.clamp(0, H - 1)
    x0c = x0.clamp(0, W - 1)
    slots, valids = [], []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        ry, rx = y0 + dy, x0 + dx
        valids.append((ry >= 0) & (ry < H) & (rx >= 0) & (rx < W))
        slots.append((ry - y0c).clamp(0, 1) * 2 + (rx - x0c).clamp(0, 1))
    return y0c, x0c, torch.stack(slots, -1), torch.stack(valids, -1)


def pack_footprint(y0: torch.Tensor, x0: torch.Tensor, w4: torch.Tensor,
                   H: int, W: int):
    """Clip the footprint anchor into the plane and move the corner
    weights to their slots relative to the clipped anchor.

    Returns ``(cell_tiled [G, P], w4_slots [G, P, 4])``. Corners outside
    the plane carry zero weight."""
    y0c, x0c, slots, valid = corner_slots(y0, x0, H, W)
    w4 = torch.where(valid, w4, torch.zeros_like(w4))
    w4s = torch.stack([torch.where(slots == s, w4, torch.zeros_like(w4))
                       .sum(-1) for s in range(4)], -1)
    return tiled_cell(y0c, x0c, W), w4s


def reorder_perm_shape(P: int, point_layout):
    """``(reshape dims, transpose axes)`` turning ray-major ``[Ry*Rx*S]``
    point order into ``[tileY, tileX, S, 8, 8]`` block-local order, or
    None when the layout does not tile."""
    if point_layout is None:
        return None
    Ry, Rx, S = point_layout
    if Ry * Rx * S != P or Ry % 8 or Rx % 8:
        return None
    return (Ry // 8, 8, Rx // 8, 8, S), (0, 2, 4, 1, 3)


def block_local_perm(point_layout) -> torch.Tensor:
    """The permutation (int64 ``[P]``) that :func:`reorder_perm_shape`
    describes: ``x[:, perm]`` is ``x`` in block-local order."""
    Ry, Rx, S = point_layout
    P = Ry * Rx * S
    perm = reorder_perm_shape(P, point_layout)
    if perm is None:
        raise ValueError(f"layout {point_layout} does not tile into 8x8 "
                         f"ray blocks")
    dims, axes = perm
    return torch.arange(P).reshape(dims).permute(axes).reshape(P)
