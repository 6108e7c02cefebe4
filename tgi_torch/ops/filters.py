"""FIR filter preparation for the resampling ops.

A copy of ``tgi/ops/filters.py`` (numpy only), kept here so the port
stands alone. Behavioral parity target: torch_utils/ops/upfirdn2d.py:72-117
(setup_filter) in the reference repo. Filters are tiny host-side
constants; the resampling ops turn them into tensors on their input's
device.
"""

from __future__ import annotations

import numpy as np


def setup_filter(f, normalize: bool = True, flip_filter: bool = False,
                 gain: float = 1.0, separable: bool | None = None) -> np.ndarray:
    """Prepare a 2D FIR filter for :func:`tgi_torch.ops.upfirdn2d.upfirdn2d`.

    Args:
        f: filter taps — ``[fh, fw]`` (non-separable), ``[taps]``
           (separable), scalar (impulse) or ``None`` (identity).
        normalize: scale so a constant (DC) signal keeps its magnitude.
        flip_filter: flip the filter taps.
        gain: overall magnitude scaling.
        separable: force/deny the separable representation; default picks
            separable for 1D inputs with >= 8 taps.

    Returns:
        float32 numpy array of shape ``[fh, fw]`` or ``[taps]``.
    """
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float32)
    assert f.ndim in (0, 1, 2) and f.size > 0
    if f.ndim == 0:
        f = f[np.newaxis]

    if separable is None:
        separable = (f.ndim == 1 and f.size >= 8)
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    assert f.ndim == (1 if separable else 2)

    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f[::-1] if f.ndim == 1 else f[::-1, ::-1]
    f = f * (gain ** (f.ndim / 2))
    return np.ascontiguousarray(f, dtype=np.float32)


def parse_scaling(scaling):
    if isinstance(scaling, int):
        scaling = [scaling, scaling]
    sx, sy = scaling
    assert sx >= 1 and sy >= 1
    return int(sx), int(sy)


def parse_padding(padding):
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = list(padding)
    if len(padding) == 2:
        padx, pady = padding
        padding = [padx, padx, pady, pady]
    padx0, padx1, pady0, pady1 = padding
    return int(padx0), int(padx1), int(pady0), int(pady1)


def filter_size(f) -> tuple[int, int]:
    """Return (fw, fh) of a prepared filter (or identity for None)."""
    if f is None:
        return 1, 1
    assert f.ndim in (1, 2)
    fw = int(f.shape[-1])
    fh = int(f.shape[0])
    return fw, fh
