"""The port's twins of ``tgi``'s kernel benches (``scripts/``).

Each bench runs with ``python -m tgi_torch.scripts.<name>``, on the card
by default (``--device cuda``) or, at small shapes, on the CPU
(``--device cpu``), where every kernel wrapper takes its plain version
and times are the host's. Importing a bench runs nothing.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch


def frustum_points(Ry: int = 64, Rx: int = 64, S: int = 48) -> np.ndarray:
    """The TPU benches' frustum march: world points ``[Ry*Rx*S, 3]``
    (float64, ray-major) of a pinhole camera's Ry x Rx rays at S depths,
    scaled by 2 (about a box_warp of 1)."""
    u, v = np.meshgrid(np.linspace(-1, 1, Rx), np.linspace(-1, 1, Ry))
    d = np.stack([u * 0.35, v * 0.35, np.ones_like(u)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.array([0.15, -0.1, -2.7])
    t = np.linspace(2.2, 3.2, S)
    pts = o + t[None, None, :, None] * d[:, :, None, :]   # [Ry, Rx, S, 3]
    return pts.reshape(Ry * Rx * S, 3) * 2.0


# Every bench time is the median of ITERS calls after WARMUP calls, and
# every draw comes from SEED, as tgi's scripts fix PRNGKey(0).
ITERS, WARMUP, SEED = 20, 3, 0


def median_ms(fn, device: torch.device) -> float:
    """Median milliseconds of ``fn()`` over ``ITERS`` calls after
    ``WARMUP`` calls: CUDA events around each call on a CUDA device, the
    host clock on the CPU."""
    for _ in range(WARMUP):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(ITERS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    else:
        for _ in range(ITERS):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_label(device: torch.device) -> str:
    """What a time was measured on: the card's name, or the host."""
    if device.type == "cuda":
        return f"{torch.cuda.get_device_name(device)} (CUDA events)"
    return f"{device} (host clock; not a device time)"
