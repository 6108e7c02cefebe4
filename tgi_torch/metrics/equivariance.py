"""Equivariance metrics, EQ-T, EQ-T_frac and EQ-R (twin of
``tgi/metrics/equivariance.py``).

Behavioral parity target: metrics/equivariance.py (the Alias-Free GAN
appendix-E operators): masked integer translation, windowed-sinc
fractional translation, FFT-constructed oriented bandlimit filters,
affine resampling and pseudo-rotation. The harness accumulates float64
(sum sq err, mask sum) pairs and reports PSNR = 20 log10(2) - 10
log10(mse), as equivariance.py:255-266.

The filters are host numpy, made once per transform as ``tgi`` makes
them; the images, the resampling and the sums run on the generator's
device. Transforms are drawn host-side per batch
(``np.random.RandomState(seed)``, ``tgi``'s draws) and enter the
generator as its input layer's transform matrix; z comes from a CPU
``torch.Generator`` or from ``samples``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tgi_torch.ops.grid_sample import grid_sample_2d
from tgi_torch.ops.upfirdn2d import filter2d, upsample2d


def _sinc_np(x):
    y = np.abs(x * np.pi)
    z = np.sin(y) / np.clip(y, 1e-30, None)
    return np.where(y < 1e-30, np.ones_like(z), z)


def _lanczos_window_np(x, a):
    x = np.abs(x) / a
    return np.where(x < 1, _sinc_np(x), np.zeros_like(x))


def rotation_matrix(angle):
    """3x3 rotation (equivariance.py:33-41)."""
    m = np.eye(3, dtype=np.float32)
    m[0, 0] = np.cos(angle)
    m[0, 1] = np.sin(angle)
    m[1, 0] = -np.sin(angle)
    m[1, 1] = np.cos(angle)
    return m


def apply_integer_translation(x, tx, ty):
    """T_x with whole-pixel shifts + validity mask (equivariance.py:
    46-62). tx/ty: python floats, fraction of image size."""
    N, C, H, W = x.shape
    ix = int(np.round(tx * W))
    iy = int(np.round(ty * H))
    z = torch.zeros_like(x)
    m = torch.zeros_like(x)
    if abs(ix) < W and abs(iy) < H:
        y = x[:, :, max(-iy, 0):H + min(-iy, 0), max(-ix, 0):W + min(-ix, 0)]
        z[:, :, max(iy, 0):H + min(iy, 0), max(ix, 0):W + min(ix, 0)] = y
        m[:, :, max(iy, 0):H + min(iy, 0), max(ix, 0):W + min(ix, 0)] = 1.0
    return z, m


def apply_fractional_translation(x, tx, ty, a=3):
    """T_x with subpixel shifts via windowed-sinc filtering
    (equivariance.py:67-97)."""
    N, C, H, W = x.shape
    txp = tx * W
    typ = ty * H
    ix = int(np.floor(txp))
    iy = int(np.floor(typ))
    fx = txp - ix
    fy = typ - iy
    b = a - 1

    z = torch.zeros_like(x)
    zx0 = max(ix - b, 0)
    zy0 = max(iy - b, 0)
    zx1 = min(ix + a, 0) + W
    zy1 = min(iy + a, 0) + H
    if zx0 < zx1 and zy0 < zy1:
        taps = np.arange(a * 2) - b
        filter_x = (_sinc_np(taps - fx) * _sinc_np((taps - fx) / a)
                    )[None, :].astype(np.float32)
        filter_y = (_sinc_np(taps - fy) * _sinc_np((taps - fy) / a)
                    )[:, None].astype(np.float32)
        y = x
        y = filter2d(y, filter_x / filter_x.sum(), padding=[b, a, 0, 0])
        y = filter2d(y, filter_y / filter_y.sum(), padding=[0, 0, b, a])
        y = y[:, :, max(b - iy, 0):H + b + a + min(-iy - a, 0),
              max(b - ix, 0):W + b + a + min(-ix - a, 0)]
        z[:, :, zy0:zy1, zx0:zx1] = y

    m = torch.zeros_like(x)
    mx0 = max(ix + a, 0)
    my0 = max(iy + a, 0)
    mx1 = min(ix - b, 0) + W
    my1 = min(iy - b, 0) + H
    if mx0 < mx1 and my0 < my1:
        m[:, :, my0:my1, mx0:mx1] = 1.0
    return z, m


def construct_affine_bandlimit_filter(mat, a=3, amax=16, aflt=64, up=4,
                                      cutoff_in=1, cutoff_out=1):
    """Oriented windowed-sinc bandlimit filter (equivariance.py:
    103-132). Pure numpy (static per transform)."""
    assert a <= amax < aflt
    mat = np.asarray(mat, np.float32)

    taps = np.roll((np.arange(aflt * up * 2 - 1) + 1) / up - aflt,
                   1 - aflt * up)
    # torch.meshgrid default indexing='ij': yi varies along rows.
    yi, xi = np.meshgrid(taps, taps, indexing="ij")
    pts = np.stack([xi, yi], axis=2) @ mat[:2, :2].T
    xo, yo = pts[..., 0], pts[..., 1]

    fi = _sinc_np(xi * cutoff_in) * _sinc_np(yi * cutoff_in)
    fo = _sinc_np(xo * cutoff_out) * _sinc_np(yo * cutoff_out)
    f = np.fft.ifftn(np.fft.fftn(fi) * np.fft.fftn(fo)).real

    wi = _lanczos_window_np(xi, a) * _lanczos_window_np(yi, a)
    wo = _lanczos_window_np(xo, a) * _lanczos_window_np(yo, a)
    w = np.fft.ifftn(np.fft.fftn(wi) * np.fft.fftn(wo)).real

    f = f * w
    c = (aflt - amax) * up
    f = np.roll(f, [aflt * up - 1] * 2, axis=(0, 1))[c:-c, c:-c]
    f = np.pad(f, [(0, 1), (0, 1)]).reshape(amax * 2, up, amax * 2, up)
    f = f / f.sum(axis=(0, 2), keepdims=True) / (up ** 2)
    f = f.reshape(amax * 2 * up, amax * 2 * up)[:-1, :-1]
    return f.astype(np.float32)


def _affine_grid(theta, N, H, W, device):
    """F.affine_grid(align_corners=False) for a single static 2x3."""
    f32 = dict(dtype=torch.float32, device=device)
    ys = (2 * torch.arange(H, **f32) + 1) / H - 1
    xs = (2 * torch.arange(W, **f32) + 1) / W - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # [H, W, 3]
    g = torch.einsum("ij,hwj->hwi",
                     torch.as_tensor(np.asarray(theta[:2], np.float32),
                                     device=device), base)
    return g[None].expand(N, H, W, 2)                          # [N, H, W, 2]


def _grid_sample_nearest(img, grid):
    """F.grid_sample(mode='nearest', padding_mode='zeros',
    align_corners=False); ties round half to even (``std::nearbyint``,
    as ``jnp.round`` and ``torch.round``)."""
    N, C, H, W = img.shape
    ix = (grid[..., 0] + 1) * (W / 2) - 0.5
    iy = (grid[..., 1] + 1) * (H / 2) - 0.5
    x0 = torch.round(ix).long()
    y0 = torch.round(iy).long()
    ok = (x0 >= 0) & (x0 < W) & (y0 >= 0) & (y0 < H)
    xc = x0.clamp(0, W - 1)
    yc = y0.clamp(0, H - 1)
    flat = img.reshape(N, C, H * W)
    idx = (yc * W + xc).reshape(N, 1, -1).expand(N, C, -1)
    out = torch.gather(flat, 2, idx).reshape(N, C, *grid.shape[1:3])
    return out * ok[:, None].to(img.dtype)


def apply_affine_transformation(x, mat, up=4, **filter_kwargs):
    """equivariance.py:137-165."""
    N, C, H, W = x.shape
    mat = np.asarray(mat, np.float32)

    f = construct_affine_bandlimit_filter(mat, up=up, **filter_kwargs)
    assert f.ndim == 2 and f.shape[0] == f.shape[1] and f.shape[0] % 2 == 1
    p = f.shape[0] // 2

    theta = np.linalg.inv(mat)
    theta[:2, 2] *= 2
    theta[0, 2] += 1 / up / W
    theta[1, 2] += 1 / up / H
    theta[0, :] *= W / (W + p / up * 2)
    theta[1, :] *= H / (H + p / up * 2)

    y = upsample2d(x, f, up=up, padding=p)
    g = _affine_grid(theta, N, H, W, x.device)
    z = grid_sample_2d(y, g)

    m = torch.zeros_like(y)
    c = p * 2 + 1
    m[:, :, c:-c, c:-c] = 1.0
    m = _grid_sample_nearest(m, g)
    return z, m


def apply_fractional_rotation(x, angle, a=3, **filter_kwargs):
    mat = rotation_matrix(angle)
    return apply_affine_transformation(x, mat, a=a, amax=a * 2,
                                       **filter_kwargs)


def apply_fractional_pseudo_rotation(x, angle, a=3, **filter_kwargs):
    """R*_alpha: bandlimit as if rotated, without rotating
    (equivariance.py:181-190)."""
    mat = rotation_matrix(-angle)
    f = construct_affine_bandlimit_filter(mat, a=a, amax=a * 2, up=1,
                                          **filter_kwargs)
    y = filter2d(x, f)
    m = torch.zeros_like(y)
    c = f.shape[0] // 2
    m[:, :, c:-c, c:-c] = 1.0
    return y, m


def compute_equivariance_metrics(G3, params, *, num_samples=64,
                                 batch_size=8, translate_max=0.125,
                                 rotate_max=1.0, eqt_int=True,
                                 eqt_frac=False, eqr=True, seed=0,
                                 samples=None, generator=None):
    """EQ harness (equivariance.py:194-266) for the SG3 generator
    (``nn/synthesis3.py``).

    Returns a dict with the requested PSNRs (dB). Accumulation is the
    reference's float64 (sum sq err, mask sum) pairs; transforms enter
    through the generator's input-layer transform matrix. The
    translations and angles come from ``np.random.RandomState(seed)`` (as
    in ``tgi``), z from ``generator`` (a CPU torch.Generator seeded by
    ``seed`` when absent).

    ``samples``: optional list of per-batch dicts overriding the draws —
    keys ``z`` [B, z_dim], ``t_int`` (tx, ty; already snapped to the
    pixel grid), ``t_frac`` (tx, ty), ``angle`` (rad) — so that two
    implementations can be fed identical draws.
    """
    assert eqt_int or eqt_frac or eqr
    rng = np.random.RandomState(seed)
    generator = generator or torch.Generator().manual_seed(seed)
    res = G3.cfg.img_resolution
    device = params["mapping"]["w_avg"].device

    def with_transform(m):
        inp = dict(params["synthesis"]["input"],
                   transform=torch.as_tensor(np.asarray(m, np.float32),
                                             device=device))
        return {**params, "synthesis": {**params["synthesis"],
                                        "input": inp}}

    def total(v):
        return v.double().sum().item()

    sums = None
    n_batches = (len(samples) if samples is not None
                 else max(num_samples // batch_size, 1))
    with torch.no_grad():
        for i in range(n_batches):
            given = samples[i] if samples is not None else {}
            z = (torch.as_tensor(np.asarray(given["z"], np.float32))
                 if "z" in given else
                 torch.randn((batch_size, G3.cfg.z_dim),
                             generator=generator)).to(device)
            orig = G3(with_transform(np.eye(3)), z, None)
            s = []

            if eqt_int:
                if "t_int" in given:
                    t = np.asarray(given["t_int"], np.float64)
                else:
                    t = (rng.rand(2) * 2 - 1) * translate_max
                    t = np.round(t * res) / res
                m = np.eye(3)
                m[:2, 2] = -t
                img = G3(with_transform(m), z, None)
                ref, mask = apply_integer_translation(orig, t[0], t[1])
                s += [total((ref - img) ** 2 * mask), total(mask)]

            if eqt_frac:
                if "t_frac" in given:
                    t = np.asarray(given["t_frac"], np.float64)
                else:
                    t = (rng.rand(2) * 2 - 1) * translate_max
                m = np.eye(3)
                m[:2, 2] = -t
                img = G3(with_transform(m), z, None)
                ref, mask = apply_fractional_translation(orig, t[0], t[1])
                s += [total((ref - img) ** 2 * mask), total(mask)]

            if eqr:
                angle = (given["angle"] if "angle" in given else
                         (rng.rand() * 2 - 1) * (rotate_max * np.pi))
                img = G3(with_transform(rotation_matrix(-angle)), z, None)
                ref, ref_mask = apply_fractional_rotation(orig, angle)
                pseudo, pseudo_mask = apply_fractional_pseudo_rotation(
                    img, angle)
                mask = ref_mask * pseudo_mask
                s += [total((ref - pseudo) ** 2 * mask), total(mask)]

            s = np.asarray(s, np.float64)
            sums = s if sums is None else sums + s

    mses = sums[0::2] / sums[1::2]
    psnrs = 20 * math.log10(2) - 10 * np.log10(mses)
    names = [n for n, on in (("eqt_int", eqt_int), ("eqt_frac", eqt_frac),
                             ("eqr", eqr)) if on]
    return {n: float(p) for n, p in zip(names, psnrs)}
