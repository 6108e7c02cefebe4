"""ADA augmentation pipeline (twin of ``tgi/train/augment.py``).

Behavioral parity target: training/augment.py:124-441 (AugmentPipe).
Every tier of ``tgi``'s pipe, in plain PyTorch:

* pixel blits (xflip, 90-degree rotations, whole-pixel integer
  translation) and general geometry (iso/aniso scale, pre+post rotation
  with the P(pre OR post)=p split, fractional translation), composed
  into one per-sample inverse 3x3 pixel-space homography and executed
  through the reference's wavelet pipeline: reflect-pad, sym6 2x
  upsample, one bilinear warp on the doubled grid (the port's plain
  ``grid_sample_2d``), sym6 downsample with flip_filter;
* color tier as a 4x4 homogeneous matrix (brightness, contrast,
  Householder luma flip, hue rotation, saturation);
* image-space filtering: per-sample amplification of 4 sym2 wavelet
  frequency bands, power-normalized, as a separable per-sample
  depthwise FIR;
* corruptions: additive RGB noise and cutout.

Draws come from a draw source (``tgi_torch.utils.draws``) split as
``tgi`` splits its key, so a test can feed ``tgi``'s own draws.
``debug_percentile`` replaces every random value with the reference's
deterministic percentile formulas. As in ``tgi``, the geometric pad is
the reference's clamp (``width - 1``) unless ``AugmentConfig.pad_max``
caps it.

Everything here stays differentiable twice (R1 differentiates D's
logits with respect to the augmented real image, then to D's weights).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tgi_torch.ops.filters import setup_filter
from tgi_torch.ops.grid_sample import grid_sample_2d
from tgi_torch.ops.upfirdn2d import downsample2d, upsample2d

# Orthogonal wavelet taps (training/augment.py:28-45).
WAVELETS = {
    "haar": [0.7071067811865476, 0.7071067811865476],
    "sym2": [-0.12940952255092145, 0.22414386804185735, 0.836516303737469,
             0.48296291314469025],
    "sym6": [0.015404109327027373, 0.0034907120842174702,
             -0.11799011114819057, -0.048311742585633, 0.4910559419267466,
             0.787641141030194, 0.3379294217276218, -0.07263752278646252,
             -0.021060292512300564, 0.04472490177066578,
             0.0017677118642428036, -0.007800708325034148],
}

# Geometric lowpass (augment.py:174) — separable, DC-normalized.
_HZ_GEOM = setup_filter(WAVELETS["sym6"])
_HZ_PAD = _HZ_GEOM.shape[0] // 4


def _make_fbank():
    """4-band sym2 filter bank for imgfilter (augment.py:176-186)."""
    import scipy.signal
    Hz_lo = np.asarray(WAVELETS["sym2"])
    Hz_hi = Hz_lo * ((-1) ** np.arange(Hz_lo.size))
    Hz_lo2 = np.convolve(Hz_lo, Hz_lo[::-1]) / 2
    Hz_hi2 = np.convolve(Hz_hi, Hz_hi[::-1]) / 2
    Hz_fbank = np.eye(4, 1)
    for i in range(1, Hz_fbank.shape[0]):
        Hz_fbank = np.dstack([Hz_fbank, np.zeros_like(Hz_fbank)]
                             ).reshape(Hz_fbank.shape[0], -1)[:, :-1]
        Hz_fbank = scipy.signal.convolve(Hz_fbank, [Hz_lo2])
        lo = (Hz_fbank.shape[1] - Hz_hi2.size) // 2
        Hz_fbank[i, lo:lo + Hz_hi2.size] += Hz_hi2
    return Hz_fbank.astype(np.float32)


@dataclass(frozen=True)
class AugmentConfig:
    """Probability multipliers + parameters (augment.py:126-172).

    Defaults enable the blit+geom+color tiers (the EG3D 'ada' spec);
    imgfilter/noise/cutout default off as upstream.
    """
    xflip: float = 1.0
    rotate90: float = 1.0
    xint: float = 1.0
    xint_max: float = 0.125
    scale: float = 1.0
    rotate: float = 1.0
    aniso: float = 1.0
    xfrac: float = 1.0
    scale_std: float = 0.2
    rotate_max: float = 1.0
    aniso_std: float = 0.2
    xfrac_std: float = 0.125
    brightness: float = 1.0
    contrast: float = 1.0
    lumaflip: float = 1.0
    hue: float = 1.0
    saturation: float = 1.0
    brightness_std: float = 0.2
    contrast_std: float = 0.5
    hue_max: float = 1.0
    saturation_std: float = 1.0
    imgfilter: float = 0.0
    imgfilter_bands: tuple = (1.0, 1.0, 1.0, 1.0)
    imgfilter_std: float = 1.0
    noise: float = 0.0
    cutout: float = 0.0
    noise_std: float = 0.1
    cutout_size: float = 0.5
    pad_max: int | None = None   # static cap on the geometric pad margin


# -- batched 3x3 / 4x4 matrix helpers (pixel coordinates) ------------------


def _eye(n, d, device):
    return torch.eye(d, dtype=torch.float32, device=device).repeat(n, 1, 1)


def _set(m, entries):
    """``m`` with ``entries`` {(i, j): [n] tensor} written in (the
    ``.at[:, i, j].set`` of ``tgi``)."""
    for (i, j), v in entries.items():
        m[:, i, j] = v
    return m


def _translate2d(tx, ty):
    return _set(_eye(tx.shape[0], 3, tx.device), {(0, 2): tx, (1, 2): ty})


def _scale2d(sx, sy):
    return _set(_eye(sx.shape[0], 3, sx.device), {(0, 0): sx, (1, 1): sy})


def _rotate2d(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    return _set(_eye(theta.shape[0], 3, theta.device),
                {(0, 0): c, (0, 1): -s, (1, 0): s, (1, 1): c})


def _translate3d(b):
    return _set(_eye(b.shape[0], 4, b.device),
                {(0, 3): b, (1, 3): b, (2, 3): b})


def _scale3d(c):
    return _set(_eye(c.shape[0], 4, c.device),
                {(0, 0): c, (1, 1): c, (2, 2): c})


def _rotate3d_about(axis, theta):
    """Rodrigues rotation about ``axis`` (a [3] tensor) embedded in 4x4."""
    x, y, z = axis.tolist()
    K = torch.tensor([[0, -z, y], [z, 0, -x], [-y, x, 0]],
                     dtype=torch.float32, device=theta.device)
    c = torch.cos(theta)[:, None, None]
    s = torch.sin(theta)[:, None, None]
    R3 = (torch.eye(3, device=theta.device)[None] * c + s * K[None]
          + (1 - c) * torch.outer(axis, axis)[None])
    m = _eye(theta.shape[0], 4, theta.device)
    m[:, :3, :3] = R3
    return m


# -- parameter selection ---------------------------------------------------


def _gate(draws, prob, value, default, shape):
    """value where uniform < prob else default (reference torch.where
    pattern)."""
    u = draws.uniform(shape)
    return torch.where(u < prob, value, default)


def _erfinv_q(q, n, device):
    q = torch.full((n,), q, dtype=torch.float32, device=device)
    return torch.erfinv(torch.clamp(2.0 * q - 1.0, -1 + 1e-7, 1 - 1e-7))


def _geom_inv(draws, n, p, cfg: AugmentConfig, W, H, q=None, device="cpu"):
    """Per-sample inverse pixel-space homography G_inv (augment.py:
    197-264). ``q``: debug percentile (None = random)."""
    ks = draws.split(16)
    G_inv = _eye(n, 3, device)

    def full(v):
        return torch.full((n,), float(v), dtype=torch.float32, device=device)

    if cfg.xflip > 0:
        i = torch.floor(ks[0].uniform((n,)) * 2)
        i = _gate(ks[1], cfg.xflip * p, i, torch.zeros_like(i), (n,))
        if q is not None:
            i = full(np.floor(q * 2))
        G_inv = G_inv @ _scale2d(1 / (1 - 2 * i), full(1.0))

    if cfg.rotate90 > 0:
        i = torch.floor(ks[2].uniform((n,)) * 4)
        i = _gate(ks[3], cfg.rotate90 * p, i, torch.zeros_like(i), (n,))
        if q is not None:
            i = full(np.floor(q * 4))
        G_inv = G_inv @ _rotate2d(math.pi / 2 * i)

    if cfg.xint > 0:
        t = (ks[4].uniform((n, 2)) * 2 - 1) * cfg.xint_max
        t = _gate(ks[5], cfg.xint * p, t, torch.zeros_like(t), (n, 1))
        if q is not None:
            t = torch.full((n, 2), (q * 2 - 1) * cfg.xint_max,
                           dtype=torch.float32, device=device)
        G_inv = G_inv @ _translate2d(-torch.round(t[:, 0] * W),
                                     -torch.round(t[:, 1] * H))

    if cfg.scale > 0:
        s = torch.exp2(ks[6].normal((n,)) * cfg.scale_std)
        s = _gate(ks[7], cfg.scale * p, s, torch.ones_like(s), (n,))
        if q is not None:
            s = torch.exp2(_erfinv_q(q, n, device) * cfg.scale_std)
        G_inv = G_inv @ _scale2d(1 / s, 1 / s)

    p_rot = 1 - math.sqrt(min(max(1 - cfg.rotate * p, 0), 1))
    if cfg.rotate > 0:
        theta = (ks[8].uniform((n,)) * 2 - 1) * math.pi * cfg.rotate_max
        theta = _gate(ks[9], p_rot, theta, torch.zeros_like(theta), (n,))
        if q is not None:
            theta = full((q * 2 - 1) * math.pi * cfg.rotate_max)
        G_inv = G_inv @ _rotate2d(theta)

    if cfg.aniso > 0:
        s = torch.exp2(ks[10].normal((n,)) * cfg.aniso_std)
        s = _gate(ks[11], cfg.aniso * p, s, torch.ones_like(s), (n,))
        if q is not None:
            s = torch.exp2(_erfinv_q(q, n, device) * cfg.aniso_std)
        G_inv = G_inv @ _scale2d(1 / s, s)

    if cfg.rotate > 0:   # post-rotation
        theta = (ks[12].uniform((n,)) * 2 - 1) * math.pi * cfg.rotate_max
        theta = _gate(ks[13], p_rot, theta, torch.zeros_like(theta), (n,))
        if q is not None:
            theta = torch.zeros_like(theta)            # augment.py:260
        G_inv = G_inv @ _rotate2d(theta)

    if cfg.xfrac > 0:
        t = ks[14].normal((n, 2)) * cfg.xfrac_std
        t = _gate(ks[15], cfg.xfrac * p, t, torch.zeros_like(t), (n, 1))
        if q is not None:
            t = (torch.ones((n, 2), device=device)
                 * _erfinv_q(q, n, device)[:, None] * cfg.xfrac_std)
        G_inv = G_inv @ _translate2d(-t[:, 0] * W, -t[:, 1] * H)
    return G_inv


def _execute_geom(images, G_inv, pad_max=None):
    """Wavelet-filtered warp (augment.py:266-307): reflect-pad, sym6 2x
    upsample, one bilinear sample on the doubled grid, sym6 downsample
    (flip_filter) with crop, at the reference's clamped pad."""
    N, C, H, W = images.shape
    dev = images.device
    mx = W - 1 if pad_max is None else min(pad_max, W - 1)
    my = H - 1 if pad_max is None else min(pad_max, H - 1)
    images = F.pad(images, [mx, mx, my, my], mode="reflect")
    images = upsample2d(images, _HZ_GEOM, up=2)

    def full(v):
        return torch.full((N,), v, dtype=torch.float32, device=dev)

    two, half = full(2.0), full(-0.5)
    G_inv = _scale2d(two, two) @ G_inv @ _scale2d(two / 4, two / 4)
    G_inv = _translate2d(half, half) @ G_inv @ _translate2d(-half, -half)

    out_h = (H + _HZ_PAD * 2) * 2
    out_w = (W + _HZ_PAD * 2) * 2
    in_h, in_w = images.shape[2:]
    G_inv = (_scale2d(full(2.0 / in_w), full(2.0 / in_h)) @ G_inv
             @ _scale2d(1 / full(2.0 / out_w), 1 / full(2.0 / out_h)))

    # affine_grid(align_corners=False) base grid: pixel centers.
    ys = (2 * torch.arange(out_h, dtype=torch.float32, device=dev) + 1) \
        / out_h - 1
    xs = (2 * torch.arange(out_w, dtype=torch.float32, device=dev) + 1) \
        / out_w - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)   # [h, w, 3]
    coords = torch.einsum("nij,hwj->nhwi", G_inv[:, :2], grid)  # [n,h,w,2]
    images = grid_sample_2d(images, coords)
    return downsample2d(images, _HZ_GEOM, down=2, padding=-_HZ_PAD * 2,
                        flip_filter=True)


def _color_mat(draws, n, p, cfg: AugmentConfig, num_channels, q=None,
               device="cpu"):
    """Homogeneous 4x4 color transform C (augment.py:313-375)."""
    ks = draws.split(10)
    C = _eye(n, 4, device)
    v = torch.tensor([1, 1, 1, 0], dtype=torch.float32,
                     device=device) / math.sqrt(3)

    def full(val):
        return torch.full((n,), float(val), dtype=torch.float32,
                          device=device)

    if cfg.brightness > 0:
        b = ks[0].normal((n,)) * cfg.brightness_std
        b = _gate(ks[1], cfg.brightness * p, b, torch.zeros_like(b), (n,))
        if q is not None:
            b = _erfinv_q(q, n, device) * cfg.brightness_std
        C = _translate3d(b) @ C

    if cfg.contrast > 0:
        c = torch.exp2(ks[2].normal((n,)) * cfg.contrast_std)
        c = _gate(ks[3], cfg.contrast * p, c, torch.ones_like(c), (n,))
        if q is not None:
            c = torch.exp2(_erfinv_q(q, n, device) * cfg.contrast_std)
        C = _scale3d(c) @ C

    if cfg.lumaflip > 0:
        i = torch.floor(ks[4].uniform((n,)) * 2)
        i = _gate(ks[5], cfg.lumaflip * p, i, torch.zeros_like(i), (n,))
        if q is not None:
            i = full(np.floor(q * 2))
        Hm = _eye(n, 4, device) - 2 * torch.outer(v, v)[None] \
            * i[:, None, None]
        C = Hm @ C

    if cfg.hue > 0 and num_channels > 1:
        theta = (ks[6].uniform((n,)) * 2 - 1) * math.pi * cfg.hue_max
        theta = _gate(ks[7], cfg.hue * p, theta, torch.zeros_like(theta),
                      (n,))
        if q is not None:
            theta = full((q * 2 - 1) * math.pi * cfg.hue_max)
        C = _rotate3d_about(v[:3], theta) @ C

    if cfg.saturation > 0 and num_channels > 1:
        s = torch.exp2(ks[8].normal((n,)) * cfg.saturation_std)
        s = _gate(ks[9], cfg.saturation * p, s, torch.ones_like(s), (n,))
        if q is not None:
            s = torch.exp2(_erfinv_q(q, n, device) * cfg.saturation_std)
        vv = torch.outer(v, v)[None]
        C = (vv + (_eye(n, 4, device) - vv) * s[:, None, None]) @ C
    return C


def _apply_color(images, C):
    """Execute the color matrix per the channel count (augment.py:
    364-375): 3ch direct, 1ch averaged rows, 6ch both halves."""
    n, ch, h, w = images.shape
    flat = images.reshape(n, ch, h * w)
    if ch == 3:
        out = C[:, :3, :3] @ flat + C[:, :3, 3:]
    elif ch == 1:
        Cm = C[:, :3, :].mean(dim=1, keepdim=True)
        out = flat * Cm[:, :, :3].sum(dim=2, keepdim=True) + Cm[:, :, 3:]
    elif ch == 6:
        a = C[:, :3, :3] @ flat[:, :3] + C[:, :3, 3:]
        b = C[:, :3, :3] @ flat[:, 3:] + C[:, :3, 3:]
        out = torch.cat([a, b], dim=1)
    else:
        raise ValueError("images must have 1, 3 or 6 channels")
    return out.reshape(n, ch, h, w)


def _imgfilter(images, draws, p, cfg: AugmentConfig, q=None):
    """Per-sample frequency-band amplification (augment.py:379-411)."""
    n, ch, h, w = images.shape
    dev = images.device
    fbank = torch.from_numpy(_make_fbank()).to(dev)
    num_bands = fbank.shape[0]
    if len(cfg.imgfilter_bands) != num_bands:
        raise ValueError(f"imgfilter_bands needs {num_bands} entries")
    expected_power = torch.tensor(np.array([10, 1, 1, 1]) / 13,
                                  dtype=torch.float32, device=dev)

    g = torch.ones((n, num_bands), dtype=torch.float32, device=dev)
    ks = draws.split(2 * num_bands)
    for i, band_strength in enumerate(cfg.imgfilter_bands):
        t_i = torch.exp2(ks[2 * i].normal((n,)) * cfg.imgfilter_std)
        t_i = _gate(ks[2 * i + 1], cfg.imgfilter * p * band_strength,
                    t_i, torch.ones_like(t_i), (n,))
        if q is not None:
            t_i = (torch.exp2(_erfinv_q(q, n, dev) * cfg.imgfilter_std)
                   if band_strength > 0
                   else torch.ones((n,), dtype=torch.float32, device=dev))
        t = torch.ones((n, num_bands), dtype=torch.float32, device=dev)
        t = torch.cat([t[:, :i], t_i[:, None], t[:, i + 1:]], dim=1)
        t = t / torch.sqrt((expected_power * t ** 2).sum(dim=-1,
                                                         keepdim=True))
        g = g * t

    Hz_prime = g @ fbank                              # [n, taps]
    taps = fbank.shape[1]
    pad = taps // 2
    wmat = Hz_prime[:, None, :].expand(n, ch, taps).reshape(n * ch, 1, taps)
    x = images.reshape(1, n * ch, h, w)
    x = F.pad(x, [pad, pad, pad, pad], mode="reflect")
    # lax.conv_general_dilated correlates, as F.conv2d does.
    x = F.conv2d(x, wmat[:, :, None, :], groups=n * ch)
    x = F.conv2d(x, wmat[:, :, :, None], groups=n * ch)
    return x.reshape(n, ch, h, w)


def augment_images(images, draws, p, cfg: AugmentConfig = AugmentConfig(),
                   debug_percentile=None):
    """Run the full pipe on ``[N, C, H, W]`` images (C in {1, 3, 6}).

    ``draws``: a draw source (``tgi_torch.utils.draws``), split as ``tgi``
    splits its key. ``p``: overall probability (a float).
    ``debug_percentile``: a float in [0, 1) that replaces every random
    draw with the reference's deterministic percentile formulas.
    """
    n, ch, h, w = images.shape
    dev = images.device
    q = debug_percentile
    p = float(p)
    k_geom, k_color, k_filt, k_noise, k_cut = draws.split(5)

    G_inv = _geom_inv(k_geom, n, p, cfg, w, h, q, dev)
    images = _execute_geom(images, G_inv, cfg.pad_max)

    C = _color_mat(k_color, n, p, cfg, ch, q, dev)
    images = _apply_color(images, C)

    if cfg.imgfilter > 0:
        images = _imgfilter(images, k_filt, p, cfg, q)

    # additive RGB noise (augment.py:418-423)
    if cfg.noise > 0:
        k_sig, k_gate, k_field = k_noise.split(3)
        sigma = k_sig.normal((n, 1, 1, 1)).abs() * cfg.noise_std
        sigma = _gate(k_gate, cfg.noise * p, sigma, torch.zeros_like(sigma),
                      (n, 1, 1, 1))
        if q is not None:
            import scipy.special
            sigma = torch.full((n, 1, 1, 1),
                               float(scipy.special.erfinv(q)) * cfg.noise_std,
                               dtype=torch.float32, device=dev)
        images = images + k_field.normal(images.shape) * sigma

    # cutout (augment.py:426-437): gated size (0 disables), center at
    # pixel-center coords (coord + 0.5) / size.
    if cfg.cutout > 0:
        k_gate, k_center = k_cut.split(2)
        size = torch.full((n, 2, 1, 1), cfg.cutout_size, dtype=torch.float32,
                          device=dev)
        size = _gate(k_gate, cfg.cutout * p, size, torch.zeros_like(size),
                     (n, 1, 1, 1))
        center = k_center.uniform((n, 2, 1, 1))
        if q is not None:
            size = torch.full((n, 2, 1, 1), cfg.cutout_size,
                              dtype=torch.float32, device=dev)
            center = torch.full((n, 2, 1, 1), q, dtype=torch.float32,
                                device=dev)
        cx = torch.arange(w, dtype=torch.float32, device=dev).reshape(1, 1, w)
        cy = torch.arange(h, dtype=torch.float32, device=dev).reshape(1, h, 1)
        mask_x = ((cx + 0.5) / w - center[:, 0]).abs() >= size[:, 0] / 2
        mask_y = ((cy + 0.5) / h - center[:, 1]).abs() >= size[:, 1] / 2
        mask = (mask_x | mask_y).to(images.dtype)
        images = images * mask[:, None]
    return images


class AugmentPipe:
    """Callable (img, img_raw, draws, p) -> (img, img_raw).

    Mirrors the reference's dual-D augmentation (loss.py:80-86): the raw
    render is antialias-upsampled to the image resolution, the 6-channel
    concat goes through ONE pipe invocation (identical per-sample
    transforms for both halves), then the raw half is antialias-resized
    back down.
    """

    def __init__(self, cfg: AugmentConfig = AugmentConfig()):
        self.cfg = cfg

    def __call__(self, img, img_raw, draws, p, debug_percentile=None):
        from tgi_torch.nn.discriminator import filtered_resizing
        raw_res = img_raw.shape[-1]
        raw_up = filtered_resizing(img_raw, img.shape[-1], "antialiased")
        pair = torch.cat([img, raw_up], dim=1)
        pair = augment_images(pair, draws, p, self.cfg, debug_percentile)
        img = pair[:, :img.shape[1]]
        img_raw = filtered_resizing(pair[:, img.shape[1]:], raw_res,
                                    "antialiased")
        return img, img_raw


class AdaptiveAugment:
    """ADA p-controller (training_loop.py:325-328): drive
    E[sign(D_real)] toward ``target`` by nudging p."""

    def __init__(self, target=0.6, interval=4, kimg=500, batch_size=4,
                 p=0.0):
        self.target = target
        self.interval = interval
        self.adjust = batch_size * interval / (kimg * 1000)
        self.p = p

    def update(self, real_logits_sign_mean: float):
        # training_loop.py:325-328: p += sign(E[sign(D_real)] - target)
        # * batch*interval/(kimg*1000), floored at 0 (no upper clamp).
        direction = float(np.sign(real_logits_sign_mean - self.target))
        self.p = max(self.p + direction * self.adjust, 0.0)
        return self.p
