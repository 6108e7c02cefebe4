"""StyleGAN3 alias-free generator (twin of ``tgi/nn/synthesis3.py``).

Behavioral parity target: training/networks_stylegan3.py — SynthesisInput
(Fourier features under a learned similarity transform), SynthesisLayer
(magnitude-EMA-normalized modulated conv + filtered leaky ReLU with Kaiser
lowpass up/down filters), SynthesisNetwork (geometric cutoff progression),
Generator. EG3D's pickles use the SG2 path; SG3 runs the equivariance
metrics (``metrics/equivariance.py``).

The layer specs and their filters are host numpy, designed once per
config (``scipy`` is imported inside :func:`design_lowpass_filter`); the
params tree's keys are ``tgi``'s, so weights cross with
``io.from_jax.params_from_numpy``. Plain PyTorch throughout: ``tgi`` has
no Pallas kernel on this path.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tgi_torch.nn.layers import fully_connected_apply, fully_connected_init
from tgi_torch.ops.filtered_lrelu import filtered_lrelu


def design_lowpass_filter(numtaps, cutoff, width, fs, radial=False):
    """Kaiser/jinc lowpass design (networks_stylegan3.py:377-398)."""
    import scipy.signal
    import scipy.special
    if numtaps == 1:
        return None
    if not radial:
        f = scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width,
                                fs=fs)
        return np.asarray(f, np.float32)
    x = (np.arange(numtaps) - (numtaps - 1) / 2) / fs
    r = np.hypot(*np.meshgrid(x, x))
    with np.errstate(divide="ignore", invalid="ignore"):
        f = scipy.special.j1(2 * cutoff * (np.pi * r)) / (np.pi * r)
    f[r == 0] = cutoff  # the limit at r = 0; the sum is normalized below
    beta = scipy.signal.kaiser_beta(
        scipy.signal.kaiser_atten(numtaps, width / (fs / 2)))
    w = np.kaiser(numtaps, beta)
    f *= np.outer(w, w)
    f /= np.sum(f)
    return np.asarray(f, np.float32)


@dataclass(frozen=True)
class SG3LayerSpec:
    is_torgb: bool
    is_critically_sampled: bool
    use_fp16: bool
    in_channels: int
    out_channels: int
    in_size: int
    out_size: int
    in_sampling_rate: int
    out_sampling_rate: int
    in_cutoff: float
    out_cutoff: float
    in_half_width: float
    out_half_width: float
    conv_kernel: int
    up_factor: int
    down_factor: int
    padding: tuple
    up_filter: tuple | None
    down_filter: tuple | None
    conv_clamp: float = 256.0

    @staticmethod
    def build(is_torgb, is_critically_sampled, use_fp16, in_channels,
              out_channels, in_size, out_size, in_sampling_rate,
              out_sampling_rate, in_cutoff, out_cutoff, in_half_width,
              out_half_width, conv_kernel=3, filter_size=6,
              lrelu_upsampling=2, use_radial_filters=False):
        tmp = max(in_sampling_rate, out_sampling_rate) * \
            (1 if is_torgb else lrelu_upsampling)
        k = 1 if is_torgb else conv_kernel
        up_factor = int(np.rint(tmp / in_sampling_rate))
        up_taps = filter_size * up_factor if up_factor > 1 and not is_torgb \
            else 1
        up_filter = design_lowpass_filter(up_taps, in_cutoff,
                                          in_half_width * 2, tmp)
        down_factor = int(np.rint(tmp / out_sampling_rate))
        down_taps = filter_size * down_factor \
            if down_factor > 1 and not is_torgb else 1
        down_radial = use_radial_filters and not is_critically_sampled
        down_filter = design_lowpass_filter(down_taps, out_cutoff,
                                            out_half_width * 2, tmp,
                                            radial=down_radial)
        pad_total = (out_size - 1) * down_factor + 1
        pad_total -= (in_size + k - 1) * up_factor
        pad_total += up_taps + down_taps - 2
        pad_lo = (pad_total + up_factor) // 2
        pad_hi = pad_total - pad_lo
        return SG3LayerSpec(
            is_torgb, is_critically_sampled, use_fp16, in_channels,
            out_channels, in_size, out_size, in_sampling_rate,
            out_sampling_rate, in_cutoff, out_cutoff, in_half_width,
            out_half_width, k, up_factor, down_factor,
            (int(pad_lo), int(pad_hi), int(pad_lo), int(pad_hi)),
            tuple(up_filter.tolist()) if up_filter is not None else None,
            tuple(down_filter.tolist()) if down_filter is not None else None)


@dataclass(frozen=True)
class SG3Config:
    z_dim: int = 512
    c_dim: int = 0
    w_dim: int = 512
    img_resolution: int = 256
    img_channels: int = 3
    channel_base: int = 32768
    channel_max: int = 512
    num_layers: int = 14
    num_critical: int = 2
    first_cutoff: float = 2.0
    first_stopband: float = 2 ** 2.1
    last_stopband_rel: float = 2 ** 0.3
    margin_size: int = 10
    output_scale: float = 0.25
    num_fp16_res: int = 4
    mapping_layers: int = 2

    @property
    def num_ws(self):
        return self.num_layers + 2

    def layer_specs(self):
        """Geometric cutoff progression (networks_stylegan3.py:430-443):
        (the input layer's kwargs, one spec per layer)."""
        last_cutoff = self.img_resolution / 2
        last_stopband = last_cutoff * self.last_stopband_rel
        exps = np.minimum(np.arange(self.num_layers + 1)
                          / (self.num_layers - self.num_critical), 1)
        cutoffs = self.first_cutoff * \
            (last_cutoff / self.first_cutoff) ** exps
        stopbands = self.first_stopband * \
            (last_stopband / self.first_stopband) ** exps
        srates = np.exp2(np.ceil(np.log2(np.minimum(
            stopbands * 2, self.img_resolution))))
        half_widths = np.maximum(stopbands, srates / 2) - cutoffs
        sizes = srates + self.margin_size * 2
        sizes[-2:] = self.img_resolution
        channels = np.rint(np.minimum((self.channel_base / 2) / cutoffs,
                                      self.channel_max))
        channels[-1] = self.img_channels
        specs = []
        for idx in range(self.num_layers + 1):
            prev = max(idx - 1, 0)
            specs.append(SG3LayerSpec.build(
                is_torgb=(idx == self.num_layers),
                is_critically_sampled=(idx >= self.num_layers
                                       - self.num_critical),
                use_fp16=(srates[idx] * (2 ** self.num_fp16_res)
                          > self.img_resolution),
                in_channels=int(channels[prev]),
                out_channels=int(channels[idx]),
                in_size=int(sizes[prev]), out_size=int(sizes[idx]),
                in_sampling_rate=int(srates[prev]),
                out_sampling_rate=int(srates[idx]),
                in_cutoff=cutoffs[prev], out_cutoff=cutoffs[idx],
                in_half_width=half_widths[prev],
                out_half_width=half_widths[idx]))
        self_input = dict(channels=int(channels[0]), size=int(sizes[0]),
                          sampling_rate=float(srates[0]),
                          bandwidth=float(cutoffs[0]))
        return self_input, specs


@functools.lru_cache(maxsize=8)
def _layer_specs(cfg: SG3Config):
    """``cfg.layer_specs()``, designed once per config."""
    return cfg.layer_specs()


# ---------------------------------------------------------------------------
# SynthesisInput


def synthesis_input_init(generator, w_dim, channels, bandwidth,
                         device="cuda"):
    freqs = torch.randn((channels, 2), generator=generator)
    radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
    freqs = freqs / (radii * radii.square().exp() ** 0.25) * bandwidth
    phases = torch.rand((channels,), generator=generator) - 0.5
    affine = fully_connected_init(generator, w_dim, 4, device=device)
    affine["weight"] = torch.zeros_like(affine["weight"])
    affine["bias"] = torch.tensor([1., 0., 0., 0.], device=device)
    return {
        "weight": torch.randn((channels, channels),
                              generator=generator).to(device),
        "affine": affine,
        "freqs": freqs.to(device),
        "phases": phases.to(device),
        "transform": torch.eye(3, device=device),
    }


def synthesis_input_apply(params, w, *, channels, size, sampling_rate,
                          bandwidth):
    """Fourier-feature input grid (networks_stylegan3.py:201-246)."""
    N = w.shape[0]
    dev = w.device
    transforms = params["transform"][None]
    freqs = params["freqs"][None]
    phases = params["phases"][None]

    t = fully_connected_apply(params["affine"], w)
    t = t / torch.linalg.norm(t[:, :2], dim=1, keepdim=True)
    one = torch.ones((N,), device=dev)
    zero = torch.zeros((N,), device=dev)
    m_r = torch.stack([torch.stack([t[:, 0], -t[:, 1], zero], -1),
                       torch.stack([t[:, 1], t[:, 0], zero], -1),
                       torch.stack([zero, zero, one], -1)], 1)
    m_t = torch.stack([torch.stack([one, zero, -t[:, 2]], -1),
                       torch.stack([zero, one, -t[:, 3]], -1),
                       torch.stack([zero, zero, one], -1)], 1)
    transforms = m_r @ m_t @ transforms

    phases = phases + torch.einsum("ncx,nxo->nco", freqs,
                                   transforms[:, :2, 2:])[..., 0]
    freqs = torch.einsum("ncx,nxy->ncy", freqs, transforms[:, :2, :2])
    amplitudes = torch.clamp(
        1 - (torch.linalg.norm(freqs, dim=2) - bandwidth)
        / (sampling_rate / 2 - bandwidth), 0, 1)

    # align_corners=False affine grid over [size, size].
    half = 0.5 * size / sampling_rate
    lin = ((torch.arange(size, dtype=torch.float32, device=dev) + 0.5)
           / size * 2 - 1)
    gy, gx = torch.meshgrid(lin * half, lin * half, indexing="ij")
    grid = torch.stack([gx, gy], dim=-1)                     # [S, S, 2]

    x = torch.einsum("hwx,ncx->nhwc", grid, freqs)
    x = x + phases[:, None, None, :]
    x = torch.sin(x * (2 * math.pi)) * amplitudes[:, None, None, :]
    weight = params["weight"] / math.sqrt(channels)
    x = x @ weight.T
    return x.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# SynthesisLayer


def sg3_layer_init(generator, spec: SG3LayerSpec, w_dim, device="cuda"):
    return {
        "affine": fully_connected_init(generator, w_dim, spec.in_channels,
                                       bias_init=1.0, device=device),
        "weight": torch.randn(
            (spec.out_channels, spec.in_channels, spec.conv_kernel,
             spec.conv_kernel), generator=generator).to(device),
        "bias": torch.zeros((spec.out_channels,), device=device),
        "magnitude_ema": torch.ones((), device=device),
    }


def sg3_layer_apply(params, x, w, spec: SG3LayerSpec):
    """One layer, in float32 (``tgi``'s ``force_fp32=True``)."""
    styles = fully_connected_apply(params["affine"], w)
    if spec.is_torgb:
        styles = styles / math.sqrt(spec.in_channels
                                    * spec.conv_kernel ** 2)
    input_gain = torch.rsqrt(params["magnitude_ema"])

    weight = params["weight"]
    demodulate = not spec.is_torgb
    if demodulate:
        weight = weight * torch.rsqrt(
            weight.square().mean(dim=(1, 2, 3), keepdim=True))
        styles = styles * torch.rsqrt(styles.square().mean())

    dcoefs = None
    if demodulate:
        w2 = weight.square().reshape(weight.shape[0], weight.shape[1],
                                     -1).sum(-1)
        dcoefs = torch.rsqrt(styles.square() @ w2.T + 1e-8)

    x = x * (styles * input_gain)[:, :, None, None]
    x = F.conv2d(x, weight, padding=spec.conv_kernel - 1)
    if demodulate:
        x = x * dcoefs[:, :, None, None]

    gain = 1.0 if spec.is_torgb else math.sqrt(2)
    slope = 1.0 if spec.is_torgb else 0.2
    fu, fd = (None if f is None else np.asarray(f, np.float32)
              for f in (spec.up_filter, spec.down_filter))
    return filtered_lrelu(x, fu=fu, fd=fd, b=params["bias"],
                          up=spec.up_factor, down=spec.down_factor,
                          padding=list(spec.padding), gain=gain, slope=slope,
                          clamp=spec.conv_clamp)


# ---------------------------------------------------------------------------
# Network / Generator


def sg3_synthesis_init(generator, cfg: SG3Config, device="cuda"):
    input_kw, specs = _layer_specs(cfg)
    params = {"input": synthesis_input_init(
        generator, cfg.w_dim, input_kw["channels"], input_kw["bandwidth"],
        device)}
    for i, spec in enumerate(specs):
        params[f"L{i}"] = sg3_layer_init(generator, spec, cfg.w_dim, device)
    return params


def sg3_synthesis_apply(params, ws, cfg: SG3Config):
    input_kw, specs = _layer_specs(cfg)
    x = synthesis_input_apply(params["input"], ws[:, 0], **input_kw)
    for i, spec in enumerate(specs):
        x = sg3_layer_apply(params[f"L{i}"], x, ws[:, i + 1], spec)
    if cfg.output_scale != 1:
        x = x * cfg.output_scale
    return x


class SG3Generator:
    """z -> alias-free image; the SG3 counterpart of the SG2 backbone."""

    def __init__(self, cfg: SG3Config = SG3Config()):
        self.cfg = cfg

    def init(self, generator, device="cuda"):
        """Weights drawn from ``generator`` (a CPU torch.Generator), on
        ``device``."""
        from tgi_torch.nn.mapping import mapping_network_init
        return {
            "mapping": mapping_network_init(
                generator, self.cfg.z_dim, self.cfg.c_dim, self.cfg.w_dim,
                self.cfg.num_ws, num_layers=self.cfg.mapping_layers,
                device=device),
            "synthesis": sg3_synthesis_init(generator, self.cfg, device),
        }

    def mapping(self, params, z, c, **kw):
        from tgi_torch.nn.mapping import mapping_network_apply
        return mapping_network_apply(
            params["mapping"], z, c, z_dim=self.cfg.z_dim,
            c_dim=self.cfg.c_dim, num_ws=self.cfg.num_ws,
            num_layers=self.cfg.mapping_layers, **kw)

    def synthesis(self, params, ws):
        return sg3_synthesis_apply(params["synthesis"], ws, self.cfg)

    def __call__(self, params, z, c, truncation_psi=1.0):
        ws = self.mapping(params, z, c, truncation_psi=truncation_psi)
        return self.synthesis(params, ws)
