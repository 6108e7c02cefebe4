"""StyleGAN2 synthesis network, skip architecture (twin of
``tgi/nn/synthesis.py``).

Behavioral parity targets (networks_stylegan2.py):
  SynthesisLayer    :275-336
  ToRGBLayer        :340-365
  SynthesisBlock    :369-470
  SynthesisNetwork  :474-524

Mixed precision as in ``tgi``: with ``fused_dtype="bfloat16"`` (or
``"float16"``) the blocks at ``fp16_resolution`` and above run their
activations in that dtype (the reference's fp16 blocks), with the weight
and style pre-normalization and ``conv_clamp``; parameters, styles and
the accumulated image stay float32. Noise modes: ``"const"`` (the stored
``noise_const`` buffers), ``"none"``, and ``"random"``: a fresh
``[N, 1, res, res]`` standard normal per layer, times the layer's
``noise_strength``, drawn from a ``torch.Generator`` or given as a
``noise`` dict keyed like the params (``{"b8": {"conv0": t, "conv1":
t}, ...}``; :func:`random_noise` draws one in ``tgi``'s key order).

Per-image leaves (``nn/layers.py``): a leaf with a leading image axis
serves image b with its slice b, every other leaf is shared. Stage 1 of
batched inversion stacks only ``noise_const`` (``[B, res, res]``); stage
2 stacks every leaf, so ``const`` is ``[B, C, 4, 4]`` and
``noise_strength`` ``[B]``. The batch of ``ws`` is then B.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from tgi_torch.nn.layers import (fully_connected_apply, fully_connected_init,
                                 modulated_conv2d, randn)
from tgi_torch.ops.bias_act import activation_funcs, bias_act
from tgi_torch.ops.filters import setup_filter
from tgi_torch.ops.upfirdn2d import upsample2d
from tgi_torch.utils.draws import TorchDraws

RESAMPLE_FILTER = setup_filter([1, 3, 3, 1])
NOISE_MODES = ("const", "none", "random")


def block_resolutions(img_resolution: int) -> list[int]:
    log2 = int(math.log2(img_resolution))
    assert 2 ** log2 == img_resolution and img_resolution >= 4
    return [2 ** i for i in range(2, log2 + 1)]


def channels_for(img_resolution: int, channel_base: int = 32768,
                 channel_max: int = 512) -> dict[int, int]:
    return {res: min(channel_base // res, channel_max)
            for res in block_resolutions(img_resolution)}


def synthesis_num_ws(img_resolution: int) -> int:
    """num_conv per block (+1 torgb on the last block)."""
    return sum(1 if res == 4 else 2
               for res in block_resolutions(img_resolution)) + 1


@dataclass(frozen=True)
class SynthesisConfig:
    w_dim: int = 512
    img_resolution: int = 256
    img_channels: int = 96
    channel_base: int = 32768
    channel_max: int = 512
    num_fp16_res: int = 4
    conv_clamp: float | None = 256
    fused_dtype: str = "float32"  # 'bfloat16' enables mixed precision

    @property
    def resolutions(self):
        return block_resolutions(self.img_resolution)

    @property
    def channels(self):
        return channels_for(self.img_resolution, self.channel_base,
                            self.channel_max)

    @property
    def fp16_resolution(self):
        return max(2 ** (int(math.log2(self.img_resolution)) + 1
                         - self.num_fp16_res), 8)

    @property
    def num_ws(self):
        return synthesis_num_ws(self.img_resolution)


def _check_noise_mode(noise_mode):
    if noise_mode not in NOISE_MODES:
        raise NotImplementedError(
            f"noise_mode={noise_mode!r}: tgi_torch supports {NOISE_MODES}")


# ---------------------------------------------------------------------------
# SynthesisLayer


def _per_image(t, rank):
    """A leaf of rank ``rank`` (one value per image: ``[B, res, res]``
    noise, ``[B]`` strengths) as ``[B, 1, 1, 1]``-broadcastable over the
    activations; a shared leaf as it is."""
    return t.reshape(t.shape[0], 1, *t.shape[1:], *([1] * (3 - rank))) \
        if t.ndim == rank else t


def synthesis_layer_init(generator, in_channels, out_channels, w_dim,
                         resolution, kernel_size=3, use_noise=True,
                         device="cuda"):
    params = {
        "affine": fully_connected_init(generator, w_dim, in_channels,
                                       bias_init=1.0, device=device),
        "weight": randn(generator, (out_channels, in_channels, kernel_size,
                                    kernel_size), device),
        "bias": torch.zeros((out_channels,), dtype=torch.float32,
                            device=device),
    }
    if use_noise:
        params["noise_const"] = randn(generator, (resolution, resolution),
                                      device)
        params["noise_strength"] = torch.zeros((), dtype=torch.float32,
                                               device=device)
    return params


def synthesis_layer_apply(params, x, w, *, up=1, use_noise=True,
                          activation="lrelu", conv_clamp=None,
                          noise_mode="const", noise=None, gain=1.0):
    """``noise``: the layer's ``[N, 1, res, res]`` draw under
    ``noise_mode="random"``."""
    _check_noise_mode(noise_mode)
    styles = fully_connected_apply(params["affine"], w)
    if not use_noise or noise_mode == "none":
        noise = None
    elif noise_mode == "const":
        noise = _per_image(params["noise_const"], 3) * _per_image(
            params["noise_strength"], 1)
    elif noise is None:
        raise ValueError("noise_mode='random' needs the layer's noise")
    else:
        noise = noise * _per_image(params["noise_strength"], 1)

    x = modulated_conv2d(x, params["weight"], styles, noise=noise, up=up,
                         padding=params["weight"].shape[-1] // 2,
                         resample_filter=RESAMPLE_FILTER if up > 1 else None,
                         flip_weight=(up == 1))
    act_gain = activation_funcs[activation].def_gain * gain
    act_clamp = conv_clamp * gain if conv_clamp is not None else None
    return bias_act(x, params["bias"].to(x.dtype), act=activation,
                    gain=act_gain, clamp=act_clamp)


# ---------------------------------------------------------------------------
# ToRGBLayer


def torgb_layer_init(generator, in_channels, out_channels, w_dim,
                     kernel_size=1, device="cuda"):
    return {
        "affine": fully_connected_init(generator, w_dim, in_channels,
                                       bias_init=1.0, device=device),
        "weight": randn(generator, (out_channels, in_channels, kernel_size,
                                    kernel_size), device),
        "bias": torch.zeros((out_channels,), dtype=torch.float32,
                            device=device),
    }


def torgb_layer_apply(params, x, w, *, conv_clamp=None):
    out_c, in_c, kh, kw = params["weight"].shape[-4:]
    weight_gain = 1 / math.sqrt(in_c * kh * kw)
    styles = fully_connected_apply(params["affine"], w) * weight_gain
    x = modulated_conv2d(x, params["weight"], styles, demodulate=False)
    return bias_act(x, params["bias"].to(x.dtype), clamp=conv_clamp)


# ---------------------------------------------------------------------------
# SynthesisBlock


def synthesis_block_init(generator, in_channels, out_channels, w_dim,
                         resolution, img_channels, use_noise=True,
                         device="cuda"):
    params = {}
    if in_channels == 0:
        params["const"] = randn(generator,
                                (out_channels, resolution, resolution), device)
    else:
        params["conv0"] = synthesis_layer_init(
            generator, in_channels, out_channels, w_dim, resolution,
            use_noise=use_noise, device=device)
    params["conv1"] = synthesis_layer_init(
        generator, out_channels, out_channels, w_dim, resolution,
        use_noise=use_noise, device=device)
    # Skip architecture: every block carries a torgb (accumulated output).
    params["torgb"] = torgb_layer_init(generator, out_channels, img_channels,
                                       w_dim, device=device)
    return params


def block_dtype(fused_dtype, use_fp16, force_fp32=False):
    """The dtype a block runs its activations in: ``fused_dtype`` where
    the block is one of the reduced-precision ones (``use_fp16``) and the
    call does not force float32."""
    return (getattr(torch, fused_dtype) if use_fp16 and not force_fp32
            else torch.float32)


def synthesis_block_apply(params, x, img, ws, *, in_channels, conv_clamp=256,
                          use_noise=True, noise_mode="const", noise=None,
                          up=2, dtype=torch.float32):
    """ws: [N, num_conv + 1, w_dim]. Returns (x, img): x in ``dtype``
    (the block's, see ``block_dtype``), img float32. ``noise``: the
    block's ``{"conv0": t, "conv1": t}`` under ``noise_mode="random"``.

    ``up=1`` is the SR 'NoUp' variant (superresolution.py:158-257)."""
    w_idx = 0
    noise = noise or {}
    if in_channels == 0:
        const = params["const"].to(dtype)
        x = const if const.ndim == 4 else const[None].repeat(
            ws.shape[0], 1, 1, 1)
    else:
        x = synthesis_layer_apply(
            params["conv0"], x.to(dtype), ws[:, w_idx], up=up,
            use_noise=use_noise, conv_clamp=conv_clamp, noise_mode=noise_mode,
            noise=noise.get("conv0"))
        w_idx += 1
    x = synthesis_layer_apply(
        params["conv1"], x, ws[:, w_idx], use_noise=use_noise,
        conv_clamp=conv_clamp, noise_mode=noise_mode,
        noise=noise.get("conv1"))
    w_idx += 1

    if img is not None and up > 1:
        img = upsample2d(img, RESAMPLE_FILTER)
    y = torgb_layer_apply(params["torgb"], x, ws[:, w_idx],
                          conv_clamp=conv_clamp).float()
    img = img + y if img is not None else y
    return x, img


# ---------------------------------------------------------------------------
# SynthesisNetwork


def synthesis_network_init(generator, cfg: SynthesisConfig, device="cuda"):
    params = {}
    channels = cfg.channels
    for res in cfg.resolutions:
        in_ch = channels[res // 2] if res > 4 else 0
        params[f"b{res}"] = synthesis_block_init(
            generator, in_ch, channels[res], cfg.w_dim, res,
            cfg.img_channels, device=device)
    return params


def random_noise(cfg: SynthesisConfig, N, draws):
    """Per-layer noise ``{"b{res}": {"conv0": [N, 1, res, res], "conv1":
    ...}}`` from a draw source (``tgi_torch.utils.draws``), split as
    ``tgi`` splits its noise key: one child per block, two per block's
    layers (``tgi/nn/synthesis.py:190-196``, ``:245-252``)."""
    noise = {}
    for bk, res in zip(draws.split(len(cfg.resolutions)), cfg.resolutions):
        k0, k1 = bk.split(2)
        block = {"conv0": k0.normal((N, 1, res, res))} if res > 4 else {}
        block["conv1"] = k1.normal((N, 1, res, res))
        noise[f"b{res}"] = block
    return noise


def synthesis_network_apply(params, ws, cfg: SynthesisConfig, *,
                            noise_mode="const", noise=None, generator=None,
                            force_fp32=False):
    """ws: [N, num_ws, w_dim] -> img [N, img_channels, R, R] (float32).

    Under ``noise_mode="random"`` the noise is ``noise`` (see
    :func:`random_noise`), else drawn from ``generator``.
    ``force_fp32`` runs every block in float32 whatever ``fused_dtype``
    says."""
    _check_noise_mode(noise_mode)
    if noise_mode == "random" and noise is None:
        if generator is None:
            raise ValueError("noise_mode='random' needs noise= or "
                             "generator=")
        noise = random_noise(cfg, ws.shape[0],
                             TorchDraws(generator, ws.device))
    channels = cfg.channels
    ws = ws.float()
    x = img = None
    w_idx = 0
    for res in cfg.resolutions:
        in_ch = channels[res // 2] if res > 4 else 0
        num_conv = 1 if res == 4 else 2
        x, img = synthesis_block_apply(
            params[f"b{res}"], x, img, ws[:, w_idx:w_idx + num_conv + 1],
            in_channels=in_ch, conv_clamp=cfg.conv_clamp,
            noise_mode=noise_mode,
            noise=None if noise is None else noise[f"b{res}"],
            dtype=block_dtype(
                cfg.fused_dtype, res >= cfg.fp16_resolution, force_fp32))
        w_idx += num_conv
    return img
