"""Core StyleGAN2 layers as functions over parameter dicts (twin of
``tgi/nn/layers.py``).

Each module is an ``*_init(generator, ..., device)`` that returns a dict
of tensors, keyed as the JAX pytree (and so the reference state_dict),
plus an ``*_apply(params, ...)``. Equalized learning-rate scaling is
applied at run time, as in the reference. Parameters are float32; an
apply runs in its input's dtype (bfloat16 in the generator's
mixed-precision blocks).

Random draws use an explicit CPU ``torch.Generator`` and are then moved
to ``device``, so a seed gives the same weights on every device.

Per-image weights: where a leaf carries a leading image axis (a
``[B, O, I]`` linear weight, a ``[B, O, I, k, k]`` conv weight, a
``[B, O]`` bias), image ``b`` of the input goes through its own weights.
The apply functions tell the two cases apart by the leaf's rank, so one
code path serves a shared generator and B per-image copies of it
(batched inversion, where every image tunes its own generator).

Behavioral parity targets:
  FullyConnectedLayer  networks_stylegan2.py:95-130
  Conv2dLayer          networks_stylegan2.py:134-188
  modulated_conv2d     networks_stylegan2.py:33-91
"""

from __future__ import annotations

import math

import torch

from tgi_torch.ops.bias_act import bias_act
from tgi_torch.ops.conv2d_resample import conv2d_resample
from tgi_torch.ops.filters import setup_filter


def randn(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal draw from a CPU generator, placed on ``device``."""
    return torch.randn(tuple(shape), generator=generator,
                       dtype=torch.float32).to(device)


def normalize_2nd_moment(x, dim=1, eps=1e-8):
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


# ---------------------------------------------------------------------------
# FullyConnectedLayer


def fully_connected_init(generator, in_features, out_features, bias=True,
                         lr_multiplier=1.0, bias_init=0.0, device="cuda"):
    params = {"weight": randn(generator, (out_features, in_features), device)
              / lr_multiplier}
    if bias:
        params["bias"] = torch.full((out_features,), float(bias_init),
                                    dtype=torch.float32, device=device)
    return params


def fully_connected_apply(params, x, activation="linear", lr_multiplier=1.0):
    """x [..., I] -> [..., O]. With per-image weights ([B, O, I], bias
    [B, O]) x is [B, ..., I] and row b goes through layer b."""
    in_features = params["weight"].shape[-1]
    weight_gain = lr_multiplier / math.sqrt(in_features)
    w = params["weight"].to(x.dtype) * weight_gain
    b = params.get("bias")
    if b is not None:
        b = b.to(x.dtype)
        if lr_multiplier != 1:
            b = b * lr_multiplier
    if w.ndim == 3:
        B = w.shape[0]
        y = torch.bmm(x.reshape(B, -1, x.shape[-1]), w.transpose(1, 2))
        y = y.reshape(*x.shape[:-1], w.shape[1])
        return bias_act(y, b, dim=y.ndim - 1, act=activation)
    return bias_act(x @ w.T, b, act=activation)


# ---------------------------------------------------------------------------
# Conv2dLayer (plain conv with optional resampling)


def conv2d_layer_init(generator, in_channels, out_channels, kernel_size,
                      bias=True, device="cuda"):
    params = {"weight": randn(
        generator, (out_channels, in_channels, kernel_size, kernel_size),
        device)}
    if bias:
        params["bias"] = torch.zeros((out_channels,), dtype=torch.float32,
                                     device=device)
    return params


def conv2d_layer_apply(params, x, activation="linear", up=1, down=1,
                       resample_filter=(1, 3, 3, 1), conv_clamp=None,
                       gain=1.0):
    """x [N, I, H, W]. With per-image weights ([B, O, I, k, k], bias
    [B, O]) N = B and image b goes through conv b: one grouped conv over
    [1, B * I, H, W]."""
    out_c, in_c, kh, kw = params["weight"].shape[-4:]
    weight_gain = 1 / math.sqrt(in_c * kh * kw)
    act_gain_tbl = {"linear": 1.0, "lrelu": math.sqrt(2),
                    "relu": math.sqrt(2)}
    w = params["weight"].to(x.dtype) * weight_gain
    b = params.get("bias")
    f = setup_filter(list(resample_filter)) if (up > 1 or down > 1) else None
    if w.ndim == 5:
        B = w.shape[0]
        x = conv2d_resample(x.reshape(1, B * in_c, *x.shape[2:]),
                            w.reshape(B * out_c, in_c, kh, kw), f=f, up=up,
                            down=down, padding=kh // 2, groups=B,
                            flip_weight=(up == 1))
        x = x.reshape(B, out_c, *x.shape[2:])
    else:
        x = conv2d_resample(x, w, f=f, up=up, down=down, padding=kh // 2,
                            flip_weight=(up == 1))
    act_gain = act_gain_tbl.get(activation, 1.0) * gain
    act_clamp = conv_clamp * gain if conv_clamp is not None else None
    return bias_act(x, b.to(x.dtype) if b is not None else None,
                    act=activation, gain=act_gain, clamp=act_clamp)


# ---------------------------------------------------------------------------
# Modulated conv


def modulated_conv2d(x, weight, styles, noise=None, up=1, down=1, padding=0,
                     resample_filter=None, demodulate=True, flip_weight=True):
    """Style-modulated, demodulated convolution.

    The unfused formulation of ``tgi``: scale the activations by the
    styles before a shared-weight conv and by the demodulation
    coefficients after it. It equals the reference's grouped
    per-sample-weight conv (networks_stylegan2.py:81-91) algebraically.

    Args:
        x: [N, C_in, H, W].
        weight: [C_out, C_in, kh, kw] (shared across batch), or
            [N, C_out, C_in, kh, kw]: one base weight per image, which
            takes the reference's fused form instead (see
            :func:`_modulated_conv2d_grouped`).
        styles: [N, C_in] modulation.
        noise: optional broadcastable noise added after demodulation.

    The weight, the styles and the demodulation coefficients stay in
    their own (float32) dtype; only the activations' operands are cast.
    Where ``x`` is in reduced precision and the conv demodulates, the
    weight and the styles are first pre-normalized by their inf-norms
    in that dtype, the reference's fp16 overflow guard
    (networks_stylegan2.py:54-56).
    """
    if weight.ndim == 5:
        return _modulated_conv2d_grouped(
            x, weight, styles, noise=noise, up=up, down=down,
            padding=padding, resample_filter=resample_filter,
            demodulate=demodulate, flip_weight=flip_weight)
    out_c, in_c, kh, kw = weight.shape
    if demodulate and x.dtype != torch.float32:
        weight = weight * (1 / math.sqrt(in_c * kh * kw) / weight.abs().amax(
            dim=(1, 2, 3), keepdim=True))
        styles = styles / styles.abs().amax(dim=1, keepdim=True)
    dcoefs = None
    if demodulate:
        # [N, O]: rsqrt of sum over (I, kh, kw) of (w * s)^2, without the
        # [N, O, I, kh, kw] tensor.
        w2 = weight.square().reshape(out_c, in_c, kh * kw).sum(-1)  # [O, I]
        dcoefs = torch.rsqrt(styles.square() @ w2.T + 1e-8)         # [N, O]

    x = x * styles.to(x.dtype)[:, :, None, None]
    x = conv2d_resample(x, weight.to(x.dtype), f=resample_filter, up=up,
                        down=down, padding=padding, flip_weight=flip_weight)
    if demodulate:
        x = x * dcoefs.to(x.dtype)[:, :, None, None]
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x


def _modulated_conv2d_grouped(x, weight, styles, noise=None, up=1, down=1,
                              padding=0, resample_filter=None,
                              demodulate=True, flip_weight=True):
    """:func:`modulated_conv2d` with one base weight per image ([N, O, I,
    kh, kw]): the reference's fused form (networks_stylegan2.py:68-91),
    each image's modulated and demodulated weight in one grouped conv
    over [1, N * I, H, W]. The weights stay float32 until the conv."""
    N, out_c, in_c, kh, kw = weight.shape
    if demodulate and x.dtype != torch.float32:
        weight = weight * (1 / math.sqrt(in_c * kh * kw) / weight.abs().amax(
            dim=(2, 3, 4), keepdim=True))
        styles = styles / styles.abs().amax(dim=1, keepdim=True)
    w = weight * styles.reshape(N, 1, in_c, 1, 1)
    if demodulate:
        dcoefs = torch.rsqrt(w.square().sum(dim=(2, 3, 4)) + 1e-8)  # [N, O]
        w = w * dcoefs.reshape(N, out_c, 1, 1, 1)
    x = conv2d_resample(x.reshape(1, N * in_c, *x.shape[2:]),
                        w.reshape(N * out_c, in_c, kh, kw).to(x.dtype),
                        f=resample_filter, up=up, down=down, padding=padding,
                        groups=N, flip_weight=flip_weight)
    x = x.reshape(N, out_c, *x.shape[2:])
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x
