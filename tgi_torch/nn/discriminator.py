"""StyleGAN2 discriminator + EG3D dual discriminator (twin of
``tgi/nn/discriminator.py``).

Behavioral parity targets:
  DiscriminatorBlock / MinibatchStdLayer / DiscriminatorEpilogue /
  Discriminator   networks_stylegan2.py:556-795
  DualDiscriminator (6-channel image+raw input, filtered raw upsample)
                  training/dual_discriminator.py:21-249

Plain PyTorch throughout: R1 differentiates D's logits twice (once to the
image, once more to the weights), so every op here keeps autograd's own
double backward.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from tgi_torch.losses.warp import bilinear_resize_nchw
from tgi_torch.nn.layers import (conv2d_layer_apply, conv2d_layer_init,
                                 fully_connected_apply, fully_connected_init)
from tgi_torch.nn.mapping import mapping_network_apply, mapping_network_init
from tgi_torch.nn.synthesis import RESAMPLE_FILTER
from tgi_torch.ops.upfirdn2d import downsample2d, upsample2d
from tgi_torch.parallel.collectives import gather_rows, own_rows


@dataclass(frozen=True)
class DiscriminatorConfig:
    c_dim: int = 25
    img_resolution: int = 512
    img_channels: int = 6           # dual discrimination: rgb + raw-rgb
    channel_base: int = 32768
    channel_max: int = 512
    mbstd_group_size: int = 4
    mbstd_num_channels: int = 1
    conv_clamp: float | None = 256
    disc_c_noise: float = 0.0
    mapping_layers: int = 8

    @property
    def block_resolutions(self):
        log2 = int(math.log2(self.img_resolution))
        return [2 ** i for i in range(log2, 2, -1)]

    @property
    def channels(self):
        return {res: min(self.channel_base // res, self.channel_max)
                for res in self.block_resolutions + [4]}

    @property
    def cmap_dim(self):
        return 0 if self.c_dim == 0 else self.channels[4]


def discriminator_block_init(generator, tmp_channels, out_channels,
                             img_channels, first_block, device="cuda"):
    params = {}
    if first_block:
        params["fromrgb"] = conv2d_layer_init(generator, img_channels,
                                              tmp_channels, 1, device=device)
    params["conv0"] = conv2d_layer_init(generator, tmp_channels, tmp_channels,
                                        3, device=device)
    params["conv1"] = conv2d_layer_init(generator, tmp_channels, out_channels,
                                        3, device=device)
    params["skip"] = conv2d_layer_init(generator, tmp_channels, out_channels,
                                       1, bias=False, device=device)
    return params


def discriminator_block_apply(params, x, img, *, conv_clamp=256):
    if "fromrgb" in params:
        y = conv2d_layer_apply(params["fromrgb"], img, activation="lrelu",
                               conv_clamp=conv_clamp)
        x = x + y if x is not None else y
    y = conv2d_layer_apply(params["skip"], x, down=2, gain=math.sqrt(0.5))
    x = conv2d_layer_apply(params["conv0"], x, activation="lrelu",
                           conv_clamp=conv_clamp)
    x = conv2d_layer_apply(params["conv1"], x, activation="lrelu", down=2,
                           conv_clamp=conv_clamp, gain=math.sqrt(0.5))
    return y + x, img


def minibatch_std(x, group_size=4, num_channels=1, mesh=None):
    """networks_stylegan2.py:645-671. Sample i groups with i + N/G, i +
    2N/G, ... of the global batch: with a data-parallel ``mesh`` the
    statistics are taken over every rank's rows (gathered, with their
    gradient), as in ``tgi``'s unsharded step, where the reference's DDP
    shrinks the groups to each GPU's batch."""
    _, C, H, W = x.shape
    xs = gather_rows(mesh, x)
    N = xs.shape[0]
    G = min(group_size, N) if group_size is not None else N
    F_ = num_channels
    c = C // F_
    y = xs.reshape(G, -1, F_, c, H, W)
    y = y - y.mean(dim=0)
    y = torch.sqrt(y.square().mean(dim=0) + 1e-8)
    y = y.mean(dim=(2, 3, 4))
    y = y.reshape(-1, F_, 1, 1)
    y = own_rows(mesh, y.repeat(G, 1, H, W))
    return torch.cat([x, y], dim=1)


def discriminator_init(generator, cfg: DiscriminatorConfig, device="cuda"):
    """Random weights from ``generator`` (a CPU ``torch.Generator``) with
    ``tgi``'s names, shapes and distributions."""
    ch = cfg.channels
    params = {}
    for res in cfg.block_resolutions:
        params[f"b{res}"] = discriminator_block_init(
            generator, ch[res], ch[res // 2], cfg.img_channels,
            first_block=(res == cfg.img_resolution), device=device)
    if cfg.c_dim > 0:
        params["mapping"] = mapping_network_init(
            generator, 0, cfg.c_dim, cfg.cmap_dim, None,
            num_layers=cfg.mapping_layers, device=device)
        del params["mapping"]["w_avg"]
    params["b4"] = {
        "conv": conv2d_layer_init(generator, ch[4] + cfg.mbstd_num_channels,
                                  ch[4], 3, device=device),
        "fc": fully_connected_init(generator, ch[4] * 16, ch[4],
                                   device=device),
        "out": fully_connected_init(
            generator, ch[4], 1 if cfg.cmap_dim == 0 else cfg.cmap_dim,
            device=device),
    }
    return params


def discriminator_apply(params, img, c, cfg: DiscriminatorConfig, *,
                        c_noise=None, mesh=None):
    """Logits [N, 1]. ``c_noise``: the ``[N, c_dim]`` standard normal
    draw that ``disc_c_noise > 0`` scales (no noise when None). With a
    data-parallel ``mesh`` (``tgi_torch.parallel``), ``img`` and ``c``
    are this rank's rows, and what reads across the batch reads the
    global batch."""
    x = None
    for res in cfg.block_resolutions:
        x, img = discriminator_block_apply(params[f"b{res}"], x, img,
                                           conv_clamp=cfg.conv_clamp)
    cmap = None
    if cfg.c_dim > 0:
        if cfg.disc_c_noise > 0 and c_noise is not None:
            # jnp.std: the population deviation.
            c = c + c_noise * gather_rows(mesh, c).std(
                dim=0, unbiased=False) * cfg.disc_c_noise
        cmap = mapping_network_apply(params["mapping"], None, c, z_dim=0,
                                     c_dim=cfg.c_dim, num_ws=None,
                                     num_layers=cfg.mapping_layers)
    ep = params["b4"]
    x = minibatch_std(x, cfg.mbstd_group_size, cfg.mbstd_num_channels,
                      mesh=mesh)
    x = conv2d_layer_apply(ep["conv"], x, activation="lrelu",
                           conv_clamp=cfg.conv_clamp)
    x = fully_connected_apply(ep["fc"], x.reshape(x.shape[0], -1),
                              activation="lrelu")
    x = fully_connected_apply(ep["out"], x)
    if cfg.cmap_dim > 0:
        x = (x * cmap).sum(dim=1, keepdim=True) * (1 / math.sqrt(cfg.cmap_dim))
    return x


def filtered_resizing(img, size, filter_mode="antialiased"):
    """dual_discriminator.py:86-103: resize the raw render to the final
    resolution before channel-concat. Four modes: 'antialiased' (default),
    'classic' (FIR up x2 -> bilinear -> FIR down x2), 'none' (plain
    bilinear), or a float in (0, 1) blending the aliased and antialiased
    resizes.

    ``tgi`` resizes with ``jax.image.resize(method="linear")``, whose
    ``antialias`` defaults to True also where ``tgi`` does not pass it
    (its 'none', 'classic' and blend paths): plain bilinear when
    enlarging, a triangle widened by the scale when shrinking. So every
    mode's resize here is the antialiased one, as in ``tgi``."""
    if filter_mode in ("antialiased", "none"):
        return bilinear_resize_nchw(img, size)
    if filter_mode == "classic":
        f = RESAMPLE_FILTER
        x = upsample2d(img, f, up=2)
        x = bilinear_resize_nchw(x, size * 2 + 2)
        return downsample2d(x, f, down=2, flip_filter=True, padding=-1)
    if isinstance(filter_mode, float):
        if not 0 < filter_mode < 1:
            raise ValueError(f"filter_mode={filter_mode}: a blend lies in "
                             f"(0, 1)")
        resized = bilinear_resize_nchw(img, size)
        return (1 - filter_mode) * resized + filter_mode * resized
    raise ValueError(f"unknown filter_mode: {filter_mode!r}")


def dual_discriminator_apply(params, img, img_raw, c,
                             cfg: DiscriminatorConfig,
                             filter_mode="antialiased", **kw):
    """DualDiscriminator.forward (dual_discriminator.py:156-173)."""
    raw_up = filtered_resizing(img_raw, img.shape[-1], filter_mode)
    x = torch.cat([img, raw_up], dim=1)
    return discriminator_apply(params, x, c, cfg, **kw)
