"""EG3D super-resolution modules (twin of ``tgi/nn/superres.py``;
parity target training/superresolution.py:29-291).

Each variant is two synthesis blocks conditioned on the last w repeated
three times, after a bilinear resize of the raw render to the first
block's input resolution. At full width (128² render into
``SuperresolutionHybrid8XDC``) no resize happens.

Under ``superresolution_noise_mode="random"`` each layer adds a fresh
``[N, 1, res, res]`` standard normal (times its ``noise_strength``),
given as a ``noise`` dict keyed like the params; :func:`sr_random_noise`
draws one in ``tgi``'s key order.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from tgi_torch.nn.synthesis import synthesis_block_apply, synthesis_block_init


@dataclass(frozen=True)
class SRConfig:
    """Static architecture of one SR variant."""
    name: str
    input_resolution: int
    block0: tuple  # (in_ch, out_ch, resolution, up)
    block1: tuple  # (in_ch, out_ch, resolution, up)
    img_resolution: int


SR_VARIANTS = {
    "SuperresolutionHybrid8X": SRConfig(
        "SuperresolutionHybrid8X", 128, (32, 128, 256, 2), (128, 64, 512, 2), 512),
    "SuperresolutionHybrid8XDC": SRConfig(
        "SuperresolutionHybrid8XDC", 128, (32, 256, 256, 2), (256, 128, 512, 2), 512),
    "SuperresolutionHybrid4X": SRConfig(
        "SuperresolutionHybrid4X", 128, (32, 128, 128, 1), (128, 64, 256, 2), 256),
    "SuperresolutionHybrid2X": SRConfig(
        "SuperresolutionHybrid2X", 64, (32, 128, 64, 1), (128, 64, 128, 2), 128),
    "SuperresolutionHybridDeepfp32": SRConfig(
        "SuperresolutionHybridDeepfp32", 128,
        (32, 128, 128, 1), (128, 64, 256, 2), 256),
    # Miniature variant for CPU tests (no reference counterpart).
    "SuperresolutionTiny": SRConfig(
        "SuperresolutionTiny", 32, (8, 16, 32, 1), (16, 16, 64, 2), 64),
}


def sr_config_from_class_name(class_name: str) -> SRConfig:
    """Resolve a reference class path like 'training.superresolution.X'."""
    return SR_VARIANTS[class_name.rsplit(".", 1)[-1]]


def superresolution_init(generator, cfg: SRConfig, w_dim: int = 512,
                         device="cuda"):
    in0, out0, res0, _ = cfg.block0
    in1, out1, res1, _ = cfg.block1
    return {
        "block0": synthesis_block_init(generator, in0, out0, w_dim, res0, 3,
                                       device=device),
        "block1": synthesis_block_init(generator, in1, out1, w_dim, res1, 3,
                                       device=device),
    }


def sr_random_noise(cfg: SRConfig, N, draws):
    """Per-layer noise ``{"block0": {"conv0": [N, 1, r0, r0], "conv1":
    ...}, "block1": {...}}`` from a draw source
    (``tgi_torch.utils.draws``), split as ``tgi`` splits the SR's key:
    one child per block, two per block's layers
    (``tgi/nn/superres.py:106-124``, ``tgi/nn/synthesis.py:196``)."""
    noise = {}
    for name, bk, (_, _, res, _) in zip(("block0", "block1"),
                                        draws.split(2),
                                        (cfg.block0, cfg.block1)):
        k0, k1 = bk.split(2)
        noise[name] = {"conv0": k0.normal((N, 1, res, res)),
                       "conv1": k1.normal((N, 1, res, res))}
    return noise


def bilinear_resize(x, size, antialias=False):
    """Half-pixel-centre bilinear resize (``align_corners=False``), as
    ``jax.image.resize(method="linear")``. The two agree when upscaling;
    antialiasing acts only when downscaling."""
    return F.interpolate(x, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=antialias)


def superresolution_apply(params, rgb, x, ws, cfg: SRConfig, *,
                          dtype=torch.float32, conv_clamp=None,
                          sr_antialias=True, noise_mode="none",
                          noise=None, max_res=None):
    """rgb: [N,3,r,r] raw render; x: [N,32,r,r] features; ws: [N,num_ws,512].

    Returns the SR image [N, 3, img_resolution, img_resolution] (float32),
    or with ``max_res`` the accumulated rgb of the first block whose output
    resolution reaches it. Both blocks run their activations in ``dtype``
    and clamp at ``conv_clamp``; ``tgi`` clamps at 256 wherever its SR is
    set to reduced precision, also when a call forces float32.
    ``noise``: the layers' draws under ``noise_mode="random"`` (see
    :func:`sr_random_noise`).
    """
    ws = ws[:, -1:, :].repeat(1, 3, 1)
    if x.shape[-1] != cfg.input_resolution:
        x = bilinear_resize(x, cfg.input_resolution, antialias=sr_antialias)
        rgb = bilinear_resize(rgb, cfg.input_resolution,
                              antialias=sr_antialias)
    in0, _, res0, up0 = cfg.block0
    in1, _, res1, up1 = cfg.block1
    if max_res is not None and cfg.input_resolution >= max_res:
        return rgb
    noise = noise or {}
    block_kw = dict(conv_clamp=conv_clamp, noise_mode=noise_mode,
                    dtype=dtype)
    x, rgb = synthesis_block_apply(params["block0"], x, rgb, ws,
                                   in_channels=in0, up=up0,
                                   noise=noise.get("block0"), **block_kw)
    if max_res is not None and res0 >= max_res:
        return rgb
    x, rgb = synthesis_block_apply(params["block1"], x, rgb, ws,
                                   in_channels=in1, up=up1,
                                   noise=noise.get("block1"), **block_kw)
    return rgb
