"""EG3D tri-plane generator (twin of ``tgi/models/generator.py``; parity
target training/triplane.py:18-136).

A frozen config plus a params dict. ``synthesis`` runs ray sampling, the
StyleGAN2 backbone, the two-pass volume render and the super-resolution
eagerly on the params' device.

Precision as in ``tgi``: ``fused_dtype="bfloat16"`` runs the backbone's
high-resolution blocks and (with ``sr_num_fp16_res > 0``) the SR in bf16,
while parameters, styles, the planes the backbone returns and every
image stay float32; ``force_fp32`` turns it off for one call (stage 1's
renders). ``fused_dtype="float16"`` does the same in float16, which
``tgi`` also accepts. ``plane_dtype="bfloat16"`` rounds the planes to bf16
before the render; the sampler still reads them in float32.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any

import torch

from tgi_torch.nn.mapping import mapping_network_apply, mapping_network_init
from tgi_torch.nn.superres import (SRConfig, sr_config_from_class_name,
                                   sr_random_noise, superresolution_apply,
                                   superresolution_init)
from tgi_torch.nn.synthesis import (SynthesisConfig, block_dtype,
                                    synthesis_network_apply,
                                    synthesis_network_init)
from tgi_torch.render.decoder import osg_decoder_init
from tgi_torch.render.rays import ray_sampler
from tgi_torch.render.renderer import importance_render, run_model
from tgi_torch.utils.draws import TorchDraws
from tgi_torch.utils.shapes import assert_shape

# The activations' dtypes of the mixed-precision blocks, and the planes'.
FUSED_DTYPES = ("float32", "bfloat16", "float16")
PLANE_DTYPES = ("float32", "bfloat16")


def default_rendering_kwargs(**overrides) -> dict:
    """rendering_kwargs as shipped in the FFHQ-rebalanced pickle; keys kept
    verbatim for checkpoint compatibility."""
    kw = dict(
        image_resolution=512,
        disparity_space_sampling=False,
        clamp_mode="softplus",
        superresolution_module=(
            "training.superresolution.SuperresolutionHybrid8XDC"),
        c_gen_conditioning_zero=False,
        c_scale=1.0,
        superresolution_noise_mode="none",
        density_reg=0.25,
        density_reg_p_dist=0.004,
        reg_type="l1",
        decoder_lr_mul=1.0,
        sr_antialias=True,
        depth_resolution=48,
        depth_resolution_importance=48,
        ray_start=2.25,
        ray_end=3.3,
        box_warp=1.0,
        avg_camera_radius=2.7,
        avg_camera_pivot=[0, 0, 0.2],
        white_back=False,
        density_noise=0,
    )
    kw.update(overrides)
    return kw


@dataclass(frozen=True)
class GeneratorConfig:
    z_dim: int = 512
    c_dim: int = 25
    w_dim: int = 512
    img_resolution: int = 512
    img_channels: int = 3
    backbone_resolution: int = 256
    plane_channels: int = 32
    n_planes: int = 3
    sr_num_fp16_res: int = 4
    neural_rendering_resolution: int = 64
    mapping_layers: int = 8
    channel_base: int = 32768
    channel_max: int = 512
    fused_dtype: str = "float32"  # 'bfloat16' / 'float16': mixed precision
    plane_dtype: str = "float32"  # the dtype the tri-planes are sampled in
    rendering_kwargs: Any = field(default_factory=default_rendering_kwargs)

    def __post_init__(self):
        for name, allowed in (("fused_dtype", FUSED_DTYPES),
                              ("plane_dtype", PLANE_DTYPES)):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name}={getattr(self, name)!r}: expected "
                                 f"one of {allowed}")

    @property
    def backbone_cfg(self) -> SynthesisConfig:
        return SynthesisConfig(
            w_dim=self.w_dim, img_resolution=self.backbone_resolution,
            img_channels=self.plane_channels * self.n_planes,
            channel_base=self.channel_base, channel_max=self.channel_max,
            fused_dtype=self.fused_dtype)

    @property
    def sr_cfg(self) -> SRConfig:
        return sr_config_from_class_name(
            self.rendering_kwargs["superresolution_module"])

    @property
    def num_ws(self) -> int:
        return self.backbone_cfg.num_ws

    def with_rendering(self, **overrides) -> "GeneratorConfig":
        """This config with ``rendering_kwargs`` updated by
        ``overrides`` (e.g. fewer samples per ray)."""
        return replace(self, rendering_kwargs={**self.rendering_kwargs,
                                               **overrides})


def stack_params(params, B):
    """B per-image copies of ``params`` in one tree: every leaf repeated
    on a new leading image axis. ``synthesis`` then renders image b of
    its batch with copy b (``nn/layers.py``'s per-image leaves)."""
    if isinstance(params, dict):
        return {k: stack_params(v, B) for k, v in params.items()}
    return params.detach()[None].repeat(B, *([1] * params.ndim))


def take_image(params, i):
    """Copy ``i`` of a tree that :func:`stack_params` made (every leaf
    per image), as a plain params tree."""
    if isinstance(params, dict):
        return {k: take_image(v, i) for k, v in params.items()}
    return params[i]


class TriPlaneGenerator:
    """Stateless functional model: all tensors live in the params dict."""

    def __init__(self, cfg: GeneratorConfig | None = None):
        self.cfg = cfg or GeneratorConfig()

    def init(self, generator: torch.Generator, device="cuda") -> dict:
        """Random weights from ``generator`` (a CPU torch.Generator), with
        the JAX package's distributions: unit normal weights under
        run-time equalised-lr scaling, zero or ``bias_init`` biases,
        ``w_avg`` zero."""
        cfg = self.cfg
        return {
            "mapping": mapping_network_init(
                generator, cfg.z_dim, cfg.c_dim, cfg.w_dim, cfg.num_ws,
                num_layers=cfg.mapping_layers, device=device),
            "backbone": synthesis_network_init(generator, cfg.backbone_cfg,
                                               device=device),
            "superresolution": superresolution_init(
                generator, cfg.sr_cfg, w_dim=cfg.w_dim, device=device),
            "decoder": osg_decoder_init(generator, cfg.plane_channels,
                                        output_dim=cfg.plane_channels,
                                        device=device),
        }

    def mapping(self, params, z, c, truncation_psi=1.0,
                truncation_cutoff=None):
        """z [N, z_dim], c [N, 25] -> ws [N, num_ws, w_dim]
        (triplane.py:48-51)."""
        cfg = self.cfg
        assert_shape(z, (None, cfg.z_dim), "z")
        assert_shape(c, (None, cfg.c_dim), "c (camera conditioning)")
        if cfg.rendering_kwargs.get("c_gen_conditioning_zero", False):
            c = torch.zeros_like(c)
        c = c * cfg.rendering_kwargs.get("c_scale", 0.0)
        return mapping_network_apply(
            params["mapping"], z, c, z_dim=cfg.z_dim, c_dim=cfg.c_dim,
            num_ws=cfg.num_ws, num_layers=cfg.mapping_layers,
            truncation_psi=truncation_psi,
            truncation_cutoff=truncation_cutoff)

    def backbone_planes(self, params, ws, *, noise_mode="const", noise=None,
                        generator=None, force_fp32=False):
        """ws -> tri-planes [N, 3, 32, 256, 256], float32
        (triplane.py:71-76). ``noise`` / ``generator``: the per-layer
        noise under ``noise_mode="random"`` (see
        ``synthesis_network_apply``)."""
        cfg = self.cfg
        planes = synthesis_network_apply(params["backbone"], ws,
                                         cfg.backbone_cfg,
                                         noise_mode=noise_mode, noise=noise,
                                         generator=generator,
                                         force_fp32=force_fp32)
        N = planes.shape[0]
        return planes.reshape(N, cfg.n_planes, cfg.plane_channels,
                              planes.shape[-2], planes.shape[-1])

    def synthesis(self, params, ws, c, *, neural_rendering_resolution=None,
                  noise_mode="const", det=True, generator=None, planes=None,
                  sr_max_res=None, jitter=None, u=None, noise=None,
                  sigma_noise=None, sr_noise=None, force_fp32=False):
        """Full render: ws [N, num_ws, 512], c [N, 25] ->
        {'image', 'image_raw', 'image_depth', 'planes'} (triplane.py:53-90).

        ``planes`` skips the backbone (the reference's cache_backbone /
        use_cached_backbone contract). ``generator`` drives the render's
        random draws when ``det`` is False, the backbone's noise under
        ``noise_mode="random"`` (``tgi``'s trainer), the density noise
        and the SR's noise; ``jitter``, ``u``, ``sigma_noise`` (see
        ``importance_render``), ``noise`` (see
        ``synthesis_network_apply``) and ``sr_noise`` (see
        ``nn/superres.py::sr_random_noise``) give them as tensors
        instead. The SR's noise mode is the rendering kwargs'
        ``superresolution_noise_mode``; under "random" its noise is
        ``sr_noise``, else drawn from ``generator``.
        ``sr_max_res`` truncates the SR pyramid (see
        superresolution_apply). ``force_fp32`` renders in float32 whatever
        ``fused_dtype`` says (``plane_dtype`` still applies, as in
        ``tgi``).

        ``params`` may carry per-image leaves (:func:`stack_params`, or
        only the ``noise_const`` buffers stacked): then N is the number
        of images, and one call renders them all, the tri-plane sampler
        taking all N images' planes and points in one launch per pass.
        """
        cfg = self.cfg
        rk = cfg.rendering_kwargs
        res = neural_rendering_resolution or cfg.neural_rendering_resolution
        assert_shape(ws, (None, cfg.num_ws, cfg.w_dim), "ws")
        assert_shape(c, (None, 25), "c (flat cam2world + intrinsics)")
        N = c.shape[0]
        cam2world = c[:, :16].reshape(N, 4, 4)
        intrinsics = c[:, 16:25].reshape(N, 3, 3)

        ray_origins, ray_dirs = ray_sampler(cam2world, intrinsics, res)
        if planes is None:
            planes = self.backbone_planes(params, ws, noise_mode=noise_mode,
                                          noise=noise, generator=generator,
                                          force_fp32=force_fp32)

        feature_samples, depth_samples, _ = importance_render(
            planes.to(getattr(torch, cfg.plane_dtype)), params["decoder"],
            ray_origins, ray_dirs, rk, det=det, generator=generator,
            jitter=jitter, u=u, sigma_noise=sigma_noise)

        feature_image = feature_samples.permute(0, 2, 1).reshape(
            N, feature_samples.shape[-1], res, res)
        depth_image = depth_samples.permute(0, 2, 1).reshape(N, 1, res, res)
        rgb_image = feature_image[:, :3]
        sr_fp16 = cfg.sr_num_fp16_res > 0 and cfg.fused_dtype != "float32"
        sr_noise_mode = rk.get("superresolution_noise_mode", "none")
        if (sr_noise_mode == "random" and sr_noise is None
                and generator is not None):
            sr_noise = sr_random_noise(cfg.sr_cfg, N,
                                       TorchDraws(generator, c.device))
        sr_image = superresolution_apply(
            params["superresolution"], rgb_image, feature_image, ws,
            cfg.sr_cfg,
            dtype=block_dtype(cfg.fused_dtype, sr_fp16, force_fp32),
            conv_clamp=(256 if sr_fp16 else None),
            sr_antialias=rk.get("sr_antialias", True),
            noise_mode=sr_noise_mode, noise=sr_noise, max_res=sr_max_res)
        return {"image": sr_image, "image_raw": rgb_image,
                "image_depth": depth_image, "planes": planes}

    def sample_mixed(self, params, coordinates, ws, *, noise_mode="const",
                     planes=None):
        """sigma and rgb at arbitrary 3D points ``coordinates`` [N, M, 3]
        from ``ws`` (triplane.py:101-105); the shape-extraction path.
        The planes (``planes`` skips the backbone) are sampled in
        float32."""
        if planes is None:
            planes = self.backbone_planes(params, ws, noise_mode=noise_mode)
        return run_model(planes.float(), params["decoder"], coordinates,
                         self.cfg.rendering_kwargs)

    def sample(self, params, coordinates, z, c, truncation_psi=1.0,
               **kwargs):
        """sigma and rgb at arbitrary 3D points from z
        (triplane.py:92-99)."""
        ws = self.mapping(params, z, c, truncation_psi=truncation_psi)
        return self.sample_mixed(params, coordinates, ws, **kwargs)

    def __call__(self, params, z, c, truncation_psi=1.0,
                 truncation_cutoff=None, **synthesis_kwargs):
        ws = self.mapping(params, z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff)
        return self.synthesis(params, ws, c, **synthesis_kwargs)
