"""Standalone 2D StyleGAN2 generator (mapping + skip-architecture synthesis;
twin of ``tgi/models/stylegan2.py``).

The tri-plane generator already uses this stack as its backbone
(``tgi_torch.nn.synthesis``); this wrapper exposes the plain 2D image
generator as its own model family so TF-era StyleGAN2 pickles — which
predate the tri-plane decoder — convert into something directly usable
(``tgi_torch.io.legacy_tf``).

Behavioral parity: networks_stylegan2.py:474-524 (SynthesisNetwork),
networks_stylegan2.py:528-553 (Generator.forward = mapping -> synthesis).
Fixed choices (validated by the TF converter): 'skip' architecture, lrelu
nonlinearity, [1,3,3,1] resample kernel, noise enabled. Under
``noise_mode="random"`` the per-layer noise is given as ``noise`` (see
``nn/synthesis.py::random_noise``) or drawn from ``generator``.
"""

from __future__ import annotations

from dataclasses import dataclass

from tgi_torch.nn.mapping import mapping_network_apply, mapping_network_init
from tgi_torch.nn.synthesis import (SynthesisConfig, synthesis_network_apply,
                                    synthesis_network_init)


@dataclass(frozen=True)
class SG2Config:
    z_dim: int = 512
    c_dim: int = 0
    w_dim: int = 512
    img_resolution: int = 1024
    img_channels: int = 3
    channel_base: int = 32768
    channel_max: int = 512
    mapping_layers: int = 8
    num_fp16_res: int = 0
    conv_clamp: float | None = None
    fused_dtype: str = "float32"

    @property
    def synthesis_cfg(self) -> SynthesisConfig:
        return SynthesisConfig(
            w_dim=self.w_dim, img_resolution=self.img_resolution,
            img_channels=self.img_channels, channel_base=self.channel_base,
            channel_max=self.channel_max, num_fp16_res=self.num_fp16_res,
            conv_clamp=self.conv_clamp, fused_dtype=self.fused_dtype)

    @property
    def num_ws(self) -> int:
        return self.synthesis_cfg.num_ws


def sg2_generator_init(generator, cfg: SG2Config, device="cuda") -> dict:
    """Random weights from ``generator`` (a CPU ``torch.Generator``) with
    ``tgi``'s names, shapes and distributions."""
    return {
        "mapping": mapping_network_init(
            generator, cfg.z_dim, cfg.c_dim, cfg.w_dim, cfg.num_ws,
            num_layers=cfg.mapping_layers, device=device),
        "synthesis": synthesis_network_init(generator, cfg.synthesis_cfg,
                                            device=device),
    }


def sg2_mapping(params, z, c, cfg: SG2Config, *, truncation_psi=1.0,
                truncation_cutoff=None):
    return mapping_network_apply(
        params["mapping"], z, c, z_dim=cfg.z_dim, c_dim=cfg.c_dim,
        num_ws=cfg.num_ws, num_layers=cfg.mapping_layers,
        truncation_psi=truncation_psi, truncation_cutoff=truncation_cutoff)


def sg2_synthesis(params, ws, cfg: SG2Config, *, noise_mode="const",
                  noise=None, generator=None, force_fp32=False):
    return synthesis_network_apply(
        params["synthesis"], ws, cfg.synthesis_cfg, noise_mode=noise_mode,
        noise=noise, generator=generator, force_fp32=force_fp32)


def sg2_generator_apply(params, z, c, cfg: SG2Config, *, truncation_psi=1.0,
                        truncation_cutoff=None, noise_mode="const",
                        noise=None, generator=None, force_fp32=False):
    """z [N, z_dim], c [N, c_dim] -> img [N, img_channels, R, R] float32."""
    ws = sg2_mapping(params, z, c, cfg, truncation_psi=truncation_psi,
                     truncation_cutoff=truncation_cutoff)
    return sg2_synthesis(params, ws, cfg, noise_mode=noise_mode, noise=noise,
                         generator=generator, force_fp32=force_fp32)
