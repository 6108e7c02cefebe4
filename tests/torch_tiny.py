"""Tiny configurations of the port's tests, and port-only constructors from
them (not a test module). No JAX here: the ranks that
``tests/torch_dist.py`` spawns import this file."""

import numpy as np
import torch

# The tiny generator of ``__graft_entry__.py``: plane C = 8, 32² backbone,
# 16² rays, 8 + 8 samples, SuperresolutionTiny.
TINY = dict(z_dim=32, c_dim=25, w_dim=32, img_resolution=64,
            backbone_resolution=32, plane_channels=8, mapping_layers=2,
            channel_base=512, channel_max=32, neural_rendering_resolution=16)
TINY_RK = dict(superresolution_module="SuperresolutionTiny",
               depth_resolution=8, depth_resolution_importance=8,
               image_resolution=64)
# tests/test_gan.py's discriminator: 64², channel_base 512, channel_max 32.
TINY_D = dict(c_dim=25, img_resolution=64, img_channels=6, channel_base=512,
              channel_max=32, mbstd_group_size=2, mapping_layers=2)
# The trainer at tiny size: batch 2, 32 density points, style mixing and
# the pose swap on (gpc faded in by 1 kimg), EMA without rampup. No blur:
# tgi's ``_blur`` cannot be traced with taps.
TINY_GAN = dict(batch_size=2, blur_init_sigma=0, density_reg_samples=32,
                neural_rendering_resolution_initial=16,
                style_mixing_prob=0.5, gpc_reg_fade_kimg=1.0,
                ema_rampup=None)


def port_generator(seed=0):
    """(the port's tiny generator, its weights from ``seed`` on the CPU),
    noise strengths 0.3 and ``w_avg`` 0.5 as ``torch_helpers.tiny_pair``
    sets them."""
    from tgi_torch.models.generator import (GeneratorConfig,
                                            TriPlaneGenerator,
                                            default_rendering_kwargs)
    G = TriPlaneGenerator(GeneratorConfig(
        rendering_kwargs=default_rendering_kwargs(**TINY_RK), **TINY))
    params = G.init(torch.Generator().manual_seed(seed), device="cpu")
    _fill(params)
    params["mapping"]["w_avg"].fill_(0.5)
    return G, params


def _fill(tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            _fill(v)
        elif k == "noise_strength":
            v.fill_(0.3)


def port_camera(yaws):
    """Packed cameras [len(yaws), 25] around the FFHQ pivot, the port's."""
    from tgi_torch.render import cameras
    intr = cameras.fov_to_intrinsics(18.837, device="cpu")
    return torch.cat([cameras.pack_camera(cameras.look_at_pose(
        np.pi / 2 + y, np.pi / 2, torch.tensor([0., 0., 0.2]), radius=2.7,
        device="cpu")[None], intr) for y in yaws])
