"""Two-pass hierarchical volumetric renderer over tri-planes (twin of
``tgi/render/renderer.py``; parity target renderer.py:137-210).

The ray-axis sharding constraint of ``tgi`` has no counterpart here; a
render runs on one device.
"""

from __future__ import annotations

import torch

from tgi_torch.ops.grid_sample import channels_last, sample_triplanes
from tgi_torch.render.decoder import osg_decoder_apply
from tgi_torch.render.importance import (merged_march, sample_importance,
                                         sample_stratified)
from tgi_torch.render.march import mip_ray_marcher
from tgi_torch.render.maths import get_ray_limits_box


def run_model(planes, decoder_params, sample_coordinates, options):
    """Tri-plane sample + decoder MLP at arbitrary 3D points.

    planes: [N, 3, C, H, W]; sample_coordinates: [N, M, 3].
    Returns {'rgb': [N, M, 32], 'sigma': [N, M, 1]}.
    """
    if options.get("density_noise", 0) > 0:
        raise NotImplementedError("density_noise > 0 is not ported yet")
    feats = sample_triplanes(planes, sample_coordinates,
                             box_warp=options["box_warp"])
    # Features come back in the planes' dtype (bf16 under
    # plane_dtype="bfloat16"); the decoder MLP always runs in float32.
    return osg_decoder_apply(decoder_params, feats.float(),
                             lr_multiplier=options.get("decoder_lr_mul", 1.0))


def importance_render(planes, decoder_params, ray_origins, ray_directions,
                      options, *, det=False, generator=None, jitter=None,
                      u=None):
    """Full hierarchical render.

    Args:
        planes: [N, 3, C, H, W] tri-plane features.
        decoder_params: OSG decoder params.
        ray_origins / ray_directions: [N, M, 3].
        options: rendering_kwargs dict (box_warp, depth_resolution,
            depth_resolution_importance, ray_start/'auto', clamp_mode ...).
        det: deterministic sampling (no jitter; linspace importance draws).
        generator: torch.Generator for the stochastic draws.
        jitter: optional [N, M, D, 1] stratified jitter in [0, 1).
        u: optional [N*M, D_importance] importance uniforms in [0, 1).

    Returns:
        (rgb_features [N, M, 32], depth [N, M, 1], weight_sum [N, M, 1]).
    """
    N, M, _ = ray_origins.shape
    # One copy into the sampling kernel's layout serves both passes.
    planes = channels_last(planes)

    if options["ray_start"] == options["ray_end"] == "auto":
        ray_start, ray_end = get_ray_limits_box(
            ray_origins, ray_directions, box_side_length=options["box_warp"])
        is_valid = ray_end > ray_start
        # Invalid rays take the min/max over the whole batch of valid rays
        # (renderer.py:148-151). As in tgi, both come from ray_start.
        big = torch.tensor(1e10, dtype=torch.float32, device=ray_start.device)
        valid_min = torch.where(is_valid, ray_start, big).min()
        valid_max = torch.where(is_valid, ray_start, -big).max()
        ray_start = torch.where(is_valid, ray_start, valid_min)
        ray_end = torch.where(is_valid, ray_end, valid_max)
    else:
        ray_start, ray_end = options["ray_start"], options["ray_end"]

    S = options["depth_resolution"]
    depths_coarse = sample_stratified(
        ray_origins, ray_start, ray_end, S,
        options.get("disparity_space_sampling", False), det=det,
        jitter=jitter, generator=generator)

    coords = (ray_origins[:, :, None, :]
              + depths_coarse * ray_directions[:, :, None, :]).reshape(N, -1, 3)
    out = run_model(planes, decoder_params, coords, options)
    colors_coarse = out["rgb"].reshape(N, M, S, -1)
    densities_coarse = out["sigma"].reshape(N, M, S, 1)

    march_kw = dict(clamp_mode=options["clamp_mode"],
                    white_back=options.get("white_back", False))
    N_importance = options["depth_resolution_importance"]
    if N_importance > 0:
        _, _, weights = mip_ray_marcher(colors_coarse, densities_coarse,
                                        depths_coarse, **march_kw)
        depths_fine = sample_importance(depths_coarse, weights, N_importance,
                                        det=det, u=u, generator=generator)
        coords = (ray_origins[:, :, None, :]
                  + depths_fine * ray_directions[:, :, None, :]
                  ).reshape(N, -1, 3)
        out = run_model(planes, decoder_params, coords, options)
        colors_fine = out["rgb"].reshape(N, M, N_importance, -1)
        densities_fine = out["sigma"].reshape(N, M, N_importance, 1)
        rgb_final, depth_final, weights = merged_march(
            depths_coarse, colors_coarse, densities_coarse,
            depths_fine, colors_fine, densities_fine, **march_kw)
    else:
        rgb_final, depth_final, weights = mip_ray_marcher(
            colors_coarse, densities_coarse, depths_coarse, **march_kw)
    return rgb_final, depth_final, weights.sum(dim=2)
