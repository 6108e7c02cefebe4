"""Two-pass hierarchical volumetric renderer over tri-planes (twin of
``tgi/render/renderer.py``; parity target renderer.py:137-210).

Under ``tgi_torch.parallel.ray_constrained`` the ray axis is cut into
contiguous chunks, one per device of the mesh's 'rays' axis, at ``tgi``'s
place (``constrain_ray_axis``); each chunk renders on its device and the
results meet on the first. The auto ray limits take their min and max
over all rays before the cut, and every draw is the unsharded render's,
cut with the rays, so the split render is the unsharded one.

``density_noise > 0`` (a rendering kwarg) adds ``normal * density_noise``
to sigma after the decoder, as ``tgi`` does. ``tgi`` draws both passes'
normals from one key (``tgi/render/renderer.py:105``, :123), so where the
coarse and the fine pass have the same shape they get the same noise; the
port keeps that reuse. The reference draws afresh for each pass.
"""

from __future__ import annotations

import torch

from tgi_torch.ops.grid_sample import channels_last, sample_triplanes
from tgi_torch.render.decoder import osg_decoder_apply
from tgi_torch.parallel.mesh import constrain_ray_axis
from tgi_torch.render.importance import (draw_uniform, merged_march,
                                         sample_importance, sample_stratified)
from tgi_torch.render.march import mip_ray_marcher
from tgi_torch.render.maths import get_ray_limits_box
from tgi_torch.utils.draws import as_draws


def run_model(planes, decoder_params, sample_coordinates, options,
              sigma_noise=None):
    """Tri-plane sample + decoder MLP at arbitrary 3D points.

    planes: [N, 3, C, H, W]; sample_coordinates: [N, M, 3].
    sigma_noise: the [N, M, 1] standard normal draw that ``density_noise
    > 0`` scales (required then, as ``tgi`` requires its key).
    Returns {'rgb': [N, M, 32], 'sigma': [N, M, 1]}.
    """
    feats = sample_triplanes(planes, sample_coordinates,
                             box_warp=options["box_warp"])
    # Features come back in the planes' dtype (bf16 under
    # plane_dtype="bfloat16"); the decoder MLP always runs in float32.
    out = osg_decoder_apply(decoder_params, feats.float(),
                            lr_multiplier=options.get("decoder_lr_mul", 1.0))
    if options.get("density_noise", 0) > 0:
        if sigma_noise is None:
            raise ValueError("density_noise > 0 needs the standard normal "
                             "draw (sigma_noise=)")
        out["sigma"] = out["sigma"] + sigma_noise * options["density_noise"]
    return out


def density_noise_draws(coarse_shape, fine_shape, rng=None, device="cuda"):
    """The standard normals of the coarse and the fine pass under
    ``density_noise > 0``, from ``rng``: a draw source or a
    ``torch.Generator`` (``utils/draws.py::as_draws``; a generator of
    seed 0 on ``device`` when None, as ``tgi`` takes ``PRNGKey(0)`` for
    a render without a key). Passes of one shape share one draw."""
    if rng is None:
        rng = torch.Generator(device=device).manual_seed(0)
    d = as_draws(rng, device)
    coarse = d.normal(coarse_shape)
    return coarse, (coarse if tuple(fine_shape) == tuple(coarse_shape)
                    else d.normal(fine_shape))


def importance_render(planes, decoder_params, ray_origins, ray_directions,
                      options, *, det=False, generator=None, jitter=None,
                      u=None, sigma_noise=None):
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
        sigma_noise: under ``density_noise > 0``, the coarse and the fine
            pass's standard normals added to sigma; drawn from
            ``generator`` by :func:`density_noise_draws` when None.

    Returns:
        (rgb_features [N, M, 32], depth [N, M, 1], weight_sum [N, M, 1]).
    """
    N, M, _ = ray_origins.shape
    # One copy into the sampling kernel's layout serves both passes.
    planes = channels_last(planes)
    # Under tgi_torch.parallel.ray_constrained: this process's chunks of
    # the ray axis, one per 'rays' device ([whole] otherwise).
    ro_parts = constrain_ray_axis(ray_origins)
    rd_parts = constrain_ray_axis(ray_directions)

    if options["ray_start"] == options["ray_end"] == "auto":
        # Over all rays of the batch, before any cut.
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
    N_importance = options["depth_resolution_importance"]
    noise_coarse = noise_fine = None
    if options.get("density_noise", 0) > 0:
        noise_coarse, noise_fine = (
            sigma_noise if sigma_noise is not None else density_noise_draws(
                (N, M * S, 1), (N, M * N_importance, 1), generator,
                ray_origins.device))
    args = dict(options=options, det=det, generator=generator)
    if len(ro_parts) == 1:
        return _render_rays(planes, decoder_params, ray_origins,
                            ray_directions, ray_start, ray_end, jitter=jitter,
                            u=u, noise_coarse=noise_coarse,
                            noise_fine=noise_fine, **args)

    # The split render: the unsharded render's draws, at its shapes and
    # in its order, cut with the rays.
    if not det:
        if jitter is None:
            jitter = draw_uniform((N, M, S, 1), generator, ray_origins)
        if u is None and N_importance > 0:
            u = draw_uniform((N * M, N_importance), generator, ray_origins)

    def cut(t, shape):
        """``t`` viewed as [N, M, ...], cut along M; each piece reshaped
        to ``shape(m)`` (floats and None go to every piece)."""
        if not torch.is_tensor(t):
            return [t] * len(ro_parts)
        return [p.reshape(shape(p.shape[1]))
                for p in constrain_ray_axis(t.reshape(N, M, -1))]

    pieces = [
        _render_rays(planes.to(o.device), _to(decoder_params, o.device), o,
                     d, s, e, jitter=j, u=uu, noise_coarse=nc,
                     noise_fine=nf, **args)
        for o, d, s, e, j, uu, nc, nf in zip(
            ro_parts, rd_parts, cut(ray_start, lambda m: (N, m, 1)),
            cut(ray_end, lambda m: (N, m, 1)),
            cut(jitter, lambda m: (N, m, S, 1)),
            cut(u, lambda m: (N * m, N_importance)),
            cut(noise_coarse, lambda m: (N, m * S, 1)),
            cut(noise_fine, lambda m: (N, m * N_importance, 1)))]
    first = ray_origins.device
    return tuple(torch.cat([p[i].to(first) for p in pieces], dim=1)
                 for i in range(3))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _render_rays(planes, decoder_params, ray_origins, ray_directions,
                 ray_start, ray_end, *, options, det, generator, jitter, u,
                 noise_coarse, noise_fine):
    """Both passes and the merged march over the rays given; ray_start /
    ray_end are floats or their [N, M, 1] tensors."""
    N, M, _ = ray_origins.shape
    S = options["depth_resolution"]
    N_importance = options["depth_resolution_importance"]
    depths_coarse = sample_stratified(
        ray_origins, ray_start, ray_end, S,
        options.get("disparity_space_sampling", False), det=det,
        jitter=jitter, generator=generator)

    coords = (ray_origins[:, :, None, :]
              + depths_coarse * ray_directions[:, :, None, :]).reshape(N, -1, 3)
    out = run_model(planes, decoder_params, coords, options,
                    sigma_noise=noise_coarse)
    colors_coarse = out["rgb"].reshape(N, M, S, -1)
    densities_coarse = out["sigma"].reshape(N, M, S, 1)

    march_kw = dict(clamp_mode=options["clamp_mode"],
                    white_back=options.get("white_back", False))
    if N_importance > 0:
        _, _, weights = mip_ray_marcher(colors_coarse, densities_coarse,
                                        depths_coarse, **march_kw)
        depths_fine = sample_importance(depths_coarse, weights, N_importance,
                                        det=det, u=u, generator=generator)
        coords = (ray_origins[:, :, None, :]
                  + depths_fine * ray_directions[:, :, None, :]
                  ).reshape(N, -1, 3)
        out = run_model(planes, decoder_params, coords, options,
                        sigma_noise=noise_fine)
        colors_fine = out["rgb"].reshape(N, M, N_importance, -1)
        densities_fine = out["sigma"].reshape(N, M, N_importance, 1)
        rgb_final, depth_final, weights = merged_march(
            depths_coarse, colors_coarse, densities_coarse,
            depths_fine, colors_fine, densities_fine, **march_kw)
    else:
        rgb_final, depth_final, weights = mip_ray_marcher(
            colors_coarse, densities_coarse, depths_coarse, **march_kw)
    return rgb_final, depth_final, weights.sum(dim=2)
