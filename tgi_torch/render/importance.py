"""Stratified + importance depth sampling along rays, and the merged
coarse+fine march (twin of ``tgi/render/importance.py``; parity target
renderer.py:224-308).

Every random draw can be given as a tensor (``jitter``, ``u``), so tests
feed both packages the same numbers; otherwise it is drawn from an
explicit ``torch.Generator``. ``det=True`` draws nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tgi_torch.render.maths import linspace_batch
from tgi_torch.render.march import composite_depth, transmittance_weights


def draw_uniform(shape, generator, like):
    """Uniforms in [0, 1) of ``shape`` from ``generator``, on ``like``'s
    device."""
    if generator is None:
        raise ValueError("a stochastic draw needs a torch.Generator or an "
                         "explicit tensor")
    return torch.rand(shape, generator=generator,
                      device=generator.device).to(like.device)


def sample_stratified(ray_origins, ray_start, ray_end, depth_resolution,
                      disparity_space_sampling=False, det=False,
                      jitter=None, generator=None):
    """Jittered uniform depths [N, M, depth_resolution, 1].

    ray_start/ray_end are floats or [N, M, 1] tensors (auto ray-box).
    ``jitter`` ([N, M, D, 1] in [0, 1)) replaces the uniform draw.
    """
    N, M, _ = ray_origins.shape
    D = depth_resolution
    dev = ray_origins.device

    def draw():
        return (jitter.to(dev) if jitter is not None
                else draw_uniform((N, M, D, 1), generator, ray_origins))

    if disparity_space_sampling:
        depths = torch.linspace(0., 1., D, device=dev).reshape(
            1, 1, D, 1).repeat(N, M, 1, 1)
        if not det:
            depths = depths + draw() * (1 / (D - 1))
        return 1. / (1. / ray_start * (1. - depths) + 1. / ray_end * depths)
    if torch.is_tensor(ray_start) and ray_start.ndim > 0:
        depths = linspace_batch(ray_start, ray_end, D).permute(1, 2, 0, 3)
        delta = (ray_end - ray_start) / (D - 1)                # [N, M, 1]
        if not det:
            depths = depths + draw() * delta[..., None]
    else:
        depths = torch.linspace(float(ray_start), float(ray_end), D,
                                device=dev).reshape(1, 1, D, 1).repeat(
                                    N, M, 1, 1)
        if not det:
            depths = depths + draw() * ((ray_end - ray_start) / (D - 1))
    return depths


def _smooth_weights(weights):
    """max_pool1d(2,1,pad=1) then avg_pool1d(2,1) (renderer.py:262-264)."""
    w = F.pad(weights, (1, 1))
    w = torch.maximum(w[:, :-1], w[:, 1:])     # length L+1
    w = (w[:, :-1] + w[:, 1:]) / 2             # length L
    return w + 0.01


def sample_pdf(bins, weights, N_importance, det=False, eps=1e-5, u=None,
               generator=None):
    """Inverse-CDF sampling (renderer.py:269-308).

    bins: [R, B+1]; weights: [R, B]. Returns [R, N_importance].
    ``u`` ([R, N_importance] in [0, 1)) replaces the uniform draw.
    ``tgi`` writes the search as one-hot matrices for the TPU; here it is
    ``searchsorted(cdf, u, right=True)`` (= #{j : cdf[j] <= u}) and
    ``gather``.
    """
    R, B = weights.shape
    weights = weights + eps
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)    # [R, B+1]

    if u is not None:
        u = u.to(cdf.device, cdf.dtype)
    elif det:
        u = torch.linspace(0., 1., N_importance,
                           device=cdf.device)[None].repeat(R, 1)
    else:
        u = draw_uniform((R, N_importance), generator, cdf)

    inds = torch.searchsorted(cdf, u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=B)
    cdf_g0 = torch.gather(cdf, 1, below)
    cdf_g1 = torch.gather(cdf, 1, above)
    bins_g0 = torch.gather(bins, 1, below)
    bins_g1 = torch.gather(bins, 1, above)

    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bins_g0 + (u - cdf_g0) / denom * (bins_g1 - bins_g0)


def sample_importance(z_vals, weights, N_importance, det=False, u=None,
                      generator=None):
    """Importance depths [N, M, N_importance, 1] from coarse weights.

    z_vals: [N, M, S, 1]; weights: [N, M, S-1, 1] (marcher output).
    """
    N, M, S, _ = z_vals.shape
    z_flat = z_vals.reshape(N * M, S)
    w_smooth = _smooth_weights(weights.reshape(N * M, -1))
    z_mid = 0.5 * (z_flat[:, :-1] + z_flat[:, 1:])
    samples = sample_pdf(z_mid, w_smooth[:, 1:-1], N_importance, det=det,
                         u=u, generator=generator)
    return samples.reshape(N, M, N_importance, 1).detach()


def merged_march(depths1, colors1, densities1, depths2, colors2, densities2,
                 *, clamp_mode="softplus", white_back=False):
    """Merge the coarse and fine sample sets by depth and volume-render
    them (unify_samples + mip ray marcher, renderer.py:180-190).

    As in ``tgi``, only (depth, sigma) are sorted; each sample's share of
    the midpoint weights, ``0.5 * (w[rank-1] + w[rank])``, goes back to
    its original position, and the colors are summed unsorted. The sort is
    stable, as ``jnp.argsort`` is, so tied coarse and fine depths keep
    the same order.
    """
    assert clamp_mode == "softplus"
    all_depths = torch.cat([depths1, depths2], dim=-2)
    all_colors = torch.cat([colors1, colors2], dim=-2)
    all_densities = torch.cat([densities1, densities2], dim=-2)

    order = torch.argsort(all_depths, dim=-2, stable=True)
    d_s = torch.gather(all_depths, -2, order)
    s_s = torch.gather(all_densities, -2, order)

    deltas = d_s[:, :, 1:] - d_s[:, :, :-1]
    densities_mid = F.softplus((s_s[:, :, :-1] + s_s[:, :, 1:]) / 2 - 1)
    depths_mid = (d_s[:, :, :-1] + d_s[:, :, 1:]) / 2
    weights = transmittance_weights(densities_mid, deltas)

    # Midpoint-weight redistribution to original positions.
    wpad = F.pad(weights, (0, 0, 1, 1))
    v = 0.5 * (wpad[:, :, :-1] + wpad[:, :, 1:])        # [N, M, S, 1]
    rank = torch.argsort(order, dim=-2)                 # inverse permutation
    v_orig = torch.gather(v, -2, rank)

    composite_rgb = (v_orig * all_colors).sum(dim=-2)
    depth = composite_depth(weights, depths_mid, all_depths)
    if white_back:
        composite_rgb = composite_rgb + 1 - weights.sum(dim=2)
    return composite_rgb * 2 - 1, depth, weights


def unify_samples(depths1, colors1, densities1, depths2, colors2, densities2):
    """Concat coarse+fine and sort by depth along the sample axis
    (renderer.py:212-222; ``tgi/render/importance.py:173``). The
    reference's formulation, on no path of the port: the renderer uses
    :func:`merged_march`. The sort is stable, as ``jnp.argsort`` is."""
    all_depths = torch.cat([depths1, depths2], dim=-2)
    all_colors = torch.cat([colors1, colors2], dim=-2)
    all_densities = torch.cat([densities1, densities2], dim=-2)

    order = torch.argsort(all_depths, dim=-2, stable=True)
    all_depths = torch.gather(all_depths, -2, order)
    all_colors = torch.gather(
        all_colors, -2, order.expand(*order.shape[:-1], all_colors.shape[-1]))
    all_densities = torch.gather(all_densities, -2, order)
    return all_depths, all_colors, all_densities
