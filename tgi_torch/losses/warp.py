"""Depth-based warping loss, stage 1's pose signal, and the image resizing
the losses share (twin of ``tgi/losses/warp.py``).

Behavioral parity target: training/warping_loss.py:6-72 +
explainability_network/loss_functions.py:9-19. Render the canonical view
from the (detached) latent, back-project the predicted view's depth to
world points, intersect the rays to the canonical camera with the
canonical image plane, project to uv, sample canonical VGG features at
the warped coordinates and take a foreground-masked L1 to the target's
features. The gradient reaches the camera pose (through the depth's
world points and the uv grid) and w (through the depth).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tgi_torch.ops.grid_sample import grid_sample_2d
from tgi_torch.render.rays import depth_to_world, ray_sampler


def area_downsample(x, out_size):
    """torch F.interpolate(mode='area') for integer shrink factors."""
    n, c, h, w = x.shape
    f = h // out_size
    if f * out_size != h or w != h:
        raise ValueError(f"area_downsample needs a square image whose side "
                         f"is a multiple of {out_size}, got {h}x{w}")
    return x.reshape(n, c, out_size, f, out_size, f).mean(dim=(3, 5))


def bilinear_resize_nchw(x, out_size):
    """``jax.image.resize(method="linear")`` to ``out_size`` square.

    jax's triangle kernel with half-pixel centres and edge
    renormalisation, widened by the scale when shrinking (antialiasing),
    is torch's bilinear ``align_corners=False`` with ``antialias=True``:
    the two agree to about 1e-7 on enlargements and on shrinks, square or
    not (``tests/test_torch_warp.py``).
    """
    return F.interpolate(x, size=(out_size, out_size), mode="bilinear",
                         align_corners=False, antialias=True)


def line_plane_collision(plane_normal, plane_point, ray_direction, ray_point,
                         epsilon=1e-6):
    """Batched line-plane intersection (warping_loss.py:58-72)."""
    ndotu = torch.sum(plane_normal * ray_direction, dim=-1, keepdim=True)
    w_vec = ray_point - plane_point
    si = -torch.sum(plane_normal * w_vec, dim=-1, keepdim=True) / ndotu
    return w_vec + si * ray_direction + plane_point


def _warp_grid(pred_ext, init_ext, intrinsic, depth):
    """The canonical view's uv [1, res, res, 2] that each pixel of the
    predicted view lands on: its depth back-projected to world points,
    the rays from the canonical camera to them cut with the canonical
    image plane, projected (warping_loss.py:18-43). One image: pred_ext
    [1, 4, 4], init_ext [1, 4, 4], intrinsic [1, 3, 3], depth [1, 1, res,
    res]."""
    res = depth.shape[-1]
    ray_origins2, ray_dirs2 = ray_sampler(pred_ext, intrinsic, res)

    # Surface points in world space, [res², 3].
    cam_xyz = depth_to_world(ray_origins2, ray_dirs2, depth)[:3].T
    n_pts = cam_xyz.shape[0]
    init_trans = init_ext[:, :3, 3]
    canonical_cam_origin = init_trans.expand(n_pts, 3)
    vectors = cam_xyz - canonical_cam_origin
    plane_norm_vector = -canonical_cam_origin
    one = torch.tensor([0., 0., 1., 1.], dtype=init_ext.dtype,
                       device=init_ext.device)
    plane_point = (init_ext.reshape(4, 4) @ one)[None, :3].expand(n_pts, 3)

    intersections = line_plane_collision(plane_norm_vector, plane_point,
                                         vectors, canonical_cam_origin)
    ones = torch.ones((n_pts, 1), dtype=intersections.dtype,
                      device=intersections.device)
    intersections1 = torch.cat([intersections, ones], dim=-1).T

    # World -> canonical camera -> normalized uv (warping_loss.py:39-43).
    w2c = torch.linalg.inv(init_ext.reshape(4, 4))
    pred_uv = (w2c @ intersections1)[:3].T
    pred_uv = pred_uv / pred_uv[:, 2:]
    pred_uv = (intrinsic.reshape(3, 3) @ pred_uv.T)[:2].T
    pred_uv = (pred_uv - 0.5) * 2
    return pred_uv.reshape(1, res, res, 2)


def _warping(canonical_images, vgg_feature_fn, pred_ext, init_ext,
             intrinsic, depth, target_images):
    """(the B images' masked-L1 feature losses [B], the canonical images
    at <= 256², the uv grids [B, res, res, 2]): each image its own mask
    (closer-than-mean depth, warping_loss.py:13-16) and warp; the VGG
    features of all B images from one call each."""
    can_images = canonical_images
    if can_images.shape[2] > 256:
        can_images = area_downsample(can_images, 256)
    B = depth.shape[0]
    uv_img = torch.cat([_warp_grid(pred_ext[b:b + 1], init_ext, intrinsic,
                                   depth[b:b + 1]) for b in range(B)])
    masked_depths = (depth < depth.mean(dim=(1, 2, 3), keepdim=True)).to(
        depth.dtype)

    target_features = vgg_feature_fn(target_images)
    synth_features = vgg_feature_fn(can_images)

    feat_res = target_features.shape[-1]
    uv_resized = bilinear_resize_nchw(uv_img.permute(0, 3, 1, 2), feat_res)
    uv_resized = uv_resized.permute(0, 2, 3, 1)
    warped_feature = grid_sample_2d(synth_features, uv_resized)
    mask = bilinear_resize_nchw(masked_depths, feat_res)

    # Masked L1 (photometric_reconstruction_loss).
    losses = torch.abs((warped_feature - target_features) * mask).mean(
        dim=(1, 2, 3))
    return losses, can_images, uv_img


def calc_warping_loss(canonical_image, vgg_feature_fn, pred_ext, init_ext,
                      intrinsic, depth, target_images):
    """Warping loss between the predicted-pose view and the canonical view.

    Args:
        canonical_image: [1, 3, R, R] canonical render in [-1, 1].
        vgg_feature_fn: images -> feature map [1, C, Hf, Hf]
            (``tgi_torch.models.vgg.warping_features`` with its weights).
        pred_ext: [1, 4, 4] predicted camera extrinsics.
        init_ext: [1, 4, 4] canonical extrinsics.
        intrinsic: [1, 3, 3].
        depth: [1, 1, res, res] predicted-view depth map.
        target_images: [1, 3, R', R'] target in [-1, 1] (the reference
            feeds the raw target, w_projector.py:109; its feature grid
            sets the loss resolution, warping_loss.py:49-55).

    Returns:
        (loss, warped_image): the masked-L1 feature loss and the canonical
        image warped to the predicted view.
    """
    losses, can_images, uv_img = _warping(
        canonical_image, vgg_feature_fn, pred_ext, init_ext, intrinsic,
        depth, target_images)
    return losses[0], grid_sample_2d(can_images, uv_img)


def calc_warping_losses(canonical_images, vgg_feature_fn, pred_ext, init_ext,
                        intrinsic, depth, target_images):
    """:func:`calc_warping_loss` of B images at once -> the B losses [B].

    canonical_images [B, 3, R, R], pred_ext [B, 4, 4], depth [B, 1, res,
    res] and target_images [B, 3, R', R'] hold one image each per row;
    init_ext [1, 4, 4] and intrinsic [1, 3, 3] are shared."""
    return _warping(canonical_images, vgg_feature_fn, pred_ext, init_ext,
                    intrinsic, depth, target_images)[0]
