"""Pose-estimator pipeline: pseudo-dataset generation + training (twin of
``tgi/apps/pose_pipeline.py``).

Behavioral parity targets:
  scripts/gen_pseudo_dataset.py:105-206 — render EG3D samples at random
    yaw/pitch with canonical conditioning, save images + extrinsics.
  scripts/train_pose_estimator.py:25-259 — ResNet-34 on the pseudo data
    with geodesic rotation loss + 10x translation MSE + anti-diagonal
    regularizer, Adam, periodic validation and best-model checkpointing.

``tgi`` renders and trains through jitted calls; here both are Python
loops. Adam is ``torch.optim.Adam`` with optax's defaults (b1 0.9, b2
0.999, eps 1e-8) over every leaf of the pose tree, BatchNorm statistics
included, as ``jax.grad`` over the pytree does. The training minibatches
are ``tgi``'s: ``numpy.random.RandomState(0).choice`` over the train
split. PNG I/O goes through ``tgi_torch.utils.image`` (Pillow, imported
where it is used).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from tgi_torch.invert.coach import _leaves, _map
from tgi_torch.models.pose_resnet import resnet34_apply
from tgi_torch.render.cameras import (euler_to_rotmat, fov_to_intrinsics,
                                      look_at_pose, pack_camera,
                                      quaternion_to_rotmat, rot6d_to_rotmat)

ADAM = dict(betas=(0.9, 0.999), eps=1e-8)


def canonical_condition(radius=2.7, fov=18.837, device="cuda"):
    """The frontal camera every pseudo-dataset latent is mapped under,
    packed [1, 25]."""
    return pack_camera(look_at_pose(math.pi / 2, math.pi / 2,
                                    torch.zeros(3), radius=radius,
                                    device=device)[None],
                       fov_to_intrinsics(fov, device))


def pseudo_batch(G, params, z, yaw_noise, pitch_noise, *, yaw_std=0.65,
                 pitch_std=0.3, radius=2.7, fov=18.837, truncation_psi=0.7):
    """One rendered batch from unit-normal draws: z [B, z_dim], yaw and
    pitch noise [B]. Returns (images [B, 3, R, R] in about [-1, 1], cam2world
    [B, 4, 4], ws [B, num_ws, w_dim])."""
    dev = z.device
    yaw = math.pi / 2 + yaw_noise * yaw_std
    pitch = torch.clamp(math.pi / 2 + pitch_noise * pitch_std, 1e-5,
                        math.pi - 1e-5)
    cams = look_at_pose(yaw, pitch, torch.zeros(3), radius=radius,
                        device=dev)
    c = pack_camera(cams, fov_to_intrinsics(fov, dev))
    cond = canonical_condition(radius, fov, dev).expand(z.shape[0], 25)
    ws = G.mapping(params, z, cond, truncation_psi=truncation_psi,
                   truncation_cutoff=14)
    img = G.synthesis(params, ws, c, det=True)["image"]
    return img, cams, ws


def unit_draws(generator, batch, z_dim):
    """(z [B, z_dim], yaw noise [B], pitch noise [B]), unit normals from
    ``generator`` (a CPU torch.Generator)."""
    return (torch.randn((batch, z_dim), generator=generator),
            torch.randn((batch,), generator=generator),
            torch.randn((batch,), generator=generator))


@torch.no_grad()
def gen_pseudo_dataset(G, params, outdir, *, num_images=1000, batch=8,
                       generator=None, draws=None, yaw_std=0.65,
                       pitch_std=0.3, radius=2.7, fov=18.837,
                       truncation_psi=0.7):
    """Render (image, extrinsic) pairs; writes pngs + pseudo_cam_gt.txt.

    The draws of batch ``b`` come from ``draws(b)`` -> (z, yaw noise,
    pitch noise) when given, else from ``generator`` (a CPU
    torch.Generator, seed 0 when absent). Returns the count written."""
    from tgi_torch.utils.image import save_image
    os.makedirs(outdir, exist_ok=True)
    dev = next(_leaves(params)).device
    generator = generator or torch.Generator().manual_seed(0)
    lines = []
    idx = 0
    for b in range((num_images + batch - 1) // batch):
        d = draws(b) if draws is not None else unit_draws(
            generator, batch, G.cfg.z_dim)
        imgs, cams, _ = pseudo_batch(
            G, params, *(t.to(dev) for t in d), yaw_std=yaw_std,
            pitch_std=pitch_std, radius=radius, fov=fov,
            truncation_psi=truncation_psi)
        imgs, cams = imgs.float().cpu().numpy(), cams.cpu().numpy()
        for i in range(min(batch, num_images - idx)):
            fname = f"{idx:06d}.png"
            save_image(os.path.join(outdir, fname), imgs[i])
            lines.append(fname + " " +
                         " ".join(f"{v:.8f}" for v in cams[i].reshape(-1)))
            idx += 1
    with open(os.path.join(outdir, "pseudo_cam_gt.txt"), "w") as f:
        f.write("\n".join(lines))
    return idx


def geodesic_rotation_loss(r1, r2, eps=1e-7):
    """arccos((tr(R1 R2ᵀ) - 1)/2) (train_pose_estimator.py:241-254)."""
    m = torch.einsum("bij,bkj->bik", r1, r2)
    tr = m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]
    cos = torch.clamp((tr - 1) / 2, -1 + eps, 1 - eps)
    return torch.arccos(cos).mean()


def head_to_rotmat(pred, mode):
    if mode == "quat":
        return quaternion_to_rotmat(pred)
    if mode == "6d":
        return rot6d_to_rotmat(pred)
    return euler_to_rotmat(math.pi / 2 + pred[:, 0], math.pi / 2 + pred[:, 1])


def pose_loss(params, images, gt_ext, mode):
    """Geodesic rot + 10x translation MSE + anti-diagonal reg
    (train_pose_estimator.py:132-141)."""
    pred = resnet34_apply(params, images)
    pred_rot = head_to_rotmat(pred, mode)
    gt_rot = gt_ext[:, :3, :3]
    gt_trans = gt_ext[:, :3, 3]
    pred_trans = -2.7 * pred_rot[:, :3, 2]
    loss_rot = geodesic_rotation_loss(pred_rot, gt_rot)
    loss_trans = torch.mean(torch.square(pred_trans - gt_trans)) * 10
    anti_diag = (torch.abs(pred_rot[:, 0, 2]) + torch.abs(pred_rot[:, 2, 0])
                 ).mean() * 1e-10
    return loss_rot + loss_trans + anti_diag, {"rot": loss_rot,
                                               "trans": loss_trans}


def trainable(tree):
    """A copy of ``tree`` whose leaves are float32 tensors that require
    grad (the caller's tree is left as it is)."""
    return _map(lambda t: t.detach().float().clone().requires_grad_(True),
                tree)


def adam(tree, lr):
    """``optax.adam(lr)`` over every leaf of a :func:`trainable` tree."""
    return torch.optim.Adam(list(_leaves(tree)), lr=lr, **ADAM)


def adam_step(opt, loss):
    """One update: zero the gradients, backward, step. A leaf the loss
    does not reach steps with a zero gradient, as optax's does."""
    opt.zero_grad(set_to_none=False)
    loss.backward()
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    opt.step()


def train_pose_estimator(pose_params, dataset, *, mode="quat", lr=1e-4,
                         batch=32, steps=10_000, val_every=1000,
                         ckpt_dir=None):
    """dataset: (images [N,3,H,W] float 0..255, extrinsics [N,4,4]), numpy
    arrays or tensors; each minibatch moves to the pose net's device.

    Returns (best_params, history): the params of the lowest validation
    loss (detached copies) and one {"step", "train", "val"} per
    validation. With ``ckpt_dir`` the best params are also written there
    as ``pose_best.pt``."""
    images, exts = ((a if isinstance(a, torch.Tensor)
                     else torch.from_numpy(np.asarray(a))).float()
                    for a in dataset)
    dev = next(_leaves(pose_params)).device
    n = images.shape[0]
    # Val split: ~10% (>= one batch when the dataset affords it), never
    # starving the train split on tiny datasets.
    n_val = min(max(batch, n // 10), n // 2)
    train_idx, val_idx = np.arange(n_val, n), np.arange(n_val)
    params = trainable(pose_params)
    opt = adam(params, lr)

    def detached():
        return _map(lambda t: t.detach().clone(), params)

    best = (np.inf, detached())
    history = []
    rng = np.random.RandomState(0)
    for step in range(steps):
        idx = torch.from_numpy(rng.choice(train_idx, batch))
        loss, _ = pose_loss(params, images[idx].to(dev), exts[idx].to(dev),
                            mode)
        adam_step(opt, loss)
        if (step + 1) % val_every == 0 or step == steps - 1:
            vidx = torch.from_numpy(val_idx[:batch])
            with torch.no_grad():
                vloss, _ = pose_loss(params, images[vidx].to(dev),
                                     exts[vidx].to(dev), mode)
            history.append({"step": step + 1, "train": float(loss.detach()),
                            "val": float(vloss)})
            if float(vloss) < best[0]:
                best = (float(vloss), detached())
                if ckpt_dir:
                    from tgi_torch.io.checkpoints import save_checkpoint
                    save_checkpoint(os.path.join(ckpt_dir, "pose_best.pt"),
                                    best[1],
                                    metadata={"val_loss": float(vloss)})
    return best[1], history


def load_pseudo_dataset(directory, size=256, limit=None):
    """Parse pseudo_cam_gt.txt + images back into numpy arrays (images in
    0..255)."""
    from tgi_torch.utils.image import load_image
    with open(os.path.join(directory, "pseudo_cam_gt.txt")) as f:
        lines = f.read()
    imgs, exts = [], []
    for line in lines.strip().split("\n")[:limit]:
        parts = line.split()
        img = load_image(os.path.join(directory, parts[0]), size=size,
                         to_range=(0, 255))
        imgs.append(img[0])
        exts.append(np.asarray([float(v) for v in parts[1:17]],
                               np.float32).reshape(4, 4))
    return np.stack(imgs), np.stack(exts)

