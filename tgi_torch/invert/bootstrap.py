"""Self-bootstrapped auxiliary nets for the closed-loop inversion gate
(twin of ``tgi/invert/bootstrap.py``).

The reference pipeline depends on pretrained networks: a ResNet-34 pose
estimator (trained on a pseudo-dataset rendered from the generator
itself, scripts/gen_pseudo_dataset.py + scripts/train_pose_estimator.py),
ImageNet-pretrained VGG-16s for the LPIPS distance and the warping-loss
features (w_projector.py:50-58), and an e4e encoder for the
target-aware starting latent (w_projector.py:99-115). None of those
weights are in the repository. On random stand-ins the gate measures
the stand-ins: a random VGG is pose-uninformative, so the camera
random-walks, and without e4e the start render is the mean face.

The repair is the reference's own recipe, applied to every aux net: the
generator is a labeled-data factory. This module renders a
pseudo-dataset (image, extrinsic, w), kept on the generator's device,
and

  1. trains the pose ResNet on it with the reference protocol
     (geodesic rotation loss + 10x translation MSE,
     ``tgi_torch.apps.pose_pipeline.pose_loss``);
  2. trains the same VGG-16 the warp/LPIPS losses read, with pose +
     latent regression heads on the five LPIPS stages and a dense 1x1
     reconstruction head on layer 15, so its features become pose- and
     identity-informative on the generator's image manifold;
  3. recycles the latent head as the e4e substitute:
     e4e_encode(target) = w_hat(target) - mean_w, so projection starts
     content-close to the target as in the reference.

Every trained parameter is a function of the generator and the seeds.
``tgi`` fuses ``chain`` renders and ``chunk`` training steps per
dispatch (``lax.scan``, a TPU-relay economy); here both are Python
loops, and a trainer runs exactly ``steps`` steps where ``tgi`` rounds
up to whole chunks. Minibatches are drawn with ``torch.randint`` from a
CPU generator, or given per step as ``indices(step)``; ``tgi`` draws
them with ``jax.random``.
"""

from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from tgi_torch.apps.pose_pipeline import (_leaves, _map, adam, adam_step,
                                          geodesic_rotation_loss,
                                          head_to_rotmat, pose_loss,
                                          pseudo_batch, trainable,
                                          unit_draws)
from tgi_torch.losses.warp import area_downsample
from tgi_torch.models.pose_resnet import resnet34_apply, resnet34_calibrate
from tgi_torch.models.vgg import (IMAGENET_MEAN, IMAGENET_STD,
                                  LPIPS_CHANNELS, LPIPS_STAGES,
                                  vgg16_features)
from tgi_torch.render.cameras import quaternion_to_rotmat


@torch.no_grad()
def make_pseudo_dataset(G, params, *, generator=None, draws=None,
                        num_images=512, batch=8, yaw_std=0.65,
                        pitch_std=0.3, radius=2.7, fov=18.837,
                        truncation_psi=0.7):
    """In-memory twin of ``pose_pipeline.gen_pseudo_dataset``
    (scripts/gen_pseudo_dataset.py:105-206) that also keeps each sample's
    w for the latent-regression head.

    The draws of render batch ``b`` come from ``draws(b)`` -> (z [B,
    z_dim], yaw noise [B], pitch noise [B]) when given, else unit normals
    from ``generator`` (a CPU torch.Generator, seed 0 when absent).

    Returns tensors on the generator's device: images_255 [N, 3, S, S]
    (0..255 float, S = min(256, the render's side), images above 256²
    area-shrunk), exts [N, 4, 4], ws [N, w_dim]."""
    dev = next(_leaves(params)).device
    generator = generator or torch.Generator().manual_seed(0)
    imgs, exts, ws = [], [], []
    for b in range((num_images + batch - 1) // batch):
        d = draws(b) if draws is not None else unit_draws(
            generator, batch, G.cfg.z_dim)
        img, cams, w = pseudo_batch(
            G, params, *(t.to(dev) for t in d), yaw_std=yaw_std,
            pitch_std=pitch_std, radius=radius, fov=fov,
            truncation_psi=truncation_psi)
        img = torch.clamp(img.float(), -1.0, 1.0)
        if img.shape[-1] > 256:
            img = area_downsample(img, 256)
        imgs.append((img + 1.0) * 127.5)
        exts.append(cams)
        ws.append(w[:, 0, :].float())
    n = num_images
    return {"images_255": torch.cat(imgs)[:n], "exts": torch.cat(exts)[:n],
            "ws": torch.cat(ws)[:n]}


def _vgg_stage_acts(vgg_params, images_255):
    dev = images_255.device
    mean = torch.tensor(IMAGENET_MEAN, device=dev)[None, :, None, None]
    std = torch.tensor(IMAGENET_STD, device=dev)[None, :, None, None]
    return vgg16_features(vgg_params, (images_255 / 255.0 - mean) / std,
                          outputs=LPIPS_STAGES)


def _vgg_embed(vgg_params, images_255, acts=None):
    """Globally pooled concat of the five LPIPS-stage activations: trains
    every conv the lpips/warp features later read."""
    if acts is None:
        acts = _vgg_stage_acts(vgg_params, images_255)
    return torch.cat([acts[i].mean(dim=(2, 3)) for i in LPIPS_STAGES],
                     dim=-1)                     # [N, sum(stage ch)]


def vgg_head_init(generator, w_dim=512, d=None, c15=256, device="cuda"):
    """The VGG bootstrap's heads, drawn from ``generator`` (a CPU
    torch.Generator) with ``tgi``'s distributions: quaternion and latent
    linears on the pooled embedding, and a 1x1 conv from the layer-15
    map back to RGB."""
    d = d if d is not None else sum(LPIPS_CHANNELS)

    def normal(shape, fan):
        return (torch.randn(shape, generator=generator)
                * (1 / fan) ** 0.5).to(device)

    return {
        "quat": {"weight": normal((d, 4), d),
                 "bias": torch.zeros((4,), device=device)},
        "w": {"weight": normal((d, w_dim), d),
              "bias": torch.zeros((w_dim,), device=device)},
        # Dense head: without it the global-pooled pose/latent objectives
        # are solvable with spatially flat features, and the warp loss,
        # whose pose signal is feature-map alignment, gets no anchor.
        "recon": {"weight": normal((3, c15, 1, 1), c15),
                  "bias": torch.zeros((3,), device=device)},
    }


def _val_split(n, batch):
    """~10% held-out (>= one batch when affordable), never starving the
    train split (``pose_pipeline.train_pose_estimator``'s policy)."""
    return min(max(batch, n // 10), n // 2)


def _dataset_device(dataset):
    """(images as uint8, the reference's own PNG precision; extrinsics),
    on the dataset's device."""
    imgs = torch.clamp(torch.round(dataset["images_255"]), 0, 255).to(
        torch.uint8)
    return imgs, dataset["exts"].float()


def _draw(generator, low, high, batch, device):
    return torch.randint(low, high, (batch,), generator=generator).to(device)


def train_pose_bootstrap(pose_params, dataset, *, mode="quat", lr=1e-4,
                         batch=32, steps=3000, generator=None, indices=None,
                         log=None):
    """Pose-estimator training on the device-resident pseudo-dataset.

    Loss and semantics of ``pose_pipeline.train_pose_estimator``
    (scripts/train_pose_estimator.py), with ``tgi``'s bootstrap
    differences: images kept as uint8, minibatches drawn uniformly from
    the train split (from ``generator``, a CPU torch.Generator, or
    ``indices(step)``), and the final params returned instead of the
    best-validation ones.

    Returns (params, {"val_loss", "val_rot_deg", "losses": one float per
    step})."""
    generator = generator or torch.Generator().manual_seed(0)
    images, exts = _dataset_device(dataset)
    dev = images.device
    n = images.shape[0]
    batch = min(batch, max(1, n // 2))
    n_val = _val_split(n, batch)
    params = trainable(pose_params)
    opt = adam(params, lr)
    losses = []
    for step in range(steps):
        idx = (indices(step).to(dev) if indices is not None
               else _draw(generator, n_val, n, batch, dev))
        loss, _ = pose_loss(params, images[idx].float(), exts[idx], mode)
        adam_step(opt, loss)
        losses.append(loss.detach())
        if log and (step % 250 == 0 or step == steps - 1):
            log(f"pose step {step + 1}: loss {float(loss.detach()):.4f}")
    params = _map(lambda t: t.detach(), params)
    with torch.no_grad():
        im = images[:n_val].float()
        vloss, _ = pose_loss(params, im, exts[:n_val], mode)
        rot = head_to_rotmat(resnet34_apply(params, im), mode)
        tr = torch.einsum("nij,nij->n", rot, exts[:n_val, :3, :3])
        deg = torch.rad2deg(torch.arccos(torch.clamp((tr - 1) / 2, -1, 1)))
    return params, {"val_loss": float(vloss),
                    "val_rot_deg": float(deg.mean()),
                    "losses": torch.stack(losses).tolist() if losses
                    else []}


def vgg_bootstrap_loss(tr, imgs, ext, w_t):
    """(loss, {"rot", "w", "rec"}) of the VGG bootstrap for a minibatch:
    ``tr`` = {"vgg", "heads"}, imgs [B, 3, S, S] in 0..255, ext [B, 4, 4],
    w_t [B, w_dim] normalized latents."""
    acts = _vgg_stage_acts(tr["vgg"], imgs)
    emb = _vgg_embed(tr["vgg"], None, acts=acts)
    heads = tr["heads"]
    q = emb @ heads["quat"]["weight"] + heads["quat"]["bias"]
    l_rot = geodesic_rotation_loss(quaternion_to_rotmat(q), ext[:, :3, :3])
    w_hat = emb @ heads["w"]["weight"] + heads["w"]["bias"]
    l_w = torch.mean(torch.square(w_hat - w_t))
    # Dense spatial anchor: reconstruct the (shrunk) image from the
    # layer-15 map by a 1x1 conv, so per-position features encode local
    # appearance, which the warp loss aligns.
    f15 = acts[15]
    rec = F.conv2d(f15, heads["recon"]["weight"], heads["recon"]["bias"])
    tgt = area_downsample(imgs / 127.5 - 1.0, f15.shape[-1])
    l_rec = torch.mean(torch.square(rec - tgt))
    return l_rot + l_w + l_rec, {"rot": l_rot, "w": l_w, "rec": l_rec}


def train_vgg_bootstrap(vgg_params, dataset, *, steps=800, batch=16,
                        lr=1e-4, generator=None, indices=None,
                        log_every=200, log=None):
    """Training of the projection VGG with pose (geodesic) + latent (MSE)
    regression heads and the dense reconstruction head on the
    pseudo-dataset (:func:`vgg_bootstrap_loss`). The heads are drawn from
    ``generator`` (a CPU torch.Generator), and so are the minibatches
    unless ``indices(step)`` gives them.

    Returns {"vgg", "heads", "w_mu", "w_sd", "losses": one float per
    step}."""
    generator = generator or torch.Generator().manual_seed(0)
    images, exts = _dataset_device(dataset)
    dev = images.device
    ws = dataset["ws"].float()
    w_mu = ws.mean(dim=0, keepdim=True)
    w_sd = ws.std(unbiased=False) + 1e-8
    ws_n = (ws - w_mu) / w_sd
    n = images.shape[0]
    batch = min(batch, n)
    with torch.no_grad():
        acts0 = _vgg_stage_acts(vgg_params, images[:1].float())
        d = _vgg_embed(vgg_params, None, acts=acts0).shape[-1]
    heads = vgg_head_init(generator, w_dim=ws.shape[-1], d=d,
                          c15=acts0[15].shape[1], device=dev)
    tr = trainable({"vgg": vgg_params, "heads": heads})
    opt = adam(tr, lr)
    losses = []
    for step in range(steps):
        idx = (indices(step).to(dev) if indices is not None
               else _draw(generator, 0, n, batch, dev))
        loss, aux = vgg_bootstrap_loss(tr, images[idx].float(), exts[idx],
                                       ws_n[idx])
        adam_step(opt, loss)
        losses.append(loss.detach())
        if log and (step % log_every == 0 or step == steps - 1):
            parts = {k: float(v.detach()) for k, v in aux.items()}
            log(f"vgg_bootstrap step {step + 1}: loss "
                f"{float(loss.detach()):.4f} rot {parts['rot']:.4f} "
                f"w {parts['w']:.4f} rec {parts['rec']:.4f}")
    tr = _map(lambda t: t.detach(), tr)
    return {"vgg": tr["vgg"], "heads": tr["heads"], "w_mu": w_mu,
            "w_sd": w_sd,
            "losses": torch.stack(losses).tolist() if losses else []}


def make_e4e_encode(vgg_params, heads, w_mu, w_sd):
    """The e4e substitute from the trained latent head.

    The projector adds the encoder output to its own mean w
    (w_projector.py:99-115: start_w = mean_w + e4e(target)), so the
    head's prediction is returned as a delta against the pseudo-dataset's
    w mean, which estimates the same truncated mapping mean."""
    def e4e_encode(target_255):
        with torch.no_grad():
            emb = _vgg_embed(vgg_params, target_255)
            w_hat_n = emb @ heads["w"]["weight"] + heads["w"]["bias"]
        # predicted w = w_hat_n * w_sd + w_mu; its delta on the mean is
        # the unnormalized head output (w_mu cancels).
        return w_hat_n * w_sd
    return e4e_encode


def bootstrap_aux_nets(G, params, *, seed=0, pose_params, vgg_params,
                       num_images=1024, pose_steps=2000, vgg_steps=800,
                       pose_batch=32, vgg_batch=16, pose_mode="quat",
                       log=None):
    """Pseudo-dataset + pose/VGG training + e4e substitute.

    Draws: the dataset's from a CPU generator seeded ``seed``, the pose
    trainer's from ``seed + 1``, the VGG trainer's from ``seed + 2``.
    The caller's nets are not changed.

    Returns (pose_params, vgg_params, e4e_encode, report): the report has
    each part's seconds, the pose net's validation loss and mean rotation
    error in degrees, and both trainers' per-step losses."""
    def sync():
        if next(_leaves(params)).device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    ds = make_pseudo_dataset(G, params,
                             generator=torch.Generator().manual_seed(seed),
                             num_images=num_images)
    sync()
    t_ds = time.perf_counter()
    if log:
        log(f"pseudo dataset: {num_images} images in {t_ds - t0:.1f}s")

    # A random-init ResNet-34 has identity BN statistics: activation
    # variance compounds through 34 layers, the tanh head saturates for
    # every input and training is a no-op. Calibrate the statistics on
    # real data first, as a pretrained net's would be.
    with torch.no_grad():
        pose_params = resnet34_calibrate(pose_params,
                                         ds["images_255"][:pose_batch])
    pose_trained, pose_val = train_pose_bootstrap(
        pose_params, ds, mode=pose_mode, batch=pose_batch, steps=pose_steps,
        generator=torch.Generator().manual_seed(seed + 1), log=log)
    sync()
    t_pose = time.perf_counter()
    if log:
        log(f"pose estimator: {pose_steps} steps in {t_pose - t_ds:.1f}s "
            f"(val loss {pose_val['val_loss']:.4f}, "
            f"val rot {pose_val['val_rot_deg']:.2f} deg)")

    vt = train_vgg_bootstrap(
        vgg_params, ds, steps=vgg_steps, batch=vgg_batch,
        generator=torch.Generator().manual_seed(seed + 2), log=log)
    sync()
    t_vgg = time.perf_counter()
    if log:
        log(f"vgg bootstrap: {vgg_steps} steps in {t_vgg - t_pose:.1f}s")

    e4e_encode = make_e4e_encode(vt["vgg"], vt["heads"], vt["w_mu"],
                                 vt["w_sd"])
    report = {
        "dataset_s": t_ds - t0,
        "pose_train_s": t_pose - t_ds,
        "vgg_train_s": t_vgg - t_pose,
        "pose_val_loss": pose_val["val_loss"],
        "pose_val_rot_deg": pose_val["val_rot_deg"],
        "pose_losses": pose_val["losses"],
        "vgg_losses": vt["losses"],
    }
    return pose_trained, vt["vgg"], e4e_encode, report
