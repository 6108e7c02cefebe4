"""GANSpace: PCA directions in w space and semantic edits (twin of
``tgi/apps/ganspace.py``).

Parity targets: ganspace/pca_anlaysis.py:10-33 (1e5 w samples under a
fixed front camera -> PCA -> saved components) and
ganspace/run_ganspace.py:22-79 (w + V·control over chosen layers ->
synthesis grid; the curated directions). The PCA accumulates the first
and second moments of w in float32, batch by batch on the device, and
takes one ``eigh`` of the covariance, as ``tgi`` does. z is drawn from
a ``torch.Generator`` or given batch by batch (the tests hand it
``tgi``'s draws).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from tgi_torch import default_device
from tgi_torch.render.cameras import (fov_to_intrinsics, look_at_pose,
                                      pack_camera)

# Curated directions (run_ganspace.py:71-79, verbatim values):
# (idx_comp, start_layer, layer_num, edit_power). The component indices
# index the shipped precomputed bases (ganspace/pca_comp/*.npy, rows =
# unit-norm PCs): load them with :func:`load_components`; against a
# self-computed PCA they mean nothing.
DIRECTIONS = {
    "bright hair": dict(comp=2, layers=(7, 14), strength=4),
    "smile": dict(comp=12, layers=(0, 5), strength=2),
    "age": dict(comp=5, layers=(0, 5), strength=3.5),      # negative: young
    "short hair": dict(comp=2, layers=(0, 5), strength=4),  # negative
    "glass": dict(comp=4, layers=(0, 5), strength=4),       # negative
    "gender": dict(comp=0, layers=(0, 5), strength=4),      # neg: f -> m
}


def load_components(path, w_dim=512):
    """A precomputed PCA basis (ganspace/pca_comp/*.npy): [K, w_dim]
    float32, rows unit-norm principal components by decreasing variance,
    the layout :func:`compute_pca` returns and :func:`edit_ws` reads
    (run_ganspace.py:66 loads it, :28 takes column ``idx_comp`` of its
    transpose, i.e. row ``idx_comp`` here). A transposed or truncated
    basis raises ValueError."""
    comps = np.load(path)
    if comps.ndim != 2 or comps.shape[1] != w_dim:
        raise ValueError(f"PCA components {path}: expected [K, {w_dim}], "
                         f"got {comps.shape}")
    norms = np.linalg.norm(comps, axis=1)
    if not np.allclose(norms, 1.0, atol=1e-3):
        raise ValueError(
            f"PCA components {path}: rows are not unit-norm "
            f"(min {norms.min():.4f}, max {norms.max():.4f}) — "
            "transposed basis?")
    return np.asarray(comps, np.float32)


def front_camera(pivot=(0, 0, 0.2), radius=2.7, fov=18.837, device=None):
    """The canonical front camera [1, 25]."""
    device = device or default_device()
    return pack_camera(
        look_at_pose(math.pi / 2, math.pi / 2,
                     torch.as_tensor(pivot, dtype=torch.float32),
                     radius=radius, device=device)[None],
        fov_to_intrinsics(fov, device=device))


@torch.no_grad()
def compute_pca(G, params, *, num_samples=100_000, batch=4096,
                generator=None, z_batches=None, pivot=(0, 0, 0.2),
                radius=2.7, fov=18.837):
    """PCA of mapped w under the canonical front camera, on the params'
    device.

    ``ceil(num_samples / batch)`` batches of ``batch`` z are drawn from
    ``generator`` (a torch.Generator on that device), or taken from
    ``z_batches`` (a sequence of [batch, z_dim] tensors); every drawn
    sample counts. Returns numpy (components [D, D], rows PCs by
    decreasing variance; stdevs [D]; mean [D]).
    """
    leaf = params["mapping"]["w_avg"]
    dev = leaf.device
    cam = front_camera(pivot, radius, fov, device=dev)
    n_batches = (num_samples + batch - 1) // batch
    moments1 = torch.zeros(G.cfg.w_dim, device=dev)
    moments2 = torch.zeros(G.cfg.w_dim, G.cfg.w_dim, device=dev)
    n = 0
    for i in range(n_batches):
        if z_batches is not None:
            z = torch.as_tensor(z_batches[i], dtype=torch.float32).to(dev)
        else:
            z = torch.randn((batch, G.cfg.z_dim), generator=generator,
                            device=dev)
        w = G.mapping(params, z, cam.expand(z.shape[0], 25))[:, 0, :]
        moments1 = moments1 + w.sum(0)
        moments2 = moments2 + w.T @ w
        n += w.shape[0]
    mean = moments1 / n
    cov = moments2 / n - torch.outer(mean, mean)
    eigvals, eigvecs = torch.linalg.eigh(cov)
    order = torch.argsort(-eigvals)
    comps = eigvecs[:, order].T
    stdev = torch.sqrt(torch.clamp(eigvals[order], min=0))
    return (comps.cpu().numpy(), stdev.cpu().numpy(), mean.cpu().numpy())


def edit_ws(ws, components, comp_idx, strength, layers):
    """``ws`` [N, num_ws, D] with ``strength`` times PC ``comp_idx`` added
    on the layers [lo, hi) (run_ganspace.py:22-58); a new tensor."""
    lo, hi = layers
    ws = torch.as_tensor(ws)
    direction = torch.tensor(np.asarray(components[comp_idx]),
                             dtype=ws.dtype, device=ws.device)
    edited = ws.clone()
    edited[:, lo:hi, :] += strength * direction
    return edited


@torch.no_grad()
def edit_sweep(G, params, ws, camera, components, *, comp_idx,
               layers=(0, 12), edit_power=1.0, num_imgs=5, outdir=None,
               name="sweep"):
    """``num_imgs`` edits, the control swept linearly from
    ``-edit_power`` to ``+edit_power`` (run_ganspace.py:30-52's grid).

    Returns (images [num_imgs, 3, H, W], directions [num_imgs, num_ws,
    w_dim] numpy: each image's additive direction, as the reference
    returns). With ``outdir``, the grid is written to
    ``<outdir>/<name>_grid.png``.
    """
    powers = (np.linspace(-edit_power, edit_power, num_imgs)
              if num_imgs > 1 else np.asarray([edit_power]))
    imgs, dirs = [], []
    for p in powers:
        edited = edit_ws(ws, components, comp_idx, float(p), layers)
        imgs.append(G.synthesis(params, edited, camera, det=True)["image"][0])
        dirs.append((edited - ws)[0].cpu().numpy())
    imgs = torch.stack(imgs)
    if outdir:
        from tgi_torch.utils.image import save_image_grid
        os.makedirs(outdir, exist_ok=True)
        save_image_grid(os.path.join(outdir, f"{name}_grid.png"), imgs)
    return imgs, np.stack(dirs)


@torch.no_grad()
def edit_and_render(G, params, ws, camera, components, *, direction=None,
                    comp_idx=None, strength=0.0, layers=(0, 14),
                    outdir=None, name="edit"):
    """The original and the edited render; returns (orig, edited)
    images. ``direction`` names one of :data:`DIRECTIONS` (its
    component, layers and, unless ``strength`` is given, strength). With
    ``outdir``, both are written side by side to ``<outdir>/<name>.png``.
    """
    if direction is not None:
        spec = DIRECTIONS[direction]
        comp_idx, layers = spec["comp"], spec["layers"]
        strength = strength or spec["strength"]
    edited_ws = edit_ws(ws, components, comp_idx, strength, layers)
    orig = G.synthesis(params, ws, camera, det=True)["image"]
    edit = G.synthesis(params, edited_ws, camera, det=True)["image"]
    if outdir:
        from tgi_torch.utils.image import save_image_grid
        os.makedirs(outdir, exist_ok=True)
        save_image_grid(os.path.join(outdir, f"{name}.png"),
                        torch.cat([orig, edit]))
    return orig, edit
