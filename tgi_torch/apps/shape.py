"""3D shape extraction from the generator's density field (twin of
``tgi/apps/shape.py``; parity target single_id_coach.py:120-163 and
gen_samples.py's shape export).

sigma is evaluated on a voxel grid in chunks of points, each chunk one
``run_model`` call on the planes' device (one tri-plane gather on the
card), then marching tetrahedra gives a .ply and the grid an .mrc.
``tgi`` maps one compiled function over the chunks; here a Python loop
does, and each chunk's points are made on the device from the grid's
axis, the same float32 values as ``tgi``'s host grid.
"""

from __future__ import annotations

import numpy as np
import torch

from tgi_torch.ops.grid_sample import channels_last
from tgi_torch.render.renderer import run_model
from tgi_torch.utils.marching import marching_tetrahedra, save_mrc, save_ply


def _axis(G, resolution, shape_scale):
    """The grid's axis: ``resolution`` points across box_warp *
    shape_scale (the reference samples the whole rendering box)."""
    side = G.cfg.rendering_kwargs["box_warp"] * (shape_scale or 1.0)
    half = side / 2
    return np.linspace(-half, half, resolution, dtype=np.float32)


@torch.no_grad()
def sigma_grid(G, params, ws, resolution: int = 512, chunk: int = 1 << 20,
               shape_scale: float | None = None, planes=None):
    """sigma on a resolution³ grid (x slowest, z fastest). Returns
    [R, R, R] numpy float32.

    The points go in chunks of ``chunk`` (at most the grid's size); the
    last chunk is padded with points at the origin, whose sigma is
    dropped, as in ``tgi``. ``planes`` skips the backbone."""
    rk = G.cfg.rendering_kwargs
    if planes is None:
        planes = G.backbone_planes(params, ws)
    # One copy into the kernel's layout serves every chunk.
    planes = channels_last(planes.float())
    dev = planes.device
    lin = torch.from_numpy(_axis(G, resolution, shape_scale)).to(dev)
    n = resolution ** 3
    chunk = min(chunk, n)
    num_chunks = -(-n // chunk)
    sigmas = torch.empty(num_chunks * chunk, dtype=torch.float32, device=dev)
    for c in range(num_chunks):
        idx = torch.arange(c * chunk, (c + 1) * chunk, device=dev)
        pts = torch.stack([lin[(idx // (resolution * resolution))
                               % resolution],
                           lin[(idx // resolution) % resolution],
                           lin[idx % resolution]], dim=-1)
        pts = torch.where((idx < n)[:, None], pts, torch.zeros_like(pts))
        out = run_model(planes, params["decoder"], pts[None], rk)
        sigmas[c * chunk:(c + 1) * chunk] = out["sigma"][0, :, 0]
    return sigmas[:n].cpu().numpy().reshape(resolution, resolution,
                                            resolution)


@torch.no_grad()
def sigma_cross_section(G, params, ws, *, axis: str = "y",
                        offset: float = 0.0, resolution: int = 256,
                        shape_scale: float | None = None):
    """sigma on an axis-aligned plane, for a look at the density
    (training/crosssection_utils.py:13-24). Returns [R, R] numpy."""
    lin = _axis(G, resolution, shape_scale)
    u, v = np.meshgrid(lin, lin, indexing="ij")
    o = np.full_like(u, offset)
    planes_xyz = {"x": (o, u, v), "y": (u, o, v), "z": (u, v, o)}[axis]
    pts = np.stack(planes_xyz, axis=-1).reshape(1, -1, 3)
    out = G.sample_mixed(params, torch.from_numpy(pts).to(ws.device), ws)
    return out["sigma"].cpu().numpy().reshape(resolution, resolution)


def extract_mesh(G, params, ws, resolution: int = 256, level: float = 10.0,
                 out_ply: str | None = None, out_mrc: str | None = None,
                 **kw):
    """sigma grid -> marching tetrahedra -> optional .ply / .mrc. Returns
    (verts [V, 3], faces [F, 3])."""
    grid = sigma_grid(G, params, ws, resolution=resolution, **kw)
    if out_mrc:
        save_mrc(out_mrc, grid)
    verts, faces = marching_tetrahedra(grid, level=level,
                                       spacing=1.0 / resolution)
    if out_ply:
        save_ply(out_ply, verts, faces)
    return verts, faces
