"""Novel-view orbit videos from inverted or sampled latents (twin of
``tgi/apps/gen_videos.py``; parity target gen_videos.py:74-311,
gen_interp_video: cubic w interpolation over keyframes, a sinusoidal
yaw ±0.35 / pitch ±0.25 orbit, 240 frames).

Frames are rendered in batches of ``batch`` views, each batch one
synthesis call (two tri-plane gathers on the card), with the depth
samples scaled by ``sample_mult``. Videos are written by imageio (mp4
through ffmpeg, or a GIF when mp4 writing fails, as in ``tgi``);
imageio and scipy are imported only where they are used. Seeds draw z
from torch's PRNG, as ``gen_samples`` does, so a seed gives another
latent than in ``tgi``.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from tgi_torch import default_device
from tgi_torch.render.cameras import (fov_to_intrinsics, look_at_pose,
                                      pack_camera)
from tgi_torch.utils.image import to_uint8


def _device(params):
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


def orbit_cameras(num_frames: int, pivot, radius=2.7, fov=18.837,
                  yaw_range=0.35, pitch_range=0.25, device=None):
    """The reference's sinusoidal orbit (gen_videos.py:107-114): packed
    cameras [num_frames, 25] on ``device``."""
    device = device or default_device()
    t = np.arange(num_frames, dtype=np.float32) / num_frames
    yaw = np.pi / 2 + yaw_range * np.sin(2 * np.pi * t)
    pitch = np.pi / 2 - 0.05 + pitch_range * np.cos(2 * np.pi * t)
    cams = look_at_pose(torch.from_numpy(yaw), torch.from_numpy(pitch),
                        torch.as_tensor(pivot, dtype=torch.float32),
                        radius=radius, device=device)
    return pack_camera(cams, fov_to_intrinsics(fov, device=device))


def interp_ws(ws_keyframes: np.ndarray, num_frames: int,
              w_frames_per_key: int = 240) -> np.ndarray:
    """Cubic interpolation over w keyframes (gen_videos.py:86-95):
    [K, num_ws, D] -> [num_frames, num_ws, D] float32."""
    from scipy.interpolate import CubicSpline
    K = ws_keyframes.shape[0]
    if K == 1:
        return np.repeat(ws_keyframes, num_frames, axis=0)
    x = np.arange(-1, K + 2)
    wrapped = np.concatenate([ws_keyframes[-1:], ws_keyframes,
                              ws_keyframes[:2]], axis=0)
    spline = CubicSpline(x, wrapped, axis=0)
    t = np.linspace(0, K - 1, num_frames)
    return spline(t).astype(np.float32)


def export_frame_shape(G, params, w, out_ply, resolution=128, level=10.0):
    """One frame's shape (gen_videos.py:139-177): the sigma grid with the
    reference's border zeroing and axis flip, then a .ply at ``level``
    by marching tetrahedra."""
    from tgi_torch.apps.shape import sigma_grid
    from tgi_torch.utils.marching import marching_tetrahedra, save_ply

    grid = np.flip(sigma_grid(G, params, w, resolution=resolution),
                   0).copy()
    pad = int(30 * resolution / 256)
    pad_top = int(38 * resolution / 256)
    if pad:
        grid[:pad] = 0
        grid[-pad:] = 0
        grid[:, :pad] = 0
        grid[:, :, :pad] = 0
        grid[:, :, -pad:] = 0
    if pad_top:
        grid[:, -pad_top:] = 0
    verts, faces = marching_tetrahedra(grid, level=level,
                                       spacing=1.0 / resolution)
    save_ply(out_ply, verts, faces)
    return out_ply


@torch.no_grad()
def render_orbit(G, params, ws, *, num_frames=240, batch=8, radius=2.7,
                 pivot=(0, 0, 0.2), sample_mult=2, shapes_dir=None,
                 shape_res=128):
    """Render the orbit on the params' device; returns uint8 frames
    [T, H, W, 3].

    ``ws`` is one code [1, num_ws, D] (or [num_ws, D]) held for every
    frame, or K > 1 keyframes interpolated by :func:`interp_ws`. The
    frames go ``batch`` at a time, the last batch padded with the first
    frame's code and camera; ``sample_mult`` scales the depth samples as
    gen_videos.py:288-289 does. ``shapes_dir``: also write
    ``<frame:04d>_shape.ply`` per frame (gen_videos.py:139-177).
    """
    rk = G.cfg.rendering_kwargs
    G = type(G)(G.cfg.with_rendering(
        depth_resolution=int(rk["depth_resolution"] * sample_mult),
        depth_resolution_importance=int(
            rk["depth_resolution_importance"] * sample_mult)))
    dev = _device(params)
    cams = orbit_cameras(num_frames, pivot, radius=radius, device=dev)
    ws = torch.as_tensor(ws, dtype=torch.float32).to(dev)
    if ws.ndim == 2:
        ws = ws[None]
    if ws.shape[0] == 1:
        ws_frames = ws.expand(num_frames, *ws.shape[1:])
    else:
        ws_frames = torch.from_numpy(interp_ws(ws.cpu().numpy(),
                                               num_frames)).to(dev)
    pad = (-num_frames) % batch
    if pad:
        ws_frames = torch.cat([ws_frames,
                               ws_frames[:1].expand(pad, *ws.shape[1:])])
        cams = torch.cat([cams, cams[:1].expand(pad, 25)])
    frames = []
    for i in range(0, num_frames + pad, batch):
        imgs = G.synthesis(params, ws_frames[i:i + batch].contiguous(),
                           cams[i:i + batch], det=True)["image"]
        imgs = imgs.float().cpu().numpy()
        frames.extend(to_uint8(img) for img in imgs)
    if shapes_dir is not None:
        os.makedirs(shapes_dir, exist_ok=True)
        for f in range(num_frames):
            export_frame_shape(
                G, params, ws_frames[f:f + 1],
                os.path.join(shapes_dir, f"{f:04d}_shape.ply"),
                resolution=shape_res)
    return np.stack(frames[:num_frames])


def write_video(path: str, frames: np.ndarray, fps: int = 60):
    """An mp4 through imageio (ffmpeg), or a GIF beside it when mp4
    writing fails. Returns the path written."""
    import imageio
    try:
        imageio.mimwrite(path, list(frames), fps=fps)
        return path
    except Exception:
        gif = path.rsplit(".", 1)[0] + ".gif"
        imageio.mimwrite(gif, list(frames), duration=1000 / fps, loop=0)
        return gif


def gen_interp_video(G, params, ws, out_path, **kw):
    """:func:`render_orbit` then :func:`write_video` (the reference's
    gen_interp_video). Returns the path written."""
    return write_video(out_path, render_orbit(G, params, ws, **kw))


def main(argv=None):
    """Command line (gen_videos.py:221-238): ``python -m
    tgi_torch.apps.gen_videos --network G.pkl --seeds 0-3 --output
    out.mp4``, or ``--ws face_ws.npy`` for an inverted code."""
    import click

    @click.command()
    @click.option("--network", required=True,
                  help="a reference EG3D .pkl (bf16 mixed precision, as "
                       "tgi renders it) or the port's .pt")
    @click.option("--seeds", default=None, help="e.g. 0,1,5-10")
    @click.option("--ws", "ws_path", default=None, help="saved _ws.npy")
    @click.option("--output", required=True)
    @click.option("--frames", default=240)
    @click.option("--sample-mult", default=2)
    @click.option("--trunc", default=0.7)
    @click.option("--shapes/--no-shapes", default=False,
                  help="per-frame .ply export (gen_videos.py:139-177)")
    @click.option("--shape-res", default=128)
    @click.option("--device", default=default_device())
    def cli(network, seeds, ws_path, output, frames, sample_mult, trunc,
            shapes, shape_res, device):
        from tgi_torch.apps.gen_samples import parse_range, seed_z
        from tgi_torch.apps.run_pti import load_any_generator
        G, params = load_any_generator(network, device=device)
        if ws_path:
            ws = torch.from_numpy(np.load(ws_path)).float().to(device)
        else:
            if seeds is None:
                raise click.UsageError("need --seeds or --ws")
            cond = pack_camera(
                look_at_pose(math.pi / 2, math.pi / 2,
                             torch.tensor([0., 0., 0.2]), 2.7,
                             device=device)[None],
                fov_to_intrinsics(18.837, device=device))
            zs = torch.cat([seed_z(s, G.cfg.z_dim, device)
                            for s in parse_range(seeds)])
            with torch.no_grad():
                ws = G.mapping(params, zs, cond.expand(zs.shape[0], 25),
                               truncation_psi=trunc, truncation_cutoff=14)
        out = gen_interp_video(
            G, params, ws, output, num_frames=frames,
            sample_mult=sample_mult,
            shapes_dir=(os.path.splitext(output)[0] + "_shapes"
                        if shapes else None),
            shape_res=shape_res)
        click.echo(f"wrote {out}")

    cli.main(args=argv, standalone_mode=True)


if __name__ == "__main__":
    main()
