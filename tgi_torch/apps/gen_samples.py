"""Sample images from a generator (twin of ``tgi/apps/gen_samples.py``;
parity target gen_samples.py: seeds -> images at yaw/pitch offsets).

The command line reads the generator from ``--network`` — a reference
EG3D ``.pkl``, rendered in bf16 mixed precision as ``tgi`` renders it,
or the port's ``.pt`` — or, without it, draws full-width weights from
``--weights-seed``. ``--shapes`` also writes each seed's mesh
(``seed{seed:04d}.ply``, ``apps/shape.py`` at ``--shape-res``).
``click`` and ``PIL`` are imported only by the command line and by PNG
writing.
"""

from __future__ import annotations

import math
import os

import torch

from tgi_torch import default_device
from tgi_torch.render.cameras import (fov_to_intrinsics, look_at_pose,
                                      pack_camera)
from tgi_torch.utils.image import save_image


def parse_range(s: str) -> list[int]:
    """'0,1,5-7' -> [0, 1, 5, 6, 7]."""
    out = []
    for part in str(s).split(","):
        if "-" in part:
            a, b = part.split("-")
            out.extend(range(int(a), int(b) + 1))
        else:
            out.append(int(part))
    return out


def seed_z(seed: int, z_dim: int, device) -> torch.Tensor:
    """Latent [1, z_dim] from a seeded CPU generator (so the same on every
    device)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((1, z_dim), generator=g).to(device)


@torch.no_grad()
def generate_samples(G, params, seeds, *, outdir=None, truncation_psi=0.7,
                     truncation_cutoff=14, angles=((0.0, 0.0),), fov=18.837,
                     radius=2.7, pivot=(0, 0, 0.2), shapes=False,
                     shape_res=256, device=None):
    """Render each seed at each (yaw_offset, pitch_offset) angle.

    Returns one dict per (seed, angle): ``seed``, ``angle``, the
    ``image`` / ``image_raw`` / ``image_depth`` tensors, and ``path``,
    the PNG written under ``outdir`` (None when ``outdir`` is None).
    ``shapes`` also extracts each seed's mesh at ``shape_res``³ and
    writes it to ``outdir/seed{seed:04d}.ply``.
    """
    if shapes and outdir is None:
        raise ValueError("shapes=True writes meshes: it needs an outdir")
    device = device or default_device()
    if outdir is not None:
        os.makedirs(outdir, exist_ok=True)
    pivot = torch.tensor(pivot, dtype=torch.float32, device=device)
    intr = fov_to_intrinsics(fov, device=device)
    cond_cam = pack_camera(look_at_pose(math.pi / 2, math.pi / 2, pivot,
                                        radius=radius, device=device)[None],
                           intr)
    results = []
    for seed in seeds:
        z = seed_z(seed, G.cfg.z_dim, device)
        ws = G.mapping(params, z, cond_cam, truncation_psi=truncation_psi,
                       truncation_cutoff=truncation_cutoff)
        for ai, (dy, dp) in enumerate(angles):
            cam = look_at_pose(math.pi / 2 + dy, math.pi / 2 + dp, pivot,
                               radius=radius, device=device)
            out = G.synthesis(params, ws, pack_camera(cam[None], intr),
                              det=True)
            path = None
            if outdir is not None:
                path = os.path.join(outdir, f"seed{seed:04d}_a{ai}.png")
                save_image(path, out["image"])
            results.append({"seed": seed, "angle": (dy, dp), "path": path,
                            **{k: out[k] for k in
                               ("image", "image_raw", "image_depth")}})
        if shapes:
            from tgi_torch.apps.shape import extract_mesh
            extract_mesh(G, params, ws, resolution=shape_res,
                         out_ply=os.path.join(outdir, f"seed{seed:04d}.ply"))
    return results


def main(argv=None):
    """Command line: ``python -m tgi_torch.apps.gen_samples --network
    G.pkl --outdir DIR``."""
    import click

    from tgi_torch.models.generator import GeneratorConfig, TriPlaneGenerator

    @click.command()
    @click.option("--network", default=None,
                  help="a reference EG3D .pkl (rendered in bf16 mixed "
                       "precision, as tgi does) or the port's .pt; "
                       "without it, random weights")
    @click.option("--seeds", default="0-3", help="e.g. 0,1,5-10")
    @click.option("--outdir", required=True)
    @click.option("--trunc", "truncation_psi", default=0.7)
    @click.option("--weights-seed", default=0,
                  help="seed of the random weights (without --network)")
    @click.option("--render-res", default=128,
                  help="neural rendering resolution of the random weights "
                       "(a --network keeps its own)")
    @click.option("--shapes", is_flag=True,
                  help="also write each seed's mesh, seed{seed:04d}.ply")
    @click.option("--shape-res", default=256)
    @click.option("--device", default=default_device())
    def cli(network, seeds, outdir, truncation_psi, weights_seed, render_res,
            shapes, shape_res, device):
        if network:
            from tgi_torch.apps.run_pti import load_any_generator
            G, params = load_any_generator(network, device=device)
        else:
            G = TriPlaneGenerator(GeneratorConfig(
                neural_rendering_resolution=render_res))
            params = G.init(torch.Generator().manual_seed(weights_seed),
                            device=device)
        for r in generate_samples(G, params, parse_range(seeds),
                                  outdir=outdir,
                                  truncation_psi=truncation_psi,
                                  angles=((0.35, 0), (0, 0), (-0.35, 0)),
                                  shapes=shapes, shape_res=shape_res,
                                  device=device):
            print(r["path"])

    cli.main(args=argv, standalone_mode=True)


if __name__ == "__main__":
    main()
