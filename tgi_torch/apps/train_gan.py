"""EG3D GAN training (twin of ``tgi/apps/train_gan.py``).

Counterpart of the reference's (unshipped) train.py launcher driving
training/training_loop.py: a dataset folder or zip with camera labels
-> GAN training at EG3D's FFHQ 512 configuration, on one device or
data-parallel over several, one process each:

    train_gan(data="faces/", outdir="run/")              # the function
    python -m tgi_torch.apps.train_gan --data faces/ --outdir run/
    python -m torch.distributed.run --nproc_per_node 4 \
        -m tgi_torch.apps.train_gan --data faces/ --outdir run/ \
        --mesh-data 4

Under ``torch.distributed.run`` each process joins the group it
describes (NCCL, its card ``cuda:LOCAL_RANK``; gloo with ``--device
cpu``) and takes its rows of the batch (``tgi_torch.parallel``); as in
``tgi``, ``--batch`` is the global batch.

The command line needs click (imported inside ``main``); the function
does not.
"""

from __future__ import annotations

import torch

from tgi_torch import default_device


def training_configs(*, batch_size=4, r1_gamma=1.0, img_resolution=512,
                     neural_res=64, sr_module="SuperresolutionHybrid8XDC",
                     gpc_reg_prob=0.5, density_reg=0.25):
    """(G, d_cfg, cfg): the generator (bf16 mixed precision), the dual
    discriminator and the trainer's config that ``tgi``'s launcher builds
    (``tgi/apps/train_gan.py:37-47``)."""
    from tgi_torch.models.generator import (GeneratorConfig,
                                            TriPlaneGenerator,
                                            default_rendering_kwargs)
    from tgi_torch.nn.discriminator import DiscriminatorConfig
    from tgi_torch.train.gan import GANTrainConfig
    rk = default_rendering_kwargs(image_resolution=img_resolution,
                                  superresolution_module=sr_module,
                                  density_reg=density_reg)
    G = TriPlaneGenerator(GeneratorConfig(
        img_resolution=img_resolution, rendering_kwargs=rk,
        neural_rendering_resolution=neural_res, fused_dtype="bfloat16"))
    d_cfg = DiscriminatorConfig(c_dim=25, img_resolution=img_resolution,
                                img_channels=6)
    cfg = GANTrainConfig(batch_size=batch_size, r1_gamma=r1_gamma,
                         gpc_reg_prob=gpc_reg_prob)
    return G, d_cfg, cfg


def train_gan(data, outdir, *, batch_size=4, r1_gamma=1.0,
              total_kimg=25000, img_resolution=512, neural_res=64,
              sr_module="SuperresolutionHybrid8XDC", gpc_reg_prob=0.5,
              density_reg=0.25, resume_ckpt=None, mesh_data=None,
              device=None, **loop_kwargs):
    """Train from ``data`` (a folder or .zip of images with a
    ``dataset.json`` of 25-float camera labels) into ``outdir``; returns
    the train state. ``loop_kwargs`` go to
    ``tgi_torch.train.loop.training_loop`` (``kimg_per_tick``,
    ``snapshot_ticks``, ``augment_p``, ``abort_fn``, ...).

    In a process group (joined here from ``torch.distributed.run``'s
    environment, or by the caller) or with ``mesh_data``, training is
    data-parallel over a ``make_mesh(data=mesh_data)`` of the group's
    ranks, one device each; ``mesh_data`` must then be the world size
    (1 without a group)."""
    from tgi_torch.parallel.mesh import init_from_env, make_mesh
    from tgi_torch.train.loop import training_loop
    G, d_cfg, cfg = training_configs(
        batch_size=batch_size, r1_gamma=r1_gamma,
        img_resolution=img_resolution, neural_res=neural_res,
        sr_module=sr_module, gpc_reg_prob=gpc_reg_prob,
        density_reg=density_reg)
    device, joined = init_from_env(device or default_device())
    try:
        mesh = (make_mesh(data=mesh_data, devices=[device])
                if mesh_data is not None
                or torch.distributed.is_initialized() else None)
        return training_loop(G=G, d_cfg=d_cfg, data_path=data,
                             run_dir=outdir, cfg=cfg, total_kimg=total_kimg,
                             resume_ckpt=resume_ckpt, mesh=mesh,
                             device=device, **loop_kwargs)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def main(argv=None):
    """Command line: ``python -m tgi_torch.apps.train_gan --data DIR
    --outdir DIR``."""
    import click

    @click.command()
    @click.option("--data", required=True, help="dataset dir or zip")
    @click.option("--outdir", required=True)
    @click.option("--batch", "batch_size", default=4)
    @click.option("--gamma", "r1_gamma", default=1.0)
    @click.option("--total-kimg", default=25000)
    @click.option("--img-resolution", default=512)
    @click.option("--neural-res", default=64)
    @click.option("--sr-module", default="SuperresolutionHybrid8XDC")
    @click.option("--gpc-reg-prob", default=0.5)
    @click.option("--density-reg", default=0.25)
    @click.option("--resume", "resume_ckpt", default=None)
    @click.option("--mesh-data", default=None, type=int,
                  help="data-parallel axis size: the number of processes "
                       "torch.distributed.run starts (default: all)")
    @click.option("--device", default=default_device())
    def cli(**kwargs):
        train_gan(**kwargs)

    cli.main(args=argv, standalone_mode=True)


if __name__ == "__main__":
    main()
