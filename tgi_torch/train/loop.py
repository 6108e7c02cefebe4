"""EG3D GAN training loop (twin of ``tgi/train/loop.py``).

Behavioral parity target: training/training_loop.py:95-464 — infinite
data, lazy-regularization phase cadence, EMA, ADA adjustment, tick
logging (stdout + stats.jsonl), image/checkpoint snapshots, in-loop
metric hooks, cooperative abort.

One process per device. With a data-parallel ``mesh``
(``tgi_torch.parallel.make_mesh`` inside a process group, as ``tgi``'s
``mesh``) every rank reads the same global batch and steps on its rows
(``shard_batch``), the weights start from rank 0's (``replicate``), and
only rank 0 writes ``stats.jsonl``, checkpoints and image grids; the
abort is rank 0's. Checkpoints are the port's single files
(``io/checkpoints.py``) and hold the whole train state (G, D, the EMA
and both Adams' moments), so a resume restores it bit for bit. By
default each snapshot is its own file, named as ``tgi`` names them,
``network-XXXXXX.ckpt``; ``checkpoint_backend="orbax"`` keeps them as
``tgi``'s orbax backend does (``io/orbax_io.py``, the port's format).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from tgi_torch.io.orbax_io import make_manager, restore_latest, save_step
from tgi_torch.parallel.collectives import rank0_flag
from tgi_torch.parallel.mesh import replicate, shard_batch
from tgi_torch.train.augment import AdaptiveAugment, AugmentPipe
from tgi_torch.train.dataset import ImageFolderDataset, infinite_batches
from tgi_torch.train.gan import (GANTrainConfig, GANTrainer,
                                 init_train_state, load_train_state,
                                 train_state_tree)
from tgi_torch.utils.stats import Collector, JsonlLogger


def training_loop(
    *,
    G,                       # TriPlaneGenerator (config object)
    d_cfg,                   # DiscriminatorConfig
    data_path: str,
    run_dir: str,
    cfg: GANTrainConfig = GANTrainConfig(),
    total_kimg: float = 25000,
    kimg_per_tick: float = 4,
    snapshot_ticks: int = 50,
    image_snapshot_ticks: int = 50,
    ada_target: float | None = 0.6,
    augment_p: float = 0.0,
    mesh=None,
    resume_ckpt: str | None = None,
    seed: int = 0,
    metric_fns: dict | None = None,
    abort_fn=None,
    tensorboard: bool = False,
    checkpoint_backend: str = "torch",   # 'torch' | 'orbax'
    snapshot_keep: int = 5,
    device="cuda",
):
    """GAN training loop (reference training_loop.py:93-430); returns the
    train state.

    ``augment_p`` is the reference's initial augmentation probability
    (``tgi`` starts at 0); the pipe runs where it or ``ada_target`` is
    set, and ADA adjusts p from ``ada_target``. Weights are drawn from a
    CPU generator seeded by ``seed``; latents and every draw of the step
    from a generator on ``device`` seeded the same. ``mesh``: a
    ``tgi_torch.parallel`` mesh whose data axis splits the batch over the
    process group's ranks (``device`` is this rank's).

    ``checkpoint_backend="orbax"`` writes the periodic snapshots as
    versioned step directories under ``run_dir/snapshots``, the newest
    ``snapshot_keep`` kept, each saved in the background
    (``io/orbax_io.py``); ``resume_ckpt`` then names such a directory,
    and its newest step is restored with its ``cur_nimg`` (an empty
    one starts the run afresh). Every rank restores; rank 0 writes.
    """
    if checkpoint_backend not in ("torch", "orbax"):
        raise ValueError(f"checkpoint_backend={checkpoint_backend!r}: "
                         f"'torch' or 'orbax'")
    # Only rank 0 writes.
    writes = mesh is None or mesh.rank == 0
    if writes:
        os.makedirs(run_dir, exist_ok=True)
    device = torch.device(device)
    logger = (JsonlLogger(os.path.join(run_dir, "stats.jsonl")) if writes
              else None)
    collector = Collector()
    tb = None
    if tensorboard and writes:
        # Optional mirror of the jsonl stream (utils/log_utils.py parity).
        from tgi_torch.utils.opt_viz import TBWriter
        tb = TBWriter(os.path.join(run_dir, "tb"))

    dataset = ImageFolderDataset(data_path,
                                 resolution=G.cfg.img_resolution,
                                 xflip=True)
    batches = infinite_batches(dataset, cfg.batch_size, seed=seed)

    augment_fn = (AugmentPipe() if ada_target is not None or augment_p > 0
                  else None)
    trainer = GANTrainer(G, d_cfg, cfg, augment_fn=augment_fn, mesh=mesh)
    state = init_train_state(torch.Generator().manual_seed(seed), G, d_cfg,
                             trainer, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    cur_nimg = 0
    manager = None
    snapshots = os.path.join(run_dir, "snapshots")
    if checkpoint_backend == "orbax" and writes:
        manager = make_manager(snapshots, max_to_keep=snapshot_keep)
    if resume_ckpt and checkpoint_backend == "orbax":
        src = (manager if manager is not None and os.path.abspath(
            resume_ckpt) == os.path.abspath(snapshots)
            else make_manager(resume_ckpt, max_to_keep=snapshot_keep))
        data, _ = restore_latest(src, {"params": train_state_tree(state)})
        if data is not None:
            load_train_state(state, data["params"])
            cur_nimg = int(data["cur_nimg"])
    elif resume_ckpt:
        from tgi_torch.io.checkpoints import load_checkpoint
        data = load_checkpoint(resume_ckpt, device=device)
        load_train_state(state, data["params"])
        cur_nimg = int((data["metadata"] or {}).get("cur_nimg", 0))
    if mesh is not None:
        replicate(mesh, {k: state[k] for k in ("g_params", "d_params",
                                               "g_ema")})

    ada_p = augment_p
    ada = (AdaptiveAugment(target=ada_target, batch_size=cfg.batch_size,
                           p=augment_p)
           if ada_target is not None else None)
    ada_signs = []          # Loss/signs/real window since last adjustment
    batch_idx = 0

    tick = 0
    tick_start_nimg = cur_nimg
    tick_start_time = time.time()
    start_time = tick_start_time

    try:
        while cur_nimg < total_kimg * 1000:
            real_img, real_c = next(batches)
            z = torch.randn((cfg.batch_size, G.cfg.z_dim), generator=gen,
                            device=device)
            real_c = torch.from_numpy(real_c).to(device)
            real_img = torch.from_numpy(real_img).to(device)
            if mesh is not None:
                z, real_c, real_img = shard_batch(mesh,
                                                  (z, real_c, real_img))

            n_batch = cur_nimg // cfg.batch_size
            do_greg = (n_batch % cfg.g_reg_interval) == 0
            do_dreg = (n_batch % cfg.d_reg_interval) == 0
            state, metrics = trainer.train_step(
                state, z, real_c, real_img, gen, cur_nimg=cur_nimg,
                do_greg=do_greg, do_dreg=do_dreg, ada_p=ada_p)
            cur_nimg += cfg.batch_size
            batch_idx += 1
            host_metrics = {k: float(v) for k, v in metrics.items()}
            collector.update(host_metrics)

            # ADA heuristic every ada_interval batches from
            # Loss/signs/real (training_loop.py:325-328).
            if ada is not None:
                ada_signs.append(host_metrics["signs_real"])
                if batch_idx % ada.interval == 0:
                    ada_p = ada.update(float(np.mean(ada_signs)))
                    ada_signs.clear()

            if cur_nimg >= tick_start_nimg + kimg_per_tick * 1000:
                now = time.time()
                stats = collector.as_dict()
                record = {
                    "tick": tick, "kimg": cur_nimg / 1000,
                    "sec_per_kimg": (now - tick_start_time)
                    / max((cur_nimg - tick_start_nimg) / 1000, 1e-8),
                    "total_sec": now - start_time, "ada_p": ada_p,
                    **{k: v["mean"] for k, v in stats.items()},
                }
                if writes:
                    print(" ".join(f"{k} {v:.4g}" if isinstance(v, float)
                                   else f"{k} {v}"
                                   for k, v in record.items()), flush=True)
                    logger.write(record)
                if tb is not None:
                    tb.scalars(record, cur_nimg // 1000, prefix="train/")
                    tb.flush()
                collector.reset()

                if writes and snapshot_ticks and tick % snapshot_ticks == 0:
                    if manager is not None:
                        save_step(manager, cur_nimg,
                                  {"params": train_state_tree(state),
                                   "cur_nimg": cur_nimg})
                    else:
                        from tgi_torch.io.checkpoints import save_checkpoint
                        save_checkpoint(
                            os.path.join(
                                run_dir,
                                f"network-{cur_nimg // 1000:06d}.ckpt"),
                            train_state_tree(state),
                            metadata={"cur_nimg": cur_nimg})
                    if metric_fns:
                        for name, fn in metric_fns.items():
                            val = fn(state["g_ema"])
                            logger.write({"metric": name,
                                          "value": float(val),
                                          "kimg": cur_nimg / 1000})

                if (writes and image_snapshot_ticks
                        and tick % image_snapshot_ticks == 0):
                    _save_snapshot_grid(G, state["g_ema"], run_dir, cur_nimg,
                                        seed)

                tick += 1
                tick_start_nimg = cur_nimg
                tick_start_time = now
                if abort_fn is not None and rank0_flag(
                        mesh, writes and abort_fn()):
                    break
        if manager is not None:
            manager.wait_until_finished()   # the saves are async
    finally:
        if logger is not None:
            logger.close()
        dataset.close()
        if tb is not None:
            tb.close()
        if manager is not None:
            manager.wait_until_finished()
    return state


def _save_snapshot_grid(G, g_ema, run_dir, cur_nimg, seed, n=4):
    """``fakes-XXXXXX.png``: ``n`` frontal renders of the EMA generator
    at truncation 0.7 (Pillow writes the file). The latents come from a
    generator seeded by ``seed``, the same at every snapshot, so the
    training draws do not depend on the snapshots."""
    from tgi_torch.render.cameras import (fov_to_intrinsics, look_at_pose,
                                          pack_camera)
    from tgi_torch.utils.image import save_image_grid
    dev = g_ema["mapping"]["fc0"]["weight"].device
    cam = look_at_pose(np.pi / 2, np.pi / 2, [0., 0., 0.2], radius=2.7,
                       device=dev)
    c = pack_camera(cam[None].repeat(n, 1, 1),
                    fov_to_intrinsics(18.837, device=dev))
    z = torch.randn((n, G.cfg.z_dim),
                    generator=torch.Generator().manual_seed(seed)).to(dev)
    with torch.no_grad():
        img = G(g_ema, z, c, truncation_psi=0.7, det=True)["image"]
    path = os.path.join(run_dir, f"fakes-{cur_nimg // 1000:06d}.png")
    save_image_grid(path, img, cols=n)
    return path
