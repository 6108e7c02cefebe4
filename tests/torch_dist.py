"""Data-parallel runs of the port on the CPU for the tests (not a test
module): ``spawn`` starts ranks that join a gloo group whose store is a
file in the test's directory, and each job below runs the same work
sharded (inside a rank, ``mesh`` given) or unsharded (in the test's own
process, ``mesh=None``). Rank 0 saves what it got with ``torch.save``.
No JAX here: every rank imports only torch and the port."""

import os

import numpy as np
import torch
import torch.distributed as dist

from tests.torch_tiny import TINY_D, TINY_GAN, port_camera, port_generator

# One step that crosses ranks everywhere it can: batch 4 over 2 ranks,
# minibatch-std groups of 4 (one group spans both ranks), the pose swap
# always on (gpc_reg_prob 1 once faded in), style mixing, the augment
# pipe, and both lazy regularisers.
STEP_GAN = dict(TINY_GAN, batch_size=4, gpc_reg_prob=1.0)
STEP_D = dict(TINY_D, mbstd_group_size=4)
# The loop's: both regularisers every other step.
LOOP_GAN = dict(STEP_GAN, g_reg_interval=2, d_reg_interval=2)
CUR_NIMG = 1000
ADA_P = 0.5


def spawn(jobs, world, tmp):
    """Each ``(job, args)`` of ``jobs``, in turn, as ``job(mesh, tmp,
    *args)`` in ``world`` ranks over gloo."""
    torch.multiprocessing.spawn(_rank, args=(jobs, world, str(tmp)),
                                nprocs=world, join=True)


def _rank(rank, jobs, world, tmp):
    from tgi_torch.parallel import make_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        for job, args in jobs:
            job(make_mesh(devices=["cpu"]), tmp, *args)
    finally:
        dist.destroy_process_group()


def _save(mesh, tmp, name, obj):
    if mesh is not None and mesh.rank == 0:
        torch.save(obj, os.path.join(tmp, name))


def gan_step_inputs(seed=0, N=4):
    """(z, c, real images) for the step: four cameras, images in [-1, 1]."""
    rng = np.random.RandomState(seed)
    z = torch.from_numpy(rng.randn(N, 32).astype(np.float32))
    c = port_camera([0.3 * i - 0.45 for i in range(N)])
    real = torch.from_numpy(rng.uniform(-1, 1, (N, 3, 64, 64))
                            .astype(np.float32))
    return z, c, real


def gan_step(mesh, tmp=None):
    """One ``train_step`` (STEP_GAN, STEP_D) from seed-0 weights on the
    rank's rows (the whole batch without ``mesh``), draws from a CPU
    generator of seed 5. Returns {"g", "d", "ema": params, "metrics",
    "grads": the sanitized gradients each Adam applied}."""
    from tgi_torch.nn.discriminator import (DiscriminatorConfig,
                                            discriminator_init)
    from tgi_torch.parallel import shard_batch
    from tgi_torch.train import augment, gan
    G, pt = port_generator()
    d_cfg = DiscriminatorConfig(**STEP_D)
    dt = discriminator_init(torch.Generator().manual_seed(1), d_cfg,
                            device="cpu")
    start = {"start_g": gan._map(torch.clone, pt),
             "start_d": gan._map(torch.clone, dt)}
    trainer = gan.GANTrainer(G, d_cfg, gan.GANTrainConfig(**STEP_GAN),
                             augment_fn=augment.AugmentPipe(), mesh=mesh)
    g = gan._map(lambda t: t.requires_grad_(True), pt)
    d = gan._map(lambda t: t.requires_grad_(True), dt)
    g_opt, d_opt = trainer.optimizers(g, d)
    state = {"g_params": g, "d_params": d,
             "g_ema": gan._map(lambda t: t.detach().clone(), pt),
             "g_opt": g_opt, "d_opt": d_opt}
    z, c, real = gan_step_inputs()
    if mesh is not None:
        z, c, real = shard_batch(mesh, (z, c, real))
    applied, real_apply = [], gan._apply

    def record(opt, params, grads):
        applied.append([gan._sanitize(x).detach().clone() for x in grads])
        return real_apply(opt, params, grads)

    gan._apply = record
    try:
        state, metrics = trainer.train_step(
            state, z, c, real, torch.Generator().manual_seed(5),
            cur_nimg=CUR_NIMG, do_greg=True, do_dreg=True, ada_p=ADA_P)
    finally:
        gan._apply = real_apply
    out = {"g": gan._map(torch.Tensor.detach, state["g_params"]),
           "d": gan._map(torch.Tensor.detach, state["d_params"]),
           "ema": state["g_ema"],
           "metrics": {k: float(v) for k, v in metrics.items()},
           "grads": applied, **start}
    _save(mesh, tmp, "gan_step.pt", out)
    return out


def mesh_checks(mesh, tmp):
    """The mesh's axes, ``shard_batch``'s rows and ``replicate`` inside a
    group of 2: saved by rank 0, with rank 1's seen through a gather."""
    from tgi_torch.parallel import make_mesh, replicate, shard_batch
    from tgi_torch.parallel.collectives import gather_rows
    x = torch.arange(8 * 3.0).reshape(8, 3)
    rows = shard_batch(mesh, {"x": x, "a": x.numpy()})
    w = torch.full((2,), float(mesh.rank))
    replicate(mesh, {"w": w})
    seen = gather_rows(mesh, torch.cat([rows["x"].reshape(1, -1),
                                        w.reshape(1, -1).repeat(1, 6)], 1))
    _save(mesh, tmp, "mesh_checks.pt", {
        "shape": mesh.shape, "rays2": make_mesh(
            devices=["cpu", "cpu"], rays=2).shape,
        "rows_equal": bool(np.array_equal(rows["a"], rows["x"].numpy())),
        "seen": seen})


def training_run(mesh, tmp, data, steps=2):
    """``training_loop`` for ``steps`` steps of batch 4 (LOOP_GAN, STEP_D)
    with one tick at the end (stats, a checkpoint, no image grid); the run
    directory is ``run{rank}`` (``run`` unsharded). Returns the state's
    params."""
    from tgi_torch.nn.discriminator import DiscriminatorConfig
    from tgi_torch.train import gan
    from tgi_torch.train.loop import training_loop
    G, _ = port_generator()
    cfg = gan.GANTrainConfig(**LOOP_GAN)
    kimg = steps * cfg.batch_size / 1000
    run = os.path.join(tmp, "run" if mesh is None else f"run{mesh.rank}")
    state = training_loop(G=G, d_cfg=DiscriminatorConfig(**STEP_D),
                          data_path=data, run_dir=run, cfg=cfg,
                          total_kimg=kimg, kimg_per_tick=kimg,
                          snapshot_ticks=1, image_snapshot_ticks=0,
                          augment_p=0.2, mesh=mesh, device="cpu")
    out = {k: gan._map(torch.Tensor.detach, state[k])
           for k in ("g_params", "d_params", "g_ema")}
    _save(mesh, tmp, "training_run.pt", out)
    return out


def project_setup(B=4):
    """The tiny projector (port only) and B targets at four yaws, each
    image with its own calibrated pose net."""
    from tgi_torch.invert import projector as proj
    from tgi_torch.models import pose_resnet, vgg
    G, pt = port_generator()
    gen = torch.Generator().manual_seed(31)
    v = vgg.vgg16_init(gen, "cpu", width_mult=0.125)
    head = vgg.lpips_head_init(gen, "cpu", width_mult=0.125)
    rng = np.random.RandomState(32)
    with torch.no_grad():
        w_t = torch.from_numpy((0.5 * rng.randn(B, 1, 32)).astype(
            np.float32)).repeat(1, G.cfg.num_ws, 1)
        img = G.synthesis(pt, w_t, port_camera(
            [0.25, -0.3, 0.1, -0.15][:B]))["image"].clamp(-1, 1)
    t255 = (img + 1) * 127.5
    pose0 = pose_resnet.resnet34_init(gen, 4, "cpu", width_mult=0.125,
                                      blocks=(1, 1, 1, 1))
    nets = [pose_resnet.resnet34_calibrate(pose0, t255[b:b + 1])
            for b in range(B)]
    pr = proj.Projector(G, pt, v, head, nets[0], proj.ProjectorConfig(
        num_steps=1, cam_preheat_steps=0, w_avg_samples=16))
    return pr, t255, pose_resnet.stack_nets(nets)


def project_step(mesh, tmp=None, B=4):
    """One ``project_batch`` step of B images (the rank's rows of them),
    image b drawing from a generator of seed 100 + b. Returns (ws, cams,
    the final state's w, the loss)."""
    from tgi_torch.parallel import shard_batch
    pr, t255, pose_b = project_setup(B)
    gens = [torch.Generator().manual_seed(100 + b) for b in range(B)]
    if mesh is not None:
        t255, pose_b = shard_batch(mesh, (t255, pose_b))
        n = B // mesh.data
        gens = gens[mesh.rank * n:(mesh.rank + 1) * n]
    ws, cams, state, metrics = pr.project_batch(
        t255, pose_params_b=pose_b, generators=gens, num_steps=1, mesh=mesh)
    out = {"ws": ws, "cams": cams, "w": state["w"].detach(),
           "loss": metrics["loss"][0]}
    if mesh is not None:
        from tgi_torch.parallel.collectives import gather_rows
        out = {k: gather_rows(mesh, v) for k, v in out.items()}
    _save(mesh, tmp, "project_step.pt", out)
    return out
