"""Stage-1 projection: joint w-latent + camera-pose optimization (twin of
``tgi/invert/projector.py``).

Behavioral parity target: training/projectors/w_projector.py:28-280.

Optimization state (w_projector.py:120-131):
  * w           - one w_dim latent, tiled to num_ws at render time;
  * noise       - every ``noise_const`` buffer of backbone and SR,
                  re-drawn at the start;
  * pose        - every leaf of the ResNet-34 pose estimator's tree;
  * translation - camera-frame translation, renormalized to the radius.

Three Adams (b1 .9, b2 .999, eps 1e-8, as ``optax.adam``): w + noise with
the ramped cosine learning rate set before each joint step, the camera
over the pose tree, and the translation. The first ``cam_preheat_steps``
steps update only the camera and the translation; every step then
re-normalizes the noise buffers. w gets annealed exploration noise in
the joint phase (w_projector.py:174-188).

``tgi`` runs the two phases as two ``lax.scan``s over one jitted step;
here they are two Python loops over :meth:`Projector.step`. Both renders
of a step run in float32 (``render_fp32``, the reference's
w_projector.py:189) even for a generator whose ``fused_dtype`` is
bfloat16, as in ``tgi``. ``remat_render`` recomputes each render in the
backward pass (``torch.utils.checkpoint``, ``tgi``'s ``jax.checkpoint``).
``tgi``'s ``dispatch_chunk`` (a TPU-relay guard), ``batch_views`` (one
N = 2 render of both views) and ``canon_sr_max_res`` (a gated fast mode,
ROADMAP Queue A item 18b) have no counterpart. Snapshots fire on the
plain step counter.

:meth:`Projector.project_batch` inverts B targets at once, each with its
own state (``tgi``'s ``project_batch``, projector.py:457-552): every
leaf of the state and of the Adams' moments gains a leading image axis,
the frozen generator stays shared but for the stacked ``noise_const``
buffers, and each step renders all B images in one synthesis call per
view. The loss is the sum of the images' losses, so each image's
gradient is its own; Adam is elementwise and every image shares the
step count and learning rate, so one Adam over the stacked leaves is B
per-image Adams. Image b draws from ``generators[b]`` what ``project``
draws from its generator, in the same order, so it equals a ``project``
call with that generator up to reassociation.
w starts at ``w_avg`` plus, with an ``e4e_encode``, the encoder's output
for the 256² [0, 255] target (w_projector.py:99-115).

Every random draw can be given as a tensor, so tests hand the port
``tgi``'s draws: the z batch of :meth:`Projector.compute_w_stats`, the
noise re-draw of :meth:`Projector.init_state`, and per step the w noise
and the two renders' draws (their (jitter, u), or every draw of each as
an ``invert/coach.py::render_draws`` dict, the density noise and the
random SR noise included).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import torch

from tgi_torch.invert.coach import (_leaves, _map, as_render_draws,
                                    cat_draws, checkpointed, complete_draws,
                                    render_draws)
from tgi_torch.losses.basic import (noise_regularization,
                                    noise_regularization_per_image,
                                    normalize_noise,
                                    normalize_noise_per_image)
from tgi_torch.losses.warp import (area_downsample, bilinear_resize_nchw,
                                   calc_warping_loss, calc_warping_losses)
from tgi_torch.models.pose_resnet import resnet34_apply, stack_nets
from tgi_torch.models.vgg import lpips_features, warping_features
from tgi_torch.parallel.collectives import from_rank0
from tgi_torch.render.cameras import (euler_to_rotmat, quaternion_to_rotmat,
                                      rot6d_to_rotmat)

CANONICAL_EXTRINSIC = ((1, 0, 0, 0), (0, -1, 0, 0), (0, 0, -1, 2.7),
                       (0, 0, 0, 1))
DEFAULT_INTRINSIC = ((4.2647, 0, 0.5), (0, 4.2647, 0.5), (0, 0, 1))
ADAM = dict(betas=(0.9, 0.999), eps=1e-8)


@dataclass(frozen=True)
class ProjectorConfig:
    num_steps: int = 400
    cam_preheat_steps: int = 50
    w_avg_samples: int = 5000
    first_inv_lr: float = 8e-3
    translation_lr: float = 2e-4
    cam_lr_2d: float = 6e-6
    cam_lr_quat: float = 6e-7
    cam_lr_6d: float = 6e-6
    camera_mode: str = "quat"        # '2d' | 'quat' | '6d'
    radius: float = 2.7
    initial_noise_factor: float = 0.05
    noise_ramp_length: float = 0.75
    lr_rampdown_length: float = 0.25
    lr_rampup_length: float = 0.05
    regularize_noise_weight: float = 1e5
    truncation_psi: float = 0.7
    truncation_cutoff: int = 14
    # The reference forces fp32 renders during projection
    # (w_projector.py:189); False lets the generator's fused_dtype apply.
    render_fp32: bool = True
    # Recompute each render in the backward pass instead of keeping its
    # activations (torch.utils.checkpoint; tgi's remat_render): about one
    # more forward per render, for the memory B images' renders take.
    # Every draw is taken before the render and passed in, so the
    # recompute sees the same values.
    remat_render: bool = False

    @property
    def cam_lr(self):
        return {"2d": self.cam_lr_2d, "quat": self.cam_lr_quat,
                "6d": self.cam_lr_6d}[self.camera_mode]


# ---------------------------------------------------------------------------
# Noise-buffer partitioning


def collect_noise_paths(params) -> list[tuple]:
    """Key-paths of every noise_const leaf in backbone + superresolution."""
    paths = []

    def walk(node, path):
        for k, v in node.items():
            if k == "noise_const":
                paths.append(path + (k,))
            elif isinstance(v, dict):
                walk(v, path + (k,))

    for top in ("backbone", "superresolution"):
        if top in params:
            walk(params[top], (top,))
    return sorted(paths)


def get_path(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def set_path(tree, path, value):
    """A copy of the nested dict ``tree`` with ``value`` at ``path``; the
    other leaves are shared."""
    if len(path) == 1:
        return {**tree, path[0]: value}
    return {**tree, path[0]: set_path(tree[path[0]], path[1:], value)}


def extract_noise(params, paths) -> dict:
    return {"/".join(p): get_path(params, p) for p in paths}


def merge_noise(params, noise: dict):
    for name, value in noise.items():
        params = set_path(params, tuple(name.split("/")), value)
    return params


# ---------------------------------------------------------------------------
# Camera assembly (w_projector.py:147-172)


def assemble_camera(pose_out, translation, mode: str, radius: float,
                    intrinsic_flat):
    """Pose-head output + translation -> (ext [N, 4, 4], cam [N, 25])."""
    if mode == "quat":
        rotmat = quaternion_to_rotmat(pose_out)
    elif mode == "6d":
        rotmat = rot6d_to_rotmat(pose_out)
    elif mode == "2d":
        rotmat = euler_to_rotmat(math.pi / 2 + pose_out[:, 0],
                                 math.pi / 2 + pose_out[:, 1])
    else:
        raise ValueError(f"unknown camera mode {mode!r}")
    n = rotmat.shape[0]
    pred_translation = -radius * rotmat[:, :3, 2]
    trans_world = -torch.einsum("nij,nj->ni", rotmat, translation) * radius
    t = trans_world + pred_translation
    t = t / torch.linalg.norm(t, dim=-1, keepdim=True) * radius
    bottom = torch.tensor([[0., 0., 0., 1.]], dtype=rotmat.dtype,
                          device=rotmat.device).expand(n, 1, 4)
    ext = torch.cat([torch.cat([rotmat, t[:, :, None]], dim=2), bottom],
                    dim=1)
    cam = torch.cat([ext.reshape(n, 16),
                     intrinsic_flat.reshape(1, 9).expand(n, 9)], dim=-1)
    return ext, cam


# ---------------------------------------------------------------------------
# Projector


class Projector:
    """Two-phase projection of one target: the latent, the noise buffers,
    the pose estimator and the translation, against a fixed generator.

    ``gen_params``, ``vgg_params``, ``lpips_head`` and ``pose_params``
    are trees of tensors on one device; the projector reads them and
    never changes them (the pose tree is copied into the state).
    """

    def __init__(self, G, gen_params, vgg_params, lpips_head, pose_params,
                 cfg: ProjectorConfig = ProjectorConfig(), e4e_encode=None):
        self.G = G
        self.cfg = cfg
        self.base_params = gen_params
        self.vgg_params = vgg_params
        self.lpips_head = lpips_head
        self.pose_params = pose_params
        # target_255 [1, 3, 256, 256] -> [1, w_dim] delta on w_avg.
        self.e4e_encode = e4e_encode
        self.noise_paths = collect_noise_paths(gen_params)
        dev = next(_leaves(gen_params)).device
        self.device = dev
        self.intrinsic = torch.tensor(DEFAULT_INTRINSIC, dtype=torch.float32,
                                      device=dev)
        self.init_ext = torch.tensor(CANONICAL_EXTRINSIC,
                                     dtype=torch.float32, device=dev)[None]
        self.canonical_cam = torch.cat([self.init_ext.reshape(1, 16),
                                        self.intrinsic.reshape(1, 9)], dim=-1)

    # -- initialization -----------------------------------------------------

    @torch.no_grad()
    def compute_w_stats(self, *, generator=None, z=None):
        """Mean and spread of w under the canonical camera
        (w_projector.py:87-97): ``w_avg_samples`` z through the mapping,
        drawn from ``generator`` or given as ``z``. Returns
        (w_avg [1, 1, w_dim], w_std, a 0-d tensor)."""
        cfg = self.cfg
        if z is None:
            z = torch.randn((cfg.w_avg_samples, self.G.cfg.z_dim),
                            generator=generator, device=self.device)
        z = z.to(self.device)
        cam = self.canonical_cam.expand(z.shape[0], 25)
        ws = self.G.mapping(self.base_params, z, cam,
                            truncation_psi=cfg.truncation_psi,
                            truncation_cutoff=cfg.truncation_cutoff)
        w = ws[:, 0, :]
        w_avg = w.mean(dim=0, keepdim=True)
        w_std = torch.sqrt(torch.sum(torch.square(w - w_avg)) / z.shape[0])
        return w_avg[None], w_std

    def init_state(self, *, generator=None, z=None, noise=None,
                   target_255=None):
        """(state, optimizers, w_std): w at ``w_avg`` (plus the e4e
        encoder's output for ``target_255`` when the projector has one),
        the noise buffers re-drawn from ``generator`` (or given as
        ``noise``, a dict keyed like :func:`extract_noise`), zero
        translation, and a copy of the pose tree, every leaf a tensor that
        requires grad; the three Adams over them."""
        cfg = self.cfg
        w_avg, w_std = self.compute_w_stats(generator=generator, z=z)
        start_w = w_avg
        if self.e4e_encode is not None:
            if target_255 is None:
                raise ValueError("the e4e start needs target_255")
            # w starts at mean_w + the RAW encoder output
            # (w_projector.py:113-115; pSp2.forward returns codes[:, 0, :]
            # with no latent_avg added, e4e/psp.py:47-64): a delta on the
            # generator's truncated w-mean. The encoder reads the 256²
            # target in [0, 255] (w_projector.py:73).
            with torch.no_grad():
                start_w = w_avg + self.e4e_encode(
                    target_255.float().to(self.device))[:, None, :]
        if noise is None:
            noise = {"/".join(p): torch.randn(
                get_path(self.base_params, p).shape, generator=generator,
                device=self.device) for p in self.noise_paths}
        def fresh(t):
            return t.detach().to(self.device).clone().requires_grad_(True)

        state = {"w": fresh(start_w),
                 "noise": {k: fresh(noise[k]) for k in
                           ("/".join(p) for p in self.noise_paths)},
                 "translation": fresh(torch.zeros((1, 3))),
                 "pose": _map(fresh, self.pose_params)}
        opts = {"w": torch.optim.Adam([state["w"], *state["noise"].values()],
                                      lr=cfg.first_inv_lr, **ADAM),
                "cam": torch.optim.Adam(list(_leaves(state["pose"])),
                                        lr=cfg.cam_lr, **ADAM),
                "trans": torch.optim.Adam([state["translation"]],
                                          lr=cfg.translation_lr, **ADAM)}
        return state, opts, w_std

    # -- loss ---------------------------------------------------------------

    def camera(self, pose, translation, target_255):
        """(ext [1, 4, 4], cam [1, 25]) the pose tree predicts for the
        target."""
        cfg = self.cfg
        return assemble_camera(resnet34_apply(pose, target_255), translation,
                               cfg.camera_mode, cfg.radius, self.intrinsic)

    def _loss(self, state, target_255, target_lpips_feats, w_noise, *,
              generator=None, draws=None, target_warp=None):
        """(loss, {"dist", "warp", "noise_reg", "pred_cam"}) of one step:
        the predicted view and the canonical view rendered stochastically,
        their draws from ``generator`` or given as ``draws`` = (the
        predicted view's, the canonical one's), each a ``render_draws``
        dict or (jitter, u); under ``remat_render`` every draw."""
        cfg = self.cfg
        if target_warp is None:
            # Without the full-resolution target: the same 256² target in
            # [-1, 1].
            target_warp = target_255 / 127.5 - 1.0
        if draws is None and cfg.remat_render:
            draws = tuple(render_draws(self.G, [generator], self.device)
                          for _ in range(2))
        d_pred, d_canon = (as_render_draws(d) for d in draws or (None, None))
        if cfg.remat_render:
            d_pred, d_canon = (complete_draws(self.G, d)
                               for d in (d_pred, d_canon))
        pred_ext, pred_cam = self.camera(state["pose"], state["translation"],
                                         target_255)
        ws = (state["w"] + w_noise).repeat(1, self.G.cfg.num_ws, 1)
        gen_params = merge_noise(self.base_params, state["noise"])
        render = self._renderer(generator)
        pred = render(gen_params, ws, pred_cam, d_pred)
        # The canonical view renders the detached latent
        # (w_projector.py:203-205); pose and noise still get gradient.
        canon = render(gen_params, ws.detach(), self.canonical_cam, d_canon)
        pred_images_255 = pred["image"] * 127.5 + 128

        # Both warp-feature inputs are in [-1, 1] (warping_loss.py:37-38,
        # w_projector.py:109), not the 0-255 scale of LPIPS and the pose
        # net.
        warp_loss, _ = calc_warping_loss(
            canon["image"], partial(warping_features, self.vgg_params),
            pred_ext, self.init_ext, self.intrinsic[None],
            pred["image_depth"], target_warp)

        # LPIPS at the target's resolution (w_projector.py:215-218).
        t_res = target_255.shape[-1]
        if pred_images_255.shape[-1] > t_res:
            pred_images_255 = area_downsample(pred_images_255, t_res)
        elif pred_images_255.shape[-1] < t_res:
            # Small test generators render below the target; enlarge (no
            # reference counterpart).
            pred_images_255 = bilinear_resize_nchw(pred_images_255, t_res)
        synth_feats = lpips_features(self.vgg_params, self.lpips_head,
                                     pred_images_255)
        dist = torch.sum(torch.square(target_lpips_feats - synth_feats))

        reg = noise_regularization(state["noise"])
        loss = dist + reg * cfg.regularize_noise_weight + warp_loss
        return loss, {"dist": dist, "warp": warp_loss, "noise_reg": reg,
                      "pred_cam": pred_cam}

    def _renderer(self, generator=None):
        """render(params, ws, cam, draws): one stochastic render of the
        projection with the given ``draws`` (synthesis keywords; the rest
        from ``generator``), recomputed in the backward pass under
        ``remat_render``."""
        def render(params, ws, cam, draws):
            return self.G.synthesis(params, ws, cam, noise_mode="const",
                                    det=False, generator=generator,
                                    force_fp32=self.cfg.render_fp32, **draws)
        return checkpointed(render) if self.cfg.remat_render else render

    # -- stepping -----------------------------------------------------------

    def schedule(self, step):
        """(w-noise scale factor, w learning rate) of ``step``
        (w_projector.py:174-188); the scale multiplies w_std."""
        cfg = self.cfg
        t = ((step - cfg.cam_preheat_steps)
             / max(cfg.num_steps - cfg.cam_preheat_steps, 1))
        noise_scale = (cfg.initial_noise_factor
                       * max(0.0, 1.0 - t / cfg.noise_ramp_length) ** 2)
        ramp = min(1.0, (1.0 - t) / cfg.lr_rampdown_length)
        ramp = 0.5 - 0.5 * math.cos(ramp * math.pi)
        ramp = ramp * min(1.0, t / cfg.lr_rampup_length)
        return noise_scale, cfg.first_inv_lr * ramp

    def step(self, state, opts, step, w_std, target_255, target_feats, *,
             target_warp=None, generator=None, w_noise=None, draws=None):
        """One step, in place on ``state`` and ``opts``: the loss, its
        gradient, then :meth:`update`. Returns the step's
        {"loss", "dist", "warp"} as tensors.

        ``step`` < ``cam_preheat_steps`` is a preheat step, and w gets no
        noise. ``w_noise`` replaces the joint phase's draw (``w_std`` ×
        the annealed scale × a unit normal from ``generator``)."""
        if step < self.cfg.cam_preheat_steps:
            w_noise = torch.zeros_like(state["w"])
        elif w_noise is None:
            w_noise = torch.randn(state["w"].shape, generator=generator,
                                  device=self.device) * (
                                      w_std * self.schedule(step)[0])
        for opt in opts.values():
            opt.zero_grad(set_to_none=True)
        loss, aux = self._loss(state, target_255, target_feats,
                               w_noise.to(self.device), generator=generator,
                               draws=draws, target_warp=target_warp)
        loss.backward()
        self.update(state, opts, step)
        dist, warp = aux["dist"].detach(), aux["warp"].detach()
        return {"loss": dist + warp, "dist": dist, "warp": warp}

    def update(self, state, opts, step):
        """The optimizer half of step ``step``, in place, from the
        gradients on ``state``'s leaves: the camera and translation Adams;
        after the preheat also the w + noise Adam, at the step's learning
        rate; then every noise buffer renormalized (each image's on its
        own in a batched state, whose w is [B, 1, 1, w_dim])."""
        preheat = step < self.cfg.cam_preheat_steps
        names = ("cam", "trans") if preheat else ("cam", "trans", "w")
        for name in names:
            for group in opts[name].param_groups:
                for p in group["params"]:
                    # optax steps every leaf, a zero gradient included;
                    # torch skips a leaf without one.
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
        if not preheat:
            opts["w"].param_groups[0]["lr"] = self.schedule(step)[1]
        for name in names:
            opts[name].step()
        normalize = (normalize_noise_per_image if state["w"].ndim == 4
                     else normalize_noise)
        with torch.no_grad():
            for v in state["noise"].values():
                v.copy_(normalize(v))

    def project(self, target_255, *, generator=None, num_steps=None,
                target_full=None, snapshot_fn=None, snapshot_every=10,
                z=None, noise=None, draws=None):
        """Run the two phases.

        target_255: [1, 3, 256, 256] in [0, 255] on the projector's
        device. ``target_full``: optional [1, 3, R, R] target in [-1, 1]
        for the warping loss (the reference feeds the raw target,
        w_projector.py:109); absent, the 256² target rescaled.

        ``snapshot_fn(step, state, target_255)`` fires every
        ``snapshot_every`` steps, at the phase boundary and at the end,
        with the count of steps done. Draws come from ``generator``;
        ``z`` and ``noise`` replace the initial ones (see
        :meth:`init_state`) and ``draws(step) -> (w_noise, render
        draws)`` those of each step (either may be None).

        Returns (ws [1, num_ws, w_dim], camera [1, 25], final state,
        metrics {"loss", "dist", "warp"}: one float per step).
        """
        cfg = self.cfg
        num_steps = num_steps or cfg.num_steps
        target_255 = target_255.float().to(self.device).contiguous()
        target_warp = (None if target_full is None else
                       target_full.float().to(self.device).contiguous())
        with torch.no_grad():
            target_feats = lpips_features(self.vgg_params, self.lpips_head,
                                          target_255)
        state, opts, w_std = self.init_state(generator=generator, z=z,
                                             noise=noise,
                                             target_255=target_255)
        preheat_steps = min(cfg.cam_preheat_steps, num_steps)
        metrics = {"loss": [], "dist": [], "warp": []}
        for i in range(num_steps):
            w_noise, step_draws = draws(i) if draws is not None else (
                None, None)
            m = self.step(state, opts, i, w_std, target_255, target_feats,
                          target_warp=target_warp, generator=generator,
                          w_noise=w_noise, draws=step_draws)
            for k, v in m.items():
                metrics[k].append(float(v))
            done = i + 1
            if snapshot_fn is not None and (
                    done % snapshot_every == 0
                    or done in (preheat_steps, num_steps)):
                snapshot_fn(done, state, target_255)

        # Final camera from the tuned pose net (no w noise).
        with torch.no_grad():
            _, cam = self.camera(state["pose"], state["translation"],
                                 target_255)
            ws = state["w"].detach().repeat(1, self.G.cfg.num_ws, 1)
        return ws, cam, _map(lambda t: t.detach(), state), metrics

    # -- batched inversion --------------------------------------------------

    def init_state_batch(self, B, *, generators=None, z=None, noise=None,
                         targets_255=None, pose_params_b=None, mesh=None):
        """:meth:`init_state` of B images at once: (state, optimizers,
        w_std). Image b's leaves are row b of the state's: w [B, 1, 1,
        w_dim], noise [B, res, res] per buffer, translation [B, 1, 3] and
        the pose tree stacked (``pose_params_b``, a stacked tree of B
        starting nets, or the projector's net B times).

        Image b draws its z batch and then its noise from
        ``generators[b]`` (or takes ``z`` [B, n, z_dim] and ``noise``, a
        dict of [B, res, res] stacks); each image starts at its own
        batch's w mean, plus the e4e code of its own target, and w_std is
        image 0's, as ``tgi`` takes ``w_std[0]``: with a data-parallel
        ``mesh`` (``tgi_torch.parallel``), the global batch's image 0's,
        which rank 0 holds."""
        cfg = self.cfg
        gens = list(generators) if generators is not None else [None] * B
        dev = self.device
        if z is None:
            z = torch.stack([torch.randn((cfg.w_avg_samples,
                                          self.G.cfg.z_dim), generator=g,
                                         device=dev) for g in gens])
        z = z.to(dev)
        n = z.shape[1]
        with torch.no_grad():
            ws = self.G.mapping(self.base_params, z.reshape(B * n, -1),
                                self.canonical_cam.expand(B * n, 25),
                                truncation_psi=cfg.truncation_psi,
                                truncation_cutoff=cfg.truncation_cutoff)
            w = ws[:, 0, :].reshape(B, n, -1)
            w_avg = w.mean(dim=1, keepdim=True)                 # [B, 1, D]
            w_std = from_rank0(mesh, torch.sqrt(
                torch.sum(torch.square(w[0] - w_avg[0])) / n))
            start_w = w_avg[:, None]                         # [B, 1, 1, D]
            if self.e4e_encode is not None:
                if targets_255 is None:
                    raise ValueError("the e4e start needs targets_255")
                t = targets_255.float().to(dev)
                start_w = start_w + torch.stack([
                    self.e4e_encode(t[b:b + 1])[:, None, :]
                    for b in range(B)])
        if noise is None:
            noise = {"/".join(p): torch.stack([torch.randn(
                get_path(self.base_params, p).shape, generator=g,
                device=dev) for g in gens]) for p in self.noise_paths}

        def fresh(t):
            return t.detach().to(dev).clone().requires_grad_(True)

        pose = (pose_params_b if pose_params_b is not None
                else stack_nets([self.pose_params] * B))
        state = {"w": fresh(start_w),
                 "noise": {k: fresh(noise[k]) for k in
                           ("/".join(p) for p in self.noise_paths)},
                 "translation": fresh(torch.zeros((B, 1, 3))),
                 "pose": _map(fresh, pose)}
        opts = {"w": torch.optim.Adam([state["w"], *state["noise"].values()],
                                      lr=cfg.first_inv_lr, **ADAM),
                "cam": torch.optim.Adam(list(_leaves(state["pose"])),
                                        lr=cfg.cam_lr, **ADAM),
                "trans": torch.optim.Adam([state["translation"]],
                                          lr=cfg.translation_lr, **ADAM)}
        return state, opts, w_std

    def _loss_batch(self, state, targets_255, target_feats, w_noise, draws,
                    targets_warp=None):
        """(the sum of the B images' losses, {"dist", "warp", "noise_reg":
        [B] each, "pred_cam" [B, 25]}): :meth:`_loss` of every image of a
        batched state, each view of all B images in one render. ``draws``
        = (the predicted views', the canonical ones'), each every draw of
        the B images' render (``invert/coach.py::render_draws``), or
        (jitter, u) where the render takes no other."""
        cfg = self.cfg
        B = targets_255.shape[0]
        if targets_warp is None:
            targets_warp = targets_255 / 127.5 - 1.0
        d_pred, d_canon = (complete_draws(self.G, as_render_draws(d))
                           for d in draws)
        pred_ext, pred_cam = assemble_camera(
            resnet34_apply(state["pose"], targets_255),
            state["translation"].reshape(B, 3), cfg.camera_mode, cfg.radius,
            self.intrinsic)
        ws = (state["w"] + w_noise).reshape(B, 1, -1).repeat(
            1, self.G.cfg.num_ws, 1)
        gen_params = merge_noise(self.base_params, state["noise"])
        render = self._renderer()
        pred = render(gen_params, ws, pred_cam, d_pred)
        canon = render(gen_params, ws.detach(),
                       self.canonical_cam.expand(B, 25), d_canon)
        pred_images_255 = pred["image"] * 127.5 + 128
        warp = calc_warping_losses(
            canon["image"], partial(warping_features, self.vgg_params),
            pred_ext, self.init_ext, self.intrinsic[None],
            pred["image_depth"], targets_warp)
        t_res = targets_255.shape[-1]
        if pred_images_255.shape[-1] > t_res:
            pred_images_255 = area_downsample(pred_images_255, t_res)
        elif pred_images_255.shape[-1] < t_res:
            pred_images_255 = bilinear_resize_nchw(pred_images_255, t_res)
        synth_feats = lpips_features(self.vgg_params, self.lpips_head,
                                     pred_images_255)
        dist = torch.sum(torch.square(target_feats - synth_feats), dim=1)
        reg = noise_regularization_per_image(state["noise"])
        loss = dist + reg * cfg.regularize_noise_weight + warp
        return loss.sum(), {"dist": dist, "warp": warp, "noise_reg": reg,
                            "pred_cam": pred_cam}

    def step_batch(self, state, opts, step, w_std, targets_255, target_feats,
                   *, targets_warp=None, generators=None, w_noise=None,
                   draws=None):
        """:meth:`step` of a batched state: B images' steps in one, in
        place. Image b's w noise and render draws come from
        ``generators[b]`` in :meth:`step`'s order (w noise, then the
        predicted and the canonical view's), unless given as ``w_noise``
        [B, 1, 1, w_dim] and ``draws`` (see :meth:`_loss_batch`). Returns
        {"loss", "dist", "warp"}, each [B]."""
        B = state["w"].shape[0]
        gens = list(generators) if generators is not None else [None] * B
        if draws is not None and w_noise is None and \
                step >= self.cfg.cam_preheat_steps:
            raise ValueError("given render draws need the w noise too")
        if step < self.cfg.cam_preheat_steps:
            w_noise = torch.zeros_like(state["w"])
        elif w_noise is None:
            w_noise = torch.stack([torch.randn(
                state["w"].shape[1:], generator=g, device=self.device)
                for g in gens]) * (w_std * self.schedule(step)[0])
        if draws is None:
            draws = [[], []]
            for g in gens:                  # each image's draws in order
                for view in draws:
                    view.append(render_draws(self.G, [g], self.device))
            draws = tuple(cat_draws(v) for v in draws)
        for opt in opts.values():
            opt.zero_grad(set_to_none=True)
        loss, aux = self._loss_batch(state, targets_255, target_feats,
                                     w_noise.to(self.device), draws,
                                     targets_warp=targets_warp)
        loss.backward()
        self.update(state, opts, step)
        dist, warp = aux["dist"].detach(), aux["warp"].detach()
        return {"loss": dist + warp, "dist": dist, "warp": warp}

    def project_batch(self, targets_255, *, targets_warp=None,
                      pose_params_b=None, generators=None, num_steps=None,
                      z=None, noise=None, draws=None, mesh=None):
        """Invert B targets at once (``tgi``'s ``project_batch``,
        BASELINE.json's configuration 5): B independent projections, each
        with its own w, noise buffers, translation, pose net and Adam
        moments, as the reference's per-image loop has them
        (w_projector.py:62, 120-131).

        targets_255: [B, 3, 256, 256] (or [B, 1, 3, 256, 256]) in [0,
        255]; ``targets_warp``: optional [B(, 1), 3, R, R] in [-1, 1],
        each image's warp target (``project``'s ``target_full``);
        ``pose_params_b``: a stacked tree of B starting pose nets
        (``models/pose_resnet.py::stack_nets``), e.g. the gate's aimed
        nets. Draws: image b's from ``generators[b]`` (see
        :meth:`init_state_batch` and :meth:`step_batch`), or ``z`` /
        ``noise`` and ``draws(step) -> (w_noise, render draws)`` given.
        Data-parallel over a ``mesh``'s ranks (``tgi_torch.parallel``),
        each rank passes its rows of the global batch (``shard_batch``:
        targets, nets, generators) and inverts them; the images meet only
        in w_std, the global image 0's (:meth:`init_state_batch`).

        Returns (ws [B, 1, num_ws, w_dim], cams [B, 1, 25], the final
        state, metrics {"loss", "dist", "warp"}: [steps, B] tensors).
        """
        cfg = self.cfg
        num_steps = num_steps or cfg.num_steps
        if targets_255.ndim == 5:
            targets_255 = targets_255[:, 0]
        B = targets_255.shape[0]
        targets_255 = targets_255.float().to(self.device).contiguous()
        if targets_warp is not None:
            if targets_warp.ndim == 5:
                targets_warp = targets_warp[:, 0]
            targets_warp = targets_warp.float().to(self.device).contiguous()
        with torch.no_grad():
            target_feats = lpips_features(self.vgg_params, self.lpips_head,
                                          targets_255)
        state, opts, w_std = self.init_state_batch(
            B, generators=generators, z=z, noise=noise,
            targets_255=targets_255, pose_params_b=pose_params_b, mesh=mesh)
        metrics = {"loss": [], "dist": [], "warp": []}
        for i in range(num_steps):
            w_noise, step_draws = draws(i) if draws is not None else (
                None, None)
            m = self.step_batch(state, opts, i, w_std, targets_255,
                                target_feats, targets_warp=targets_warp,
                                generators=generators, w_noise=w_noise,
                                draws=step_draws)
            for k, v in m.items():
                metrics[k].append(v)
        metrics = {k: torch.stack(v).cpu() for k, v in metrics.items()}
        with torch.no_grad():
            _, cams = assemble_camera(
                resnet34_apply(state["pose"], targets_255),
                state["translation"].reshape(B, 3), cfg.camera_mode,
                cfg.radius, self.intrinsic)
            ws = state["w"].detach().repeat(1, 1, self.G.cfg.num_ws, 1)
        return ws, cams[:, None], _map(lambda t: t.detach(), state), metrics
