"""EG3D GAN training: losses, phased updates, EMA (twin of
``tgi/train/gan.py``).

Behavioral parity targets:
  StyleGAN2Loss (non-saturating + dual discrimination + density reg + R1,
  pose-conditioning swap, raw-blur fade, neural-res annealing)
                                    training/loss.py:28-292
  training_loop phase structure / lazy regularization / EMA
                                    training/training_loop.py:201-317

One ``train_step`` runs Gmain (+ lazy Greg at gain ``g_reg_interval``),
Dmain (+ lazy R1 at gain ``d_reg_interval``) and the EMA update, eagerly
on the params' device. Parameters are dicts of leaf tensors that two
``torch.optim.Adam`` update in place, with ``tgi``'s lazy-adjusted lr and
betas (b1 = 0). The D phase renders the fakes again with the updated G,
under ``torch.no_grad`` (``tgi``'s ``stop_gradient``), so it launches
the gather and no splat. R1 takes the gradient of D's logits with respect
to the real image and raw image with ``create_graph=True`` and
differentiates it again to D's weights.

Every random draw comes from a draw source (``tgi_torch.utils.draws``)
split as ``tgi`` splits its key; a ``torch.Generator`` draws them in
call order.

With a data-parallel ``mesh`` (``tgi_torch.parallel``) each rank steps
on its rows of the global batch and the step is ``tgi``'s unsharded one:
the conditioning swap rolls the gathered batch, minibatch-std reads every
rank's rows, each draw is the global draw's rows
(``utils/draws.py::RowDraws``), the metrics are means over the ranks,
and each phase's gradients are averaged by one flat all-reduce before
they are sanitized (``parallel/collectives.py``). Not
``DistributedDataParallel``: the gradients come from
``torch.autograd.grad`` on the params tree.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tgi_torch.nn.discriminator import (DiscriminatorConfig,
                                        discriminator_init,
                                        dual_discriminator_apply,
                                        filtered_resizing)
from tgi_torch.nn.superres import sr_random_noise
from tgi_torch.nn.synthesis import random_noise
from tgi_torch.ops.upfirdn2d import filter2d
from tgi_torch.parallel.collectives import (gather_rows, mean_grads,
                                            mean_over_ranks, own_rows)
from tgi_torch.render.renderer import density_noise_draws
from tgi_torch.utils.draws import RowDraws, as_draws


@dataclass(frozen=True)
class GANTrainConfig:
    batch_size: int = 4
    r1_gamma: float = 1.0
    g_lr: float = 0.0025
    d_lr: float = 0.002
    beta2: float = 0.99
    g_reg_interval: int = 4      # density regularization cadence
    d_reg_interval: int = 16     # R1 cadence
    ema_kimg: float = 10.0
    ema_rampup: float | None = 0.05
    style_mixing_prob: float = 0.0
    blur_init_sigma: float = 10.0
    blur_fade_kimg: float = 200.0
    gpc_reg_prob: float | None = 0.5
    gpc_reg_fade_kimg: float = 1000.0
    neural_rendering_resolution_initial: int = 64
    neural_rendering_resolution_final: int | None = None
    neural_rendering_resolution_fade_kimg: float = 1000.0
    density_reg_samples: int = 1000
    filter_mode: str = "antialiased"

    def lazy_adjusted(self, lr, interval):
        """Lazy-regularization lr/beta adjustment
        (training_loop.py:205-212)."""
        mb_ratio = interval / (interval + 1)
        return lr * mb_ratio, 0.0 ** mb_ratio, self.beta2 ** mb_ratio


def _blur(img, blur_sigma, blur_size: int):
    """Gaussian blur (loss.py:74-77) of ``2 * blur_size + 1`` taps;
    ``blur_size`` is floor(sigma * 3), computed on the host. The taps are
    ``tgi``'s float32 ``exp2`` formula."""
    if blur_size <= 0:
        return img
    x = np.arange(-blur_size, blur_size + 1, dtype=np.float32)
    sigma = np.maximum(np.float32(blur_sigma), np.float32(1e-8))
    f = np.exp2(-np.square(x / sigma))
    return filter2d(img, f / f.sum())


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _sanitize(grad):
    """nan_to_num on a gradient (training_loop.py:296)."""
    return torch.nan_to_num(grad, nan=0.0, posinf=1e5, neginf=-1e5)


def _grads(loss, params):
    """d loss / d every leaf of ``params``, zeros where the loss does not
    reach a leaf (``jax.grad``'s zeros)."""
    leaves = [t for _, t in _leaves(params)]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves, grads)]


class GANTrainer:
    """Losses and the step; all state lives in the train-state dict
    (:func:`init_train_state`)."""

    def __init__(self, G, d_cfg: DiscriminatorConfig,
                 cfg: GANTrainConfig = GANTrainConfig(), augment_fn=None,
                 mesh=None):
        self.G = G
        self.d_cfg = d_cfg
        self.cfg = cfg
        self.augment_fn = augment_fn
        self.mesh = mesh
        self.g_adam = cfg.lazy_adjusted(cfg.g_lr, cfg.g_reg_interval)
        self.d_adam = cfg.lazy_adjusted(cfg.d_lr, cfg.d_reg_interval)

    def optimizers(self, g_params, d_params):
        """The two Adams (``optax.adam(lr, b1, b2, eps=1e-8)`` in ``tgi``)
        over the params' leaves, in tree order."""
        def adam(params, lr_b1_b2):
            lr, b1, b2 = lr_b1_b2
            return torch.optim.Adam([t for _, t in _leaves(params)], lr=lr,
                                    betas=(b1, b2), eps=1e-8)
        return adam(g_params, self.g_adam), adam(d_params, self.d_adam)

    # -- schedules (host side) ----------------------------------------------

    def _schedules(self, cur_nimg):
        cfg = self.cfg
        blur_sigma = (max(1 - cur_nimg / (cfg.blur_fade_kimg * 1e3), 0)
                      * cfg.blur_init_sigma if cfg.blur_fade_kimg > 0 else 0)
        alpha = (min(cur_nimg / (cfg.gpc_reg_fade_kimg * 1e3), 1)
                 if cfg.gpc_reg_fade_kimg > 0 else 1)
        swapping_prob = ((1 - alpha) * 1 + alpha * cfg.gpc_reg_prob
                         if cfg.gpc_reg_prob is not None else None)
        if cfg.neural_rendering_resolution_final is not None:
            a = min(cur_nimg / (cfg.neural_rendering_resolution_fade_kimg
                                * 1e3), 1)
            res = int(np.rint(cfg.neural_rendering_resolution_initial
                              * (1 - a)
                              + cfg.neural_rendering_resolution_final * a))
        else:
            res = cfg.neural_rendering_resolution_initial
        ema_nimg = cfg.ema_kimg * 1000
        if cfg.ema_rampup is not None:
            ema_nimg = min(ema_nimg, max(cur_nimg, 1) * cfg.ema_rampup)
        ema_beta = 0.5 ** (cfg.batch_size / max(ema_nimg, 1e-8))
        return blur_sigma, swapping_prob, res, ema_beta

    def _rolled(self, c):
        """``torch.roll(c, 1, dims=0)`` over the global batch, this rank's
        rows (loss.py:62's swap partner)."""
        return own_rows(self.mesh, torch.roll(gather_rows(self.mesh, c), 1,
                                              dims=0))

    # -- G side -------------------------------------------------------------

    def _run_G(self, g_params, z, c, draws, swapping_prob, neural_res):
        k_swap, k_render, k_mix, k_z2, k_cut = draws.split(5)
        N = c.shape[0]
        if swapping_prob is not None:
            swap = k_swap.uniform((N, 1)) < swapping_prob
            c_gen = torch.where(swap, self._rolled(c), c)
        else:
            c_gen = torch.zeros_like(c)
        ws = self.G.mapping(g_params, z, c_gen)
        if self.cfg.style_mixing_prob > 0:
            # loss.py:65-72: one batch-wide cutoff, mixed ws past it.
            num_ws = ws.shape[1]
            ws2 = self.G.mapping(g_params, k_z2.normal(z.shape), c)
            cutoff = k_cut.randint((), 1, num_ws)
            cutoff = torch.where(
                k_mix.uniform(()) < self.cfg.style_mixing_prob, cutoff,
                torch.full_like(cutoff, num_ws))
            mixed = (torch.arange(num_ws, device=ws.device)[None, :, None]
                     >= cutoff)
            ws = torch.where(mixed, ws2, ws)
        # The synthesis key's splits (tgi/models/generator.py:185) and the
        # renderer's (tgi/render/renderer.py:70).
        k_bb, k_r, k_sr = k_render.split(3)
        k_strat, k_imp, k_noise = k_r.split(3)
        rk = self.G.cfg.rendering_kwargs
        M = neural_res * neural_res
        S, Si = rk["depth_resolution"], rk["depth_resolution_importance"]
        sigma_noise = sr_noise = None
        if rk.get("density_noise", 0) > 0:
            sigma_noise = density_noise_draws((N, M * S, 1), (N, M * Si, 1),
                                              k_noise)
        if rk.get("superresolution_noise_mode") == "random":
            sr_noise = sr_random_noise(self.G.cfg.sr_cfg, N, k_sr)
        out = self.G.synthesis(
            g_params, ws, c, neural_rendering_resolution=neural_res,
            noise_mode="random", det=False,
            noise=random_noise(self.G.cfg.backbone_cfg, N, k_bb),
            jitter=k_strat.uniform((N, M, S, 1)),
            u=k_imp.uniform((N * M, Si)), sigma_noise=sigma_noise,
            sr_noise=sr_noise)
        return out, ws

    def _run_D(self, d_params, img, img_raw, c, draws, blur_sigma, blur_size,
               ada_p):
        img = _blur(img, blur_sigma, blur_size)
        if self.augment_fn is not None:
            img, img_raw = self.augment_fn(img, img_raw, draws, ada_p)
        return dual_discriminator_apply(d_params, img, img_raw, c, self.d_cfg,
                                        filter_mode=self.cfg.filter_mode,
                                        mesh=self.mesh)

    def gmain_loss(self, g_params, d_params, z, c, draws, blur_sigma,
                   blur_size, swapping_prob, neural_res, ada_p):
        k_g, k_d = draws.split(2)
        out, _ = self._run_G(g_params, z, c, k_g, swapping_prob, neural_res)
        logits = self._run_D(d_params, out["image"], out["image_raw"], c,
                             k_d, blur_sigma, blur_size, ada_p)
        return F.softplus(-logits).mean()

    def greg_loss(self, g_params, z, c, draws, swapping_prob):
        """Density regularization, reg_type-dispatch (loss.py:131-240)."""
        rk = self.G.cfg.rendering_kwargs
        reg_type = rk.get("reg_type", "l1")
        k_swap, k_coord, k_perturb = draws.split(3)
        if swapping_prob is not None:
            swap = k_swap.uniform(()) < swapping_prob
            c_gen = torch.where(swap, self._rolled(c), c)
        else:
            c_gen = torch.zeros_like(c)
        ws = self.G.mapping(g_params, z, c_gen)
        N = ws.shape[0]
        n = self.cfg.density_reg_samples
        loss = 0.0
        if reg_type in ("monotonic-detach", "monotonic-fixed"):
            pts = (k_coord.uniform((N, 2 * n, 3)) * 2 - 1)[:, :n]
            behind = pts + torch.tensor([0, 0, -1.0], device=pts.device) \
                / 256 * rk["box_warp"]
            allpts = torch.cat([pts, behind], dim=1)
            sigma = self.G.sample_mixed(g_params, allpts, ws)["sigma"]
            s0, s1 = sigma[:, :n], sigma[:, n:]
            if reg_type == "monotonic-detach":
                s0 = s0.detach()
            loss = loss + F.relu(s0 - s1).mean() * 10
            perturb_scale = (1 / 256) * rk["box_warp"]
        else:
            perturb_scale = rk["density_reg_p_dist"]
        pts = k_coord.uniform((N, n, 3)) * 2 - 1
        perturbed = pts + k_perturb.normal(pts.shape) * perturb_scale
        allpts = torch.cat([pts, perturbed], dim=1)
        sigma = self.G.sample_mixed(g_params, allpts, ws)["sigma"]
        return loss + (sigma[:, :n] - sigma[:, n:]).abs().mean() \
            * rk.get("density_reg", 0)

    # -- D side -------------------------------------------------------------

    def dmain_loss(self, d_params, g_params, z, c, real_img, real_raw, draws,
                   blur_sigma, blur_size, swapping_prob, neural_res, ada_p):
        """(loss, E[sign(D(real))]); the fakes render without autograd."""
        k_g, k_d1, k_d2 = draws.split(3)
        with torch.no_grad():
            out, _ = self._run_G(g_params, z, c, k_g, swapping_prob,
                                 neural_res)
        gen_logits = self._run_D(d_params, out["image"], out["image_raw"], c,
                                 k_d1, blur_sigma, blur_size, ada_p)
        real_logits = self._run_D(d_params, real_img, real_raw, c, k_d2,
                                  blur_sigma, blur_size, ada_p)
        loss = (F.softplus(gen_logits).mean()
                + F.softplus(-real_logits).mean())
        # Loss/signs/real (loss.py:75) — the ADA controller's input.
        return loss, torch.sign(real_logits).mean().detach()

    def dreg_loss(self, d_params, real_img, real_raw, c, draws, blur_sigma,
                  blur_size, ada_p):
        """R1 penalty on image + raw (loss.py:268-283): the gradient of
        the logits to both images with ``create_graph=True``, so the
        penalty differentiates again to D's weights."""
        img = real_img.detach().requires_grad_(True)
        raw = real_raw.detach().requires_grad_(True)
        logits = self._run_D(d_params, img, raw, c, draws, blur_sigma,
                             blur_size, ada_p)
        g_img, g_raw = torch.autograd.grad(logits.sum(), (img, raw),
                                           create_graph=True)
        r1 = g_img.square().sum(dim=(1, 2, 3)) \
            + g_raw.square().sum(dim=(1, 2, 3))
        return (r1 * (self.cfg.r1_gamma / 2)).mean()

    # -- the step -----------------------------------------------------------

    def train_step(self, state, z, c, real_img, rng, cur_nimg: int,
                   do_greg: bool, do_dreg: bool, ada_p: float = 0.0):
        """One full G+D update of ``state`` in place; returns (state,
        metrics), metrics as 0-d tensors. ``rng``: a ``torch.Generator``
        or a draw source. With the trainer's ``mesh``, ``z``, ``c`` and
        ``real_img`` are this rank's rows, and the metrics are the global
        batch's. The schedules (blur sigma and size, swap
        probability, neural resolution, EMA beta) come from
        ``cur_nimg`` on the host, as the reference computes them per step
        (training_loop.py:280-300)."""
        cfg = self.cfg
        blur_sigma, swapping_prob, neural_res, ema_beta = \
            self._schedules(cur_nimg)
        blur_size = int(np.floor(blur_sigma * 3))
        draws = as_draws(rng, real_img.device)
        if self.mesh is not None and self.mesh.group is not None:
            draws = RowDraws(draws, self.mesh.rank, self.mesh.data)
        k_g, k_greg, k_d, k_dreg = draws.split(4)
        g_params, d_params = state["g_params"], state["d_params"]
        d_frozen = _map(torch.Tensor.detach, d_params)

        real_raw = filtered_resizing(real_img, neural_res, cfg.filter_mode)
        real_raw = _blur(real_raw, blur_sigma, blur_size)

        # G phase (+ lazy Greg at gain = g_reg_interval, loss.py:152,
        # training_loop.py:284).
        g_loss = self.gmain_loss(g_params, d_frozen, z, c, k_g, blur_sigma,
                                 blur_size, swapping_prob, neural_res, ada_p)
        g_grads = _grads(g_loss, g_params)
        metrics = {"g_loss": g_loss.detach()}
        if do_greg:
            greg = self.greg_loss(g_params, z, c, k_greg, swapping_prob)
            gain = float(cfg.g_reg_interval)
            g_grads = [a + gain * b
                       for a, b in zip(g_grads, _grads(greg, g_params))]
            metrics["g_reg"] = greg.detach()
        _apply(state["g_opt"], g_params, mean_grads(self.mesh, g_grads))

        # D phase (+ lazy R1 at gain = d_reg_interval, loss.py:290).
        d_loss, signs_real = self.dmain_loss(
            d_params, g_params, z, c, real_img, real_raw, k_d, blur_sigma,
            blur_size, swapping_prob, neural_res, ada_p)
        d_grads = _grads(d_loss, d_params)
        metrics["d_loss"] = d_loss.detach()
        metrics["signs_real"] = signs_real
        if do_dreg:
            dreg = self.dreg_loss(d_params, real_img, real_raw, c, k_dreg,
                                  blur_sigma, blur_size, ada_p)
            gain = float(cfg.d_reg_interval)
            d_grads = [a + gain * b
                       for a, b in zip(d_grads, _grads(dreg, d_params))]
            metrics["d_reg"] = dreg.detach()
        _apply(state["d_opt"], d_params, mean_grads(self.mesh, d_grads))

        # EMA (training_loop.py:307-317).
        with torch.no_grad():
            for (_, e), (_, p) in zip(_leaves(state["g_ema"]),
                                      _leaves(g_params)):
                e.copy_(p + (e - p) * ema_beta)
        return state, mean_over_ranks(self.mesh, metrics)


def _apply(opt, params, grads):
    """One Adam step of ``opt`` on ``params`` from sanitized ``grads``."""
    for (_, p), g in zip(_leaves(params), grads):
        p.grad = _sanitize(g)
    opt.step()
    opt.zero_grad(set_to_none=True)


def init_train_state(generator, G, d_cfg: DiscriminatorConfig,
                     trainer: GANTrainer, device="cuda"):
    """{'g_params', 'd_params', 'g_ema', 'g_opt', 'd_opt'}: G and D drawn
    from ``generator`` (a CPU ``torch.Generator``) on ``device``, the
    EMA a copy of G, and the two Adams."""
    g_params = _map(lambda t: t.requires_grad_(True),
                    G.init(generator, device=device))
    d_params = _map(lambda t: t.requires_grad_(True),
                    discriminator_init(generator, d_cfg, device=device))
    g_opt, d_opt = trainer.optimizers(g_params, d_params)
    return {"g_params": g_params, "d_params": d_params,
            "g_ema": _map(lambda t: t.detach().clone(), g_params),
            "g_opt": g_opt, "d_opt": d_opt}


def _adam_tree(opt, params):
    """The Adam's moments as trees shaped like ``params``, and its step
    count (0 before the first step)."""
    leaves = list(_leaves(params))
    state = [opt.state.get(t, {}) for _, t in leaves]
    step = state[0].get("step", torch.zeros(()))

    def tree(key):
        out = {}
        for (path, t), s in zip(leaves, state):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = s.get(key, torch.zeros_like(t)).detach()
        return out
    return {"step": torch.as_tensor(step, dtype=torch.float32).reshape(()),
            "exp_avg": tree("exp_avg"), "exp_avg_sq": tree("exp_avg_sq")}


def train_state_tree(state):
    """The train state as one dict of tensors (params, EMA, both Adams'
    moments and step counts), for ``io.checkpoints.save_checkpoint``."""
    return {"g_params": state["g_params"], "d_params": state["d_params"],
            "g_ema": state["g_ema"],
            "g_opt": _adam_tree(state["g_opt"], state["g_params"]),
            "d_opt": _adam_tree(state["d_opt"], state["d_params"])}


def load_train_state(state, tree):
    """Copy a :func:`train_state_tree` into ``state`` in place, Adams
    included; the same bits as the tree."""
    with torch.no_grad():
        for name in ("g_params", "d_params", "g_ema"):
            for (_, dst), (_, src) in zip(_leaves(state[name]),
                                          _leaves(tree[name])):
                dst.copy_(src)
    for opt_name, params in (("g_opt", "g_params"), ("d_opt", "d_params")):
        opt, saved = state[opt_name], tree[opt_name]
        opt.state.clear()
        if float(saved["step"]) == 0:
            continue
        for (_, p), (_, m), (_, v) in zip(_leaves(state[params]),
                                          _leaves(saved["exp_avg"]),
                                          _leaves(saved["exp_avg_sq"])):
            opt.state[p] = {"step": saved["step"].detach().cpu().clone(),
                            "exp_avg": m.to(p.device).clone(),
                            "exp_avg_sq": v.to(p.device).clone()}
    return state
