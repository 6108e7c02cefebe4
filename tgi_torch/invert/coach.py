"""Stage-2 pivotal tuning: fine-tune the generator around the pivot (twin
of ``tgi/invert/coach.py``).

Behavioral parity target: training/coaches/base_coach.py:96-126 +
single_id_coach.py:64-77. Loss = L2 + LPIPS on both the 512 image and the
128-resized raw render, plus depth total-variation, with LPIPS-based early
stopping at 0.06.

Each step renders in the generator's precision (bf16 blocks under
``fused_dtype="bfloat16"``, as ``tgi``'s coach does); the parameters,
their gradients and Adam's state stay float32, and the losses read
float32 images.

With a locality regulariser (``losses/locality.py``) its term joins the
loss, rendered under the image's pivot camera.

``tgi`` runs the stage as one bounded ``lax.while_loop``; here it is a
Python loop over one step. ``remat`` recomputes the render in the
backward pass (``torch.utils.checkpoint``, ``tgi``'s ``jax.checkpoint``);
``tgi``'s ``dispatch_chunk`` (a TPU-relay work-around) has no
counterpart.

:meth:`PTICoach.tune_batch` tunes B images at once (``tgi``'s
``tune_batch``, coach.py:189-217): B copies of the generator in one tree
whose every leaf has a leading image axis
(``models/generator.py::stack_params``), all B rendered by one synthesis
call per step. The early stop is per image, as ``tgi``'s lane freeze
(coach.py:133-154): once an image's LPIPS is at or below the threshold,
its weights and Adam moments stay as they are while the others run on.
``torch.optim.Adam`` cannot freeze part of a tensor (a zero gradient
still moves a weight through the first moment), so the batch steps a
masked Adam of the same arithmetic (:class:`MaskedAdam`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from tgi_torch.losses.basic import l2_loss
from tgi_torch.losses.warp import area_downsample, bilinear_resize_nchw


def compute_tv_norm(depth):
    """Squared-difference TV on [1, H, W] depth (base_coach.py:294-305)."""
    v00 = depth[:, :-1, :-1]
    v01 = depth[:, :-1, 1:]
    v10 = depth[:, 1:, :-1]
    return torch.mean((v00 - v01) ** 2 + (v00 - v10) ** 2)


def compute_tv_norm_per_image(depth):
    """:func:`compute_tv_norm` of each image of [B, 1, H, W] -> [B]."""
    v00 = depth[:, :, :-1, :-1]
    v01 = depth[:, :, :-1, 1:]
    v10 = depth[:, :, 1:, :-1]
    return torch.mean((v00 - v01) ** 2 + (v00 - v10) ** 2, dim=(1, 2, 3))


def checkpointed(fn):
    """``fn`` recomputed in the backward pass instead of keeping its
    activations (``torch.utils.checkpoint``, non-reentrant). ``fn`` must
    draw nothing: its draws go in as tensors, since the recompute would
    draw anew from an explicit ``torch.Generator``."""
    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False)
    return run


@dataclass(frozen=True)
class CoachConfig:
    max_pti_steps: int = 400
    pti_learning_rate: float = 3e-4
    pt_l2_lambda: float = 1.0
    pt_lpips_lambda: float = 1.0
    lpips_threshold: float = 0.06
    raw_resolution: int = 128
    # Recompute the render in the backward pass (tgi's remat): one more
    # forward for the activation memory of B generator copies' renders.
    remat: bool = False


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _draw_names(G):
    """The draws a stochastic render of ``G`` takes: the stratified
    jitter and the importance uniforms, and under its rendering kwargs'
    training options the density noise and the random SR noise."""
    rk = G.cfg.rendering_kwargs
    return (("jitter", "u")
            + (("sigma_noise",) if rk.get("density_noise", 0) > 0 else ())
            + (("sr_noise",)
               if rk.get("superresolution_noise_mode", "none") == "random"
               else ()))


def render_draws(G, sources, device):
    """Every draw of one stochastic render of B images, as synthesis
    keywords ({"jitter" [B, M, D, 1], "u" [B * M, D_importance], and
    under the options "sigma_noise" (coarse [B, M * D, 1], fine [B, M *
    D_importance, 1]) and "sr_noise" (``nn/superres.py::
    sr_random_noise`` of B)}) on ``device``. Image b's come from
    ``sources[b]``: a ``torch.Generator`` (None: the global generator of
    ``device``) or a draw source (``utils/draws.py``). Each takes them
    in a one-image render's order (the density normals, shared where
    the two passes have one shape, the jitter, the uniforms, the SR's
    noise), so image b sees the values its own render would; a draw
    source is split as ``tgi``'s synthesis splits its key (backbone,
    render, SR; the render's into stratified, importance, density)."""
    return cat_draws([_one_image_draws(G, s, device) for s in sources])


def _one_image_draws(G, source, device):
    """:func:`render_draws` of one image from ``source``."""
    from tgi_torch.nn.superres import sr_random_noise
    from tgi_torch.render.renderer import density_noise_draws
    from tgi_torch.utils.draws import TorchDraws
    rk = G.cfg.rendering_kwargs
    M = G.cfg.neural_rendering_resolution ** 2
    D, Di = rk["depth_resolution"], rk["depth_resolution_importance"]
    if source is None:
        device = torch.device(device)
        source = (torch.cuda.default_generators[
            device.index if device.index is not None
            else torch.cuda.current_device()]
            if device.type == "cuda" else torch.default_generator)
    if isinstance(source, torch.Generator):
        source = TorchDraws(source, device)
    _, k_render, k_sr = source.split(3)
    k_strat, k_imp, k_density = k_render.split(3)
    names = _draw_names(G)
    out = {}
    if "sigma_noise" in names:
        out["sigma_noise"] = density_noise_draws(
            (1, M * D, 1), (1, M * Di, 1), k_density, device)
    out["jitter"] = k_strat.uniform((1, M, D, 1))
    out["u"] = k_imp.uniform((M, Di))
    if "sr_noise" in names:
        out["sr_noise"] = sr_random_noise(G.cfg.sr_cfg, 1, k_sr)
    return out


def cat_draws(draws):
    """One render's draws of several images (each a :func:`render_draws`
    dict) as those of the batch: every tensor joined on its axis 0."""
    def cat(items):
        first = items[0]
        if isinstance(first, dict):
            return {k: cat([d[k] for d in items]) for k in first}
        if isinstance(first, tuple):
            return tuple(cat(list(z)) for z in zip(*items))
        return torch.cat(items)
    return {k: cat([d[k] for d in draws]) for k in draws[0]}


def as_render_draws(draws):
    """Render draws given as a :func:`render_draws` dict, or the pair
    (jitter, u) alone, as synthesis keywords ({} for None)."""
    if draws is None:
        return {}
    if isinstance(draws, dict):
        return draws
    jitter, u = draws
    return {"jitter": jitter, "u": u}


def complete_draws(G, draws):
    """``draws`` (synthesis keywords), checked to hold every draw of
    ``G``'s render: a render recomputed in the backward pass, or one of
    a batch, must draw nothing of its own."""
    missing = [k for k in _draw_names(G) if draws.get(k) is None]
    if missing:
        raise ValueError(f"the render's draws lack {missing}: under remat "
                         f"and in a batch every draw is given")
    return draws


def _step_draws(given):
    """A ``draws(step)`` item of :meth:`PTICoach.tune` / ``tune_batch``:
    (render draws dict[, z]) or (jitter, u[, z]) -> (render draws,
    z or None)."""
    if isinstance(given[0], dict):
        render, rest = given[0], given[1:]
    else:
        render, rest = as_render_draws(given[:2]), given[2:]
    return render, (rest[0] if rest else None)


class MaskedAdam:
    """Adam over per-image leaves (a leading image axis of B) whose
    update lands only on the images ``step`` is told to move: the others
    keep their weights, moments and step count. Each image's arithmetic
    is ``torch.optim.Adam``'s (betas (0.9, 0.999), eps 1e-8, optax.adam's
    bias correction), with its own step count; the batch keeps its
    shape (masking, not shrinking)."""

    def __init__(self, leaves, lr, betas=(0.9, 0.999), eps=1e-8):
        self.leaves = list(leaves)
        self.lr, self.betas, self.eps = lr, betas, eps
        B = self.leaves[0].shape[0]
        self.m = [torch.zeros_like(p) for p in self.leaves]
        self.v = [torch.zeros_like(p) for p in self.leaves]
        self.t = [0] * B

    @torch.no_grad()
    def step(self, go):
        """One update of the images whose ``go`` (B bools) is true, from
        the leaves' ``.grad``; a leaf without one is skipped, as torch's
        Adam skips it."""
        b1, b2 = self.betas
        self.t = [t + bool(g) for t, g in zip(self.t, go)]
        dev = self.leaves[0].device
        mask = torch.tensor([bool(g) for g in go], device=dev)
        ts = [max(t, 1) for t in self.t]
        step_size = torch.tensor([self.lr / (1 - b1 ** t) for t in ts],
                                 dtype=torch.float32, device=dev)
        bc2_sqrt = torch.tensor([math.sqrt(1 - b2 ** t) for t in ts],
                                dtype=torch.float32, device=dev)
        for p, m, v in zip(self.leaves, self.m, self.v):
            if p.grad is None:
                continue
            shape = (-1,) + (1,) * (p.ndim - 1)
            k = mask.reshape(shape)
            g = p.grad
            m_new = m.lerp(g, 1 - b1)
            v_new = (v * b2).addcmul_(g, g, value=1 - b2)
            denom = (v_new.sqrt() / bc2_sqrt.reshape(shape)).add_(self.eps)
            p_new = p - step_size.reshape(shape) * m_new / denom
            m.copy_(torch.where(k, m_new, m))
            v.copy_(torch.where(k, v_new, v))
            p.copy_(torch.where(k, p_new, p))

    def zero_grad(self):
        for p in self.leaves:
            p.grad = None


class PTICoach:
    """Per-image generator fine-tuning around a fixed (w, camera) pivot."""

    def __init__(self, G, lpips_loss, cfg: CoachConfig = CoachConfig(),
                 locality_regularizer=None):
        self.G = G
        self.lpips = lpips_loss
        self.cfg = cfg
        self.locality_regularizer = locality_regularizer

    def _loss(self, params, w_pivot, camera, real_images, *, generator=None,
              jitter=None, u=None, sigma_noise=None, sr_noise=None,
              locality_z=None):
        """(loss, {"l2", "lpips"}) of one stochastic render (``det=False``)
        whose draws come from ``generator`` or are given as ``jitter``,
        ``u``, ``sigma_noise`` and ``sr_noise`` (see :func:`render_draws`;
        under ``remat`` all or none); the locality regulariser's z
        likewise (``locality_z``)."""
        cfg = self.cfg
        draws = {k: v for k, v in (("jitter", jitter), ("u", u),
                                   ("sigma_noise", sigma_noise),
                                   ("sr_noise", sr_noise)) if v is not None}
        if cfg.remat:
            draws = complete_draws(self.G, draws or render_draws(
                self.G, [generator], w_pivot.device))
        out = self._render(params, w_pivot, camera, draws, generator)
        R = cfg.raw_resolution
        if real_images.shape[-1] > R:
            real_raw = area_downsample(real_images, R)
        elif real_images.shape[-1] < R:
            real_raw = bilinear_resize_nchw(real_images, R)
        else:
            real_raw = real_images
        gen_raw = out["image_raw"]
        if gen_raw.shape[-1] != R:
            gen_raw = bilinear_resize_nchw(gen_raw, R)

        l2_val = l2_loss(out["image"], real_images) + l2_loss(gen_raw,
                                                              real_raw)
        lp = (self.lpips.from_unit(out["image"], real_images)
              + self.lpips.from_unit(gen_raw, real_raw)).squeeze()
        loss = l2_val * cfg.pt_l2_lambda + lp * cfg.pt_lpips_lambda
        if self.locality_regularizer is not None:
            loss = loss + self.locality_regularizer(
                params, w_pivot, generator=generator, z=locality_z,
                camera=camera)
        loss = loss + compute_tv_norm(out["image_depth"][0])
        return loss, {"l2": l2_val, "lpips": lp}

    def _render(self, params, ws, camera, draws, generator=None):
        """One stochastic render with the given ``draws`` (synthesis
        keywords; the rest from ``generator``), recomputed in the
        backward pass under ``remat``."""
        def render(params, ws, camera, draws):
            return self.G.synthesis(params, ws, camera, noise_mode="const",
                                    det=False, generator=generator, **draws)
        if self.cfg.remat:
            render = checkpointed(render)
        return render(params, ws, camera, draws)

    def tune(self, params, w_pivot, camera, real_images, *, generator=None,
             draws=None, max_steps=None, checkpoint_fn=None):
        """Run PTI; returns (tuned_params, {"steps", "final_lpips",
        "losses"}).

        Adam (lr ``pti_learning_rate``, betas (0.9, 0.999), eps 1e-8, as
        ``optax.adam``) over every leaf of ``params`` — the leaves
        ``jax.grad`` differentiates in ``tgi``, ``noise_const`` and
        ``w_avg`` included. ``params`` is not changed; the tuned copy is
        returned detached.

        real_images: [1, 3, R, R] in [-1, 1]. The LPIPS threshold is
        checked before the update, as single_id_coach.py:69-73 does: a
        step whose LPIPS is at or below it applies no update and ends the
        loop. ``steps`` counts applied updates; ``final_lpips`` is the
        LPIPS of the last render; ``losses`` the loss of every render, as
        floats.

        The render's draws come from ``generator`` (a torch.Generator), or
        from ``draws(step) -> (jitter, u)`` or ``(render draws)`` (a
        :func:`render_draws` dict) when given, and then the locality
        regulariser's z from the item after them where there is one.
        ``checkpoint_fn(step, params)`` fires after every applied update
        with the count of updates so far.
        """
        cfg = self.cfg
        max_steps = cfg.max_pti_steps if max_steps is None else max_steps
        w_pivot = w_pivot[:, :self.G.cfg.num_ws, :]
        camera = camera[:, :25]
        params = _map(lambda t: t.detach().clone().requires_grad_(True),
                      params)
        opt = torch.optim.Adam(list(_leaves(params)),
                               lr=cfg.pti_learning_rate, betas=(0.9, 0.999),
                               eps=1e-8)
        steps = 0
        lp = float("inf")
        losses = []
        for i in range(max_steps):
            step_draws, z = (_step_draws(draws(i)) if draws is not None
                             else ({}, None))
            loss, aux = self._loss(params, w_pivot, camera, real_images,
                                   generator=generator, locality_z=z,
                                   **step_draws)
            lp = float(aux["lpips"].detach())
            losses.append(float(loss.detach()))
            if not lp > cfg.lpips_threshold:
                break
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            steps += 1
            if checkpoint_fn is not None:
                checkpoint_fn(steps, params)
        return (_map(lambda t: t.detach(), params),
                {"steps": steps, "final_lpips": lp, "losses": losses})

    # -- batched tuning -----------------------------------------------------

    def _loss_batch(self, params, w_pivots, cameras, real_images, draws,
                    locality_z=None):
        """(per-image losses [B], {"l2", "lpips": [B] each}): :meth:`_loss`
        of B images at once, each with its own generator copy in
        ``params`` (every leaf per image), w_pivots [B, num_ws, D],
        cameras [B, 25], real_images [B, 3, R, R]; one render of all B
        with ``draws``, every draw of the B images' render (a
        :func:`render_draws` dict, or (jitter, u) where the render takes
        no other)."""
        cfg = self.cfg
        B = w_pivots.shape[0]
        out = self._render(params, w_pivots, cameras, complete_draws(
            self.G, as_render_draws(draws)))
        R = cfg.raw_resolution
        if real_images.shape[-1] > R:
            real_raw = area_downsample(real_images, R)
        elif real_images.shape[-1] < R:
            real_raw = bilinear_resize_nchw(real_images, R)
        else:
            real_raw = real_images
        gen_raw = out["image_raw"]
        if gen_raw.shape[-1] != R:
            gen_raw = bilinear_resize_nchw(gen_raw, R)

        def l2(a, b):
            return torch.mean(torch.square(a - b), dim=(1, 2, 3))

        l2_val = l2(out["image"], real_images) + l2(gen_raw, real_raw)
        lp = (self.lpips.from_unit(out["image"], real_images)
              + self.lpips.from_unit(gen_raw, real_raw)).reshape(B)
        loss = l2_val * cfg.pt_l2_lambda + lp * cfg.pt_lpips_lambda
        if self.locality_regularizer is not None:
            loss = loss + self.locality_regularizer.per_image(
                params, w_pivots, cameras, z=locality_z)
        loss = loss + compute_tv_norm_per_image(out["image_depth"])
        return loss, {"l2": l2_val, "lpips": lp}

    def tune_batch(self, params, w_pivots, cameras, real_images, *,
                   generators=None, draws=None, max_steps=None):
        """Tune B images at once; returns (the tuned tree, every leaf with
        a leading B, {"steps": [B], "final_lpips": [B], "losses": [steps,
        B]}).

        ``params``: the shared generator (each image starts from it);
        w_pivots [B, 1, num_ws, D], cameras [B, 1, 25], real_images [B, 1,
        3, R, R] in [-1, 1] (the leading 1s may be left out). Image b
        equals ``tune`` on its own inputs up to reassociation: its LPIPS
        is checked before its update, and once at or below the threshold
        its weights and moments stay put while the loop runs on until
        every image has stopped or ``max_steps`` is reached. ``steps``
        counts each image's applied updates, ``final_lpips`` is the LPIPS
        of its last render, ``losses`` row i holds step i's losses, NaN
        for an image stopped before it, and ``adam`` is the
        :class:`MaskedAdam` with each image's moments and step count.

        Image b draws from ``generators[b]`` what ``tune`` draws from its
        generator (every draw of the render, then the locality
        regulariser's z), or every image's draws come from ``draws(step)
        -> (render draws[, z [B, num_samples, z_dim]])``, the render's
        as a :func:`render_draws` dict of the B images or as (jitter [B,
        M, D, 1], u [B * M, D_importance]) where it takes no other.
        """
        cfg = self.cfg
        max_steps = cfg.max_pti_steps if max_steps is None else max_steps
        B = w_pivots.shape[0]
        w_pivots = w_pivots.reshape(B, -1, w_pivots.shape[-1])[
            :, :self.G.cfg.num_ws]
        cameras = cameras.reshape(B, -1)[:, :25]
        real_images = real_images.reshape(B, *real_images.shape[-3:])
        dev = w_pivots.device
        gens = list(generators) if generators is not None else [None] * B
        from tgi_torch.models.generator import stack_params
        params = _map(lambda t: t.requires_grad_(True),
                      stack_params(params, B))
        opt = MaskedAdam(_leaves(params), cfg.pti_learning_rate)
        alive = [True] * B
        steps = [0] * B
        lp = [float("inf")] * B
        losses = []
        n_z = (self.locality_regularizer.cfg.num_samples
               if self.locality_regularizer is not None else 0)
        for i in range(max_steps):
            if draws is not None:
                step_draws, z = _step_draws(draws(i))
            else:
                rd, zs = [], []
                for g in gens:         # each image's draws in tune's order
                    rd.append(render_draws(self.G, [g], dev))
                    if n_z:
                        zs.append(torch.randn((n_z, self.G.cfg.z_dim),
                                              generator=g, device=dev))
                step_draws = cat_draws(rd)
                z = torch.stack(zs).to(dev) if n_z else None
            loss, aux = self._loss_batch(params, w_pivots, cameras,
                                         real_images, step_draws,
                                         locality_z=z)
            lp_now = aux["lpips"].detach().cpu().tolist()
            loss_now = loss.detach().cpu().tolist()
            losses.append([loss_now[b] if alive[b] else float("nan")
                           for b in range(B)])
            for b in range(B):
                if alive[b]:
                    lp[b] = lp_now[b]
            alive = [alive[b] and lp_now[b] > cfg.lpips_threshold
                     for b in range(B)]
            if not any(alive):
                break
            opt.zero_grad()
            go = torch.tensor(alive, dtype=loss.dtype, device=dev)
            (loss * go).sum().backward()
            opt.step(alive)
            steps = [s + a for s, a in zip(steps, alive)]
        return (_map(lambda t: t.detach(), params),
                {"steps": steps, "final_lpips": lp,
                 "losses": torch.tensor(losses).reshape(-1, B),
                 "adam": opt})
