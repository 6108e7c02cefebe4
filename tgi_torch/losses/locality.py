"""PTI locality ("ball holder") regulariser (twin of
``tgi/losses/locality.py``; parity target
criteria/localitly_regulizer.py:9-60, Space_Regulizer).

z is drawn and mapped to w, the pivot latent is moved toward each sample
by ``alpha`` along the unit direction, and L2 + LPIPS between the
original and the tuned generator's renders there keep the tuning local
around the pivot. As in ``tgi``, the renders use the given camera (the
reference calls ``G.synthesis(w)`` without one, which EG3D's signature
refuses).

The original generator's mapping and render run under
``torch.no_grad()``: its weights are frozen, so they get no gradient
and that render launches no splat on the card. z comes from a
``torch.Generator`` or is given as a tensor (the tests hand it
``tgi``'s draw).

:meth:`SpaceRegularizer.per_image` gives the terms of B images at once
(batched tuning): each image's samples around its own pivot, rendered
by its own tuned copy under its own camera, all B in one render per
sample; the mapping stays on the shared original weights
(``tgi/losses/locality.py:49``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tgi_torch.losses.basic import l2_loss


@dataclass(frozen=True)
class LocalityConfig:
    num_samples: int = 1          # latent_ball_num_of_samples
    alpha: float = 30.0           # regulizer_alpha
    l2_lambda: float = 0.1        # regulizer_l2_lambda
    lpips_lambda: float = 0.1     # regulizer_lpips_lambda


class SpaceRegularizer:
    def __init__(self, G, original_params, lpips_loss, camera=None,
                 cfg: LocalityConfig = LocalityConfig()):
        self.G = G
        self.original_params = original_params
        self.lpips = lpips_loss
        self.camera = camera
        self.cfg = cfg

    @torch.no_grad()
    def _interpolated_ws(self, w_pivot, camera, z):
        """w_pivot + alpha-normalised directions to the mapped samples
        (localitly_regulizer.py:15-22)."""
        cfg = self.cfg
        cam = camera.expand(cfg.num_samples, camera.shape[-1])
        w_samples = self.G.mapping(self.original_params, z, cam,
                                   truncation_psi=0.5)
        direction = w_samples - w_pivot
        norm = torch.linalg.norm(direction, dim=-1, keepdim=True)
        return w_pivot + cfg.alpha * direction / (norm + 1e-8)

    def __call__(self, new_params, w_pivot, *, generator=None, z=None,
                 camera=None):
        """The term for ``new_params`` around ``w_pivot`` [1, num_ws, D].

        ``camera`` overrides the constructor's (``PTICoach`` passes the
        per-image pivot camera, so one regulariser serves every image).
        ``z`` [num_samples, z_dim] is drawn from ``generator`` unless
        given."""
        cfg = self.cfg
        camera = self.camera if camera is None else camera
        if z is None:
            z = torch.randn((cfg.num_samples, self.G.cfg.z_dim),
                            generator=generator, device=w_pivot.device)
        ws = self._interpolated_ws(w_pivot, camera, z.to(w_pivot.device))
        loss = 0.0
        for i in range(cfg.num_samples):
            w = ws[i:i + 1]
            with torch.no_grad():
                old = self.G.synthesis(self.original_params, w, camera,
                                       det=True)["image"]
            new = self.G.synthesis(new_params, w, camera,
                                   det=True)["image"]
            loss = loss + l2_loss(old, new) * cfg.l2_lambda
            loss = loss + (self.lpips.from_unit(old, new).squeeze()
                           * cfg.lpips_lambda)
        return loss / cfg.num_samples

    def per_image(self, new_params, w_pivots, cameras, *, z=None,
                  generators=None):
        """The terms of B images [B]: ``new_params`` carries per-image
        leaves (``models/generator.py::stack_params``), w_pivots is [B,
        num_ws, D], cameras [B, 25], and ``z`` [B, num_samples, z_dim]
        (else image b's drawn from ``generators[b]``). Image b's term is
        ``__call__``'s for its own copy, pivot, camera and z."""
        cfg = self.cfg
        B, S = w_pivots.shape[0], cfg.num_samples
        dev = w_pivots.device
        if z is None:
            gens = generators or [None] * B
            z = torch.stack([torch.randn((S, self.G.cfg.z_dim), generator=g,
                                         device=dev) for g in gens])
        z = z.to(dev)
        with torch.no_grad():
            w_samples = self.G.mapping(
                self.original_params, z.reshape(B * S, -1),
                cameras.repeat_interleave(S, dim=0),
                truncation_psi=0.5).reshape(B, S, *w_pivots.shape[1:])
            direction = w_samples - w_pivots[:, None]
            norm = torch.linalg.norm(direction, dim=-1, keepdim=True)
            ws = w_pivots[:, None] + cfg.alpha * direction / (norm + 1e-8)
        loss = 0.0
        for i in range(S):
            with torch.no_grad():
                old = self.G.synthesis(self.original_params, ws[:, i],
                                       cameras, det=True)["image"]
            new = self.G.synthesis(new_params, ws[:, i], cameras,
                                   det=True)["image"]
            loss = loss + torch.mean(torch.square(old - new),
                                     dim=(1, 2, 3)) * cfg.l2_lambda
            loss = loss + (self.lpips.from_unit(old, new).reshape(B)
                           * cfg.lpips_lambda)
        return loss / S
