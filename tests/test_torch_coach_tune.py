"""tgi_torch's ``PTICoach.tune`` against tgi's own ``tune`` (its bounded
``lax.while_loop``, key splitting and step counting), on the CPU at the
tiny config, with tgi's per-step render draws handed to the port. A file
of its own because compiling tgi's tuning loop takes ~40 s on one core.
Tolerances as in ``test_torch_coach.py``."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from tgi.invert.coach import CoachConfig as JCoachConfig
from tgi.invert.coach import PTICoach as JPTICoach
from tgi.losses.lpips import AlexLPIPSLoss as JAlexLPIPSLoss
from tgi_torch.invert.coach import CoachConfig, PTICoach
from tgi_torch.losses.lpips import AlexLPIPSLoss
from tgi_torch.models import alexnet

from torch_helpers import (assert_updates_match, close, leaves_with_paths,
                           render_draws, tiny_camera, tiny_pair)


def test_tune_matches_tgi_tune():
    gj, pj, gt, pt = tiny_pair()
    gen = torch.Generator().manual_seed(7)
    trunk = alexnet.alexnet_init(gen, "cpu")
    head = alexnet.alex_head_init(gen, "cpu")
    lp_j = JAlexLPIPSLoss(*(jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                         tree) for tree in (trunk, head)))
    rng = np.random.RandomState(8)
    ws = (0.5 * rng.randn(1, gt.cfg.num_ws, 32)).astype(np.float32)
    cam = tiny_camera(0.3)
    real = np.tanh(rng.randn(1, 3, 64, 64)).astype(np.float32)
    key = jax.random.PRNGKey(10)
    cj = JPTICoach(gj, lp_j, JCoachConfig(lpips_threshold=0.0))
    tuned_j, info_j = jax.jit(lambda p, k: cj.tune(
        k, p, ws, cam, real, max_steps=3))(pj, key)

    keys = []
    for _ in range(3):
        key, k = jax.random.split(key)
        keys.append(k)
    res = gt.cfg.neural_rendering_resolution
    rk = gt.cfg.rendering_kwargs

    def draws(i):
        return render_draws(keys[i], 1, res * res, rk["depth_resolution"],
                            rk["depth_resolution_importance"])

    coach = PTICoach(gt, AlexLPIPSLoss(trunk, head),
                     CoachConfig(lpips_threshold=0.0))
    args = (torch.from_numpy(ws), torch.from_numpy(cam),
            torch.from_numpy(real))
    tuned, info = coach.tune(pt, *args, max_steps=3, draws=draws)
    # The first step's gradients (the port's; they agree with tgi's to
    # 1e-4, test_torch_coach.py) mark the elements rounding cannot flip.
    leaves = dict(leaves_with_paths(pt))
    for t in leaves.values():
        t.requires_grad_(True)
    jitter, u = draws(0)
    coach._loss(pt, *args, jitter=jitter, u=u)[0].backward()
    grads0 = jax.tree.map(lambda t: np.zeros(t.shape, np.float32)
                          if t.grad is None else t.grad.numpy(), pt)
    for t in leaves.values():
        t.requires_grad_(False)
    assert info["steps"] == int(info_j["steps"]) == 3
    # The last render's LPIPS follows two updates of either package.
    close(np.float32(info["final_lpips"]), info_j["final_lpips"], 1e-5)
    assert_updates_match(tuned, tuned_j, pj, 3, [grads0])
