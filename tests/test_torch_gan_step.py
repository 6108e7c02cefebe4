"""One whole ``train_step`` of the port (Gmain + lazy Greg, Dmain + lazy
R1, both Adams, the EMA) against tgi's ``GANTrainer._step`` with the
same draws, on the CPU in fp32 (one jitted tgi step for the file)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_helpers import (assert_updates_match, gan_inputs, gan_pair,
                                 jit_ref, leaves_with_paths, with_tgi_draws)

CUR_NIMG = 1000


@pytest.fixture(scope="module")
def step():
    from tgi.train.gan import GANTrainer as JTrainer
    from tgi_torch.train import gan
    jt, pj, dj, tt, pt, dt = gan_pair()
    z, c, real = gan_inputs(seed=1)
    key = jax.random.PRNGKey(5)
    _, sp, res, beta = jt._schedules(CUR_NIMG)
    state_j = {"g_params": pj, "d_params": dj, "g_ema": pj,
               "g_opt": jt.g_opt.init(pj), "d_opt": jt.d_opt.init(dj)}
    want, want_m = jit_ref(lambda s, z, c, r, k: JTrainer._step.__wrapped__(
        jt, s, z, c, r, k, jnp.float32(0), jnp.float32(sp),
        jnp.float32(beta), jnp.float32(0), blur_size=0, neural_res=res,
        do_greg=True, do_dreg=True))(state_j, z, c, real, key)

    start = {k: {p: t.clone() for p, t in leaves_with_paths(v)}
             for k, v in (("g", pt), ("d", dt))}
    applied = []
    real_apply = gan._apply

    def record(opt, params, grads):
        applied.append([gan._sanitize(g).clone() for g in grads])
        return real_apply(opt, params, grads)

    def run(draws):
        # Fresh parameters for each pass: the step updates them in place.
        g = gan._map(lambda t: t.clone().requires_grad_(True), pt)
        d = gan._map(lambda t: t.clone().requires_grad_(True), dt)
        g_opt, d_opt = tt.optimizers(g, d)
        state = {"g_params": g, "d_params": d,
                 "g_ema": gan._map(lambda t: t.clone(), pt),
                 "g_opt": g_opt, "d_opt": d_opt}
        applied.clear()
        return tt.train_step(state, torch.from_numpy(z), torch.from_numpy(c),
                             torch.from_numpy(real), draws,
                             cur_nimg=CUR_NIMG, do_greg=True, do_dreg=True)

    gan._apply = record
    try:
        got, got_m = with_tgi_draws(key, run)
    finally:
        gan._apply = real_apply
    return dict(want=want, want_m=want_m, got=got, got_m=got_m, start=start,
                grads=list(applied), tt=tt, beta=beta, pj=pj)


def test_metrics(step):
    """Every metric of the step (g_loss, g_reg, d_loss, signs_real, d_reg)
    within 1e-4 relative."""
    got, want = step["got_m"], step["want_m"]
    assert set(got) == set(want) == {"g_loss", "g_reg", "d_loss",
                                     "signs_real", "d_reg"}
    for k in want:
        w = float(want[k])
        assert abs(float(got[k]) - w) <= 1e-4 * max(1.0, abs(w)), (k, w)


def _tree(params, flat):
    out = {}
    for (path, _), g in zip(leaves_with_paths(params), flat):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = g.numpy()
    return out


@pytest.mark.parametrize("which", ["g", "d"])
def test_updated_params(step, which):
    """The updated G and D against tgi's, through the update each weight
    took (Adam's first step moves a weight by about lr whatever its
    gradient's size). Which elements are sure is read off the gradients
    the port applied, which test_torch_gan.py holds to tgi's phase by
    phase."""
    name = f"{which}_params"
    lr = step["tt"].g_adam[0] if which == "g" else step["tt"].d_adam[0]
    from tgi_torch.train.gan import _map
    got = _map(torch.Tensor.detach, step["got"][name])
    grads = step["grads"][0 if which == "g" else 1]
    start = _tree(got, [t for t in step["start"][which].values()])
    assert_updates_match(got, step["want"][name], start, 1,
                         [_tree(got, grads)], lr=lr)


def test_ema(step):
    """g_ema = p + (e - p) * beta with the updated G; it lags G."""
    beta = step["beta"]
    lr = step["tt"].g_adam[0]
    got = dict(leaves_with_paths(step["got"]["g_ema"]))
    g = dict(leaves_with_paths(step["got"]["g_params"]))
    lag = 0.0
    for path, w in leaves_with_paths(step["want"]["g_ema"]):
        start = np.asarray(dict(leaves_with_paths(step["pj"]))[path])
        err = np.abs(got[path].numpy() - np.asarray(w))
        assert err.max() <= 2 * lr * (1 - beta) + 2 * np.spacing(
            np.abs(start)).max(), path
        lag = max(lag, (g[path].detach() - got[path]).abs().max().item())
    assert 0 < beta < 1 and lag > 0
