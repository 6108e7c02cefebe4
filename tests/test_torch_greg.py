"""The density regulariser's monotonic variants (``reg_type``
"monotonic-detach" and "monotonic-fixed") against tgi's ``greg_loss``,
loss and gradient, on the CPU in fp32 (one jitted tgi computation)."""

import jax
import pytest
import torch

from tests.torch_helpers import (close, gan_inputs, jit_ref,
                                 leaves_with_paths, tiny_pair, TINY_D,
                                 with_tgi_draws)

REG_TYPES = ("monotonic-detach", "monotonic-fixed")


def _trainers(reg_type):
    from dataclasses import replace
    from tgi.nn.discriminator import DiscriminatorConfig as JD
    from tgi.train.gan import GANTrainConfig as JCfg
    from tgi.train.gan import GANTrainer as JTrainer
    from tgi_torch.nn.discriminator import DiscriminatorConfig
    from tgi_torch.train.gan import GANTrainConfig, GANTrainer
    gj, pj, gt, pt = tiny_pair()
    gj.cfg = replace(gj.cfg, rendering_kwargs={**gj.cfg.rendering_kwargs,
                                               "reg_type": reg_type})
    gt.cfg = gt.cfg.with_rendering(reg_type=reg_type)
    kw = dict(batch_size=2, density_reg_samples=24)
    return (JTrainer(gj, JD(**TINY_D), JCfg(**kw)), pj,
            GANTrainer(gt, DiscriminatorConfig(**TINY_D),
                       GANTrainConfig(**kw)), pt)


@pytest.fixture(scope="module")
def ref():
    z, c, _ = gan_inputs(seed=2)
    key = jax.random.PRNGKey(9)
    pairs = {t: _trainers(t) for t in REG_TYPES}

    def both(pj):
        return {t: jax.value_and_grad(pairs[t][0].greg_loss)(pj, z, c, key,
                                                             0.5)
                for t in REG_TYPES}

    want = jit_ref(both)(pairs[REG_TYPES[0]][1])
    return dict(want=want, pairs=pairs, z=torch.from_numpy(z),
                c=torch.from_numpy(c), key=key)


@pytest.mark.parametrize("reg_type", REG_TYPES)
def test_monotonic_greg(ref, reg_type):
    from tgi_torch.train.gan import _grads, _map
    want_loss, want_grads = ref["want"][reg_type]
    tt, pt = ref["pairs"][reg_type][2:]
    g = _map(lambda t: t.clone().requires_grad_(True), pt)
    loss = with_tgi_draws(ref["key"], lambda d: tt.greg_loss(
        g, ref["z"], ref["c"], d, 0.5))
    close(loss, want_loss, 1e-4)
    want = dict(leaves_with_paths(want_grads))
    for (path, _), gr in zip(leaves_with_paths(g), _grads(loss, g)):
        close(gr, want[path], 1e-4)
    assert float(loss.detach()) > 0
