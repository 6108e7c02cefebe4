"""tgi_torch.parallel's mesh and ray-split render (twin of
tests/test_parallel.py), on the CPU in one process.

The rays axis is a list of devices inside one process; here it is the
CPU named 2 or 4 times, which runs the split code (cut, per-chunk render,
concatenation, autograd across the pieces) on one device. The split
render is held against ``tgi``'s unsharded ``importance_render`` on the
same weights and draws, forward and backward (gradients to the planes
and the decoder), at tests/test_parallel.py's tolerances: rtol 2e-4,
atol 2e-5 for the render, rtol 5e-4, atol 1e-5 for the gradients. Against
the port's own unsharded render the split is held to 1e-6 of the largest
value (at least 1): the same formulas on fewer rays at a time, where the
gradients' sums over rays reassociate. The data axis across processes is
tests/test_torch_parallel_train.py's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_tiny import port_camera, port_generator
from tgi.render import maths as jmaths
from tgi.render import rays as jrays
from tgi.render.decoder import osg_decoder_init as josg_init
from tgi.render.renderer import importance_render as jimportance_render
from tgi_torch.io.from_jax import params_from_numpy
from tgi_torch.models.generator import default_rendering_kwargs
from tgi_torch.parallel import (constrain_ray_axis, data_sharding,
                                make_mesh, ray_constrained, ray_sharding,
                                replicate, shard_batch)
from tgi_torch.render import renderer


def cpu_mesh(rays):
    return make_mesh(devices=["cpu"] * rays, rays=rays)


def test_make_mesh_axes():
    """tgi's axes and assert; the data axis is the process group's ranks
    (one without a group)."""
    assert make_mesh().shape == {"data": 1, "rays": 1}
    assert cpu_mesh(4).shape == {"data": 1, "rays": 4}
    assert make_mesh(2, devices=["cpu"] * 4, rays=2).shape == {"data": 1,
                                                               "rays": 2}
    assert make_mesh(data=1, devices=["cpu"]).shape == {"data": 1,
                                                        "rays": 1}
    with pytest.raises(AssertionError):
        make_mesh(devices=["cpu"] * 3, rays=2)
    with pytest.raises(ValueError, match="data axis"):
        make_mesh(data=2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="data axis"):
        make_mesh(devices=["cpu"] * 2)


def test_shard_batch_replicate_and_shardings():
    """Without a process group: every row is the rank's, replicate keeps
    the values; the specs are tgi's P("data", None) and P(None, "rays",
    None); a ray sharding cuts axis 1 into contiguous chunks."""
    mesh = cpu_mesh(2)
    x = torch.arange(8 * 4.0).reshape(8, 4)
    got = shard_batch(mesh, {"x": x, "n": x.numpy()})
    assert torch.equal(got["x"], x) and np.array_equal(got["n"], x.numpy())
    w = torch.ones(3, requires_grad=True)
    assert replicate(mesh, {"w": w})["w"] is w and torch.equal(
        w.detach(), torch.ones(3))
    assert data_sharding(mesh, 2).spec == ("data", None)
    assert ray_sharding(mesh).spec == (None, "rays", None)
    parts = ray_sharding(mesh, axis=1, ndim=2).split(x)
    assert [tuple(p.shape) for p in parts] == [(8, 2), (8, 2)]
    assert torch.equal(torch.cat(parts, dim=1), x)


def test_constrain_ray_axis_only_inside_and_where_it_divides():
    x = torch.zeros(1, 12, 3)
    assert len(constrain_ray_axis(x)) == 1
    with ray_constrained(cpu_mesh(4)):
        assert [p.shape[1] for p in constrain_ray_axis(x)] == [3] * 4
        assert len(constrain_ray_axis(torch.zeros(1, 10, 3))) == 1
        with ray_constrained(cpu_mesh(1)):
            assert len(constrain_ray_axis(x)) == 1
        assert len(constrain_ray_axis(x)) == 4
    assert len(constrain_ray_axis(x)) == 1


def _setup(fov, auto, C=8, res=8, seed=7):
    rng = np.random.RandomState(seed)
    planes = rng.randn(1, 3, C, 16, 16).astype(np.float32)
    dec = jax.tree.map(np.asarray, josg_init(jax.random.PRNGKey(seed), C,
                                             output_dim=C))
    opts = default_rendering_kwargs(depth_resolution=8,
                                    depth_resolution_importance=8)
    if auto:
        opts.update(ray_start="auto", ray_end="auto")
    from tgi.render import cameras as jcameras
    cam = jcameras.look_at_pose(np.pi / 2 + 0.3, np.pi / 2,
                                jnp.asarray([0., 0., 0.2]), radius=2.7)
    c = np.asarray(jcameras.pack_camera(cam[None],
                                        jcameras.fov_to_intrinsics(fov)))
    o, d = jrays.ray_sampler(jnp.asarray(c[:, :16].reshape(-1, 4, 4)),
                             jnp.asarray(c[:, 16:].reshape(-1, 3, 3)), res)
    return planes, dec, opts, o, d


def _loss_j(opts, det):
    def loss(planes, dec, o, d, key):
        rgb, depth, wsum = jimportance_render(planes, dec, o, d, opts,
                                              key=key, det=det)
        return jnp.sum(rgb ** 2) + jnp.sum(jnp.sin(depth)), (rgb, depth,
                                                             wsum)
    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))


def _draws(key, M, S, Si):
    """tgi's renderer's jitter and importance uniforms for ``key``
    (tgi/render/renderer.py:70's split)."""
    k_strat, k_imp, _ = jax.random.split(key, 3)
    return (torch.from_numpy(np.array(jax.random.uniform(k_strat,
                                                         (1, M, S, 1)))),
            torch.from_numpy(np.array(jax.random.uniform(k_imp,
                                                         (M, Si)))))


@pytest.mark.parametrize("rays,fov,auto,det", [
    (2, 18.837, False, True),
    (4, 40.0, True, False),     # corner rays miss the box: the auto limits
    (3, 18.837, False, True),   # 64 rays do not divide over 3: no split
])
def test_ray_split_render_matches_tgi(rays, fov, auto, det):
    """The split render and its backward against tgi's unsharded one,
    and against the port's own unsharded render; the run_model calls
    count the pieces (two passes each)."""
    planes, dec, opts, o, d = _setup(fov, auto)
    if auto:
        smin, smax = jmaths.get_ray_limits_box(o, d, 1.0)
        valid = np.asarray(smax > smin)[0, :, 0]
        assert valid.any() and not valid.all()
        # A chunk's own min/max of its valid rays would fill its missed
        # rays with other limits than the whole batch's.
        start = np.asarray(smin)[0, :, 0]
        lo, hi = start[valid].min(), start[valid].max()
        assert any(not valid[c].all() and (
            not valid[c].any() or start[c][valid[c]].min() != lo
            or start[c][valid[c]].max() != hi)
            for c in np.split(np.arange(valid.size), rays))
    key = jax.random.PRNGKey(11)
    (_, want), want_g = _loss_j(opts, det)(jnp.asarray(planes),
                                           jax.tree.map(jnp.asarray, dec),
                                           o, d, key)
    jitter, u = (None, None) if det else _draws(key, o.shape[1], 8, 8)

    def port(split):
        p = torch.tensor(planes, requires_grad=True)
        dp = {k: {n: t.requires_grad_(True) for n, t in v.items()}
              for k, v in params_from_numpy(dec, "cpu").items()}
        calls = []
        real = renderer.run_model

        def counted(*a, **kw):
            calls.append(1)
            return real(*a, **kw)

        renderer.run_model = counted
        try:
            if split:
                with ray_constrained(cpu_mesh(rays)):
                    out = renderer.importance_render(
                        p, dp, torch.tensor(np.asarray(o)),
                        torch.tensor(np.asarray(d)), opts, det=det,
                        jitter=jitter, u=u)
            else:
                out = renderer.importance_render(
                    p, dp, torch.tensor(np.asarray(o)),
                    torch.tensor(np.asarray(d)), opts, det=det,
                    jitter=jitter, u=u)
        finally:
            renderer.run_model = real
        loss = (out[0] ** 2).sum() + torch.sin(out[1]).sum()
        grads = torch.autograd.grad(loss, [p] + [t for v in dp.values()
                                                 for t in v.values()])
        return [t.detach() for t in out], grads, len(calls)

    got, got_g, n_calls = port(split=True)
    assert n_calls == 2 * (rays if o.shape[1] % rays == 0 else 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-5)
    order = [(k, n) for k, v in params_from_numpy(dec, "cpu").items()
             for n in v]
    want_leaves = [want_g[0]] + [want_g[1][k][n] for k, n in order]
    got_leaves = [got_g[0]] + list(got_g[1:])
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4,
                                   atol=1e-5)
    whole, whole_g, _ = port(split=False)
    for g, w in zip(got + list(got_g), whole + list(whole_g)):
        assert (g - w).abs().max() <= 1e-6 * max(1.0, w.abs().max())


def test_ray_split_draws_follow_the_unsharded_render():
    """Stochastic draws from one generator: the split render draws the
    unsharded render's jitter and uniforms (and density noise) in its
    order and cuts them with the rays."""
    planes, dec, opts, o, d = _setup(18.837, False)
    opts = dict(opts, density_noise=0.5)
    args = (torch.tensor(planes), params_from_numpy(dec, "cpu"),
            torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d)), opts)
    whole = renderer.importance_render(
        *args, det=False, generator=torch.Generator().manual_seed(3))
    with ray_constrained(cpu_mesh(4)):
        split = renderer.importance_render(
            *args, det=False, generator=torch.Generator().manual_seed(3))
    for g, w in zip(split, whole):
        assert (g - w).abs().max() <= 1e-6


def test_ray_constrained_synthesis_matches_unsharded():
    """A whole synthesis (backbone, split render, SR) under
    ``ray_constrained`` against the unsharded one, image and gradient to
    ws (the port's unsharded synthesis is held against tgi by
    tests/test_torch_generator.py)."""
    G, params = port_generator()
    c = port_camera([0.2, -0.3])
    ws0 = torch.full((2, G.cfg.num_ws, 32), 0.1)

    def run():
        ws = ws0.clone().requires_grad_(True)
        out = G.synthesis(params, ws, c)
        g, = torch.autograd.grad((out["image"] ** 2).sum(), ws)
        return out["image"].detach(), out["image_depth"].detach(), g

    want = run()
    with ray_constrained(cpu_mesh(2)):
        got = run()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-4,
                                   atol=2e-5)
