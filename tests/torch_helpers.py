"""Helpers shared by the port's parity tests (not a test module)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tgi.ops import grid_sample as jgs
from tgi_torch.ops import grid_sample as gs
from tgi_torch.scripts import frustum_points

from tests.torch_tiny import TINY, TINY_D, TINY_GAN, TINY_RK  # noqa: F401

TOL = 1e-5


def border_coords(H, W, box_warp):
    """World points whose plane-0 (x, y) corners sit on the borders:
    x0 = -1, x0 = W-1, y0 = H-1, y0 = -1, and points outside the box."""
    def world(ix, iy):
        u = (ix + 0.5) * 2.0 / W - 1.0
        v = (iy + 0.5) * 2.0 / H - 1.0
        return [u * box_warp / 2, v * box_warp / 2, 0.0]
    pts = [world(-0.3, 3.2), world(W - 1 + 0.4, 5.7), world(4.1, H - 1 + 0.6),
           world(2.5, -0.8), world(-0.5, -0.5), world(W - 0.5, H - 0.5),
           world(W + 3.0, 2.0), [2.0 * box_warp, -1.5 * box_warp, 0.7]]
    return np.asarray(pts, np.float32)


def ray_coords(N, rays, box_warp):
    """World points ``[N, Ry*Rx*S, 3]`` of a frustum march,
    ``rays = (Ry, Rx, S)``, in the renderer's ray-major order
    (``tgi_torch.scripts.frustum_points`` scaled to ``box_warp``; batch
    entry n is stretched by 1 + 0.05 n): some consecutive samples of a
    ray share a cell on the planes, and the outer rays leave the box."""
    pts = frustum_points(*rays) * (box_warp / 2)
    return np.stack([pts * (1 + 0.05 * n) for n in range(N)]).astype(
        np.float32)


def splat_inputs(seed, N, C, H, W, M, box_warp):
    """(planes [N,3,C,H,W], coords [N,M,3], feature gradient [N,3,M,C])
    from a numpy seed. An int M draws uniform points with the border
    points first; M = (Ry, Rx, S) takes :func:`ray_coords`."""
    rng = np.random.RandomState(seed)
    planes = rng.randn(N, 3, C, H, W).astype(np.float32)
    if isinstance(M, tuple):
        coords = ray_coords(N, M, box_warp)
    else:
        coords = ((rng.rand(N, M, 3) * 1.4 - 0.7) * box_warp).astype(
            np.float32)
        b = border_coords(H, W, box_warp)
        coords[:, :len(b)] = b
    g = rng.randn(N, 3, coords.shape[1], C).astype(np.float32)
    return planes, coords, g


def close(got, want, tol):
    """max|got - want| <= tol * max(1, max|want|)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    scale = max(1.0, np.abs(want).max())
    assert err <= tol * scale, (err, scale)


def port_splat_grads(planes, coords, g, box_warp):
    """(d_planes, d_coords) of the port's sample_triplanes for cotangent g."""
    p = torch.from_numpy(planes).requires_grad_(True)
    c = torch.from_numpy(coords).requires_grad_(True)
    gs.sample_triplanes(p, c, box_warp).backward(torch.from_numpy(g))
    return p.grad, c.grad


def tpu_route_grads(C, M, N=1, H=32, W=32, box_warp=1.0):
    """(port (d_planes, d_coords), tgi's TPU route's) for one input; the
    Pallas kernels run in interpret mode."""
    planes, coords, g = splat_inputs(1, N, C, H, W, M, box_warp)
    fn = jgs._gsp_tpu_for(None)

    def vjp(p, c, g):
        def f(p, c):
            proj = jgs.project_onto_planes((2.0 / box_warp) * c)
            return fn(p.reshape(N * 3, C, H, W),
                      proj.reshape(N * 3, M, 2)).reshape(N, 3, M, C)
        return jax.vjp(f, p, c)[1](g)

    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(vjp)(jnp.asarray(planes), jnp.asarray(coords),
                            jnp.asarray(g))
    return port_splat_grads(planes, coords, g, box_warp), want


def tiny_pair():
    """(tgi generator, its params, port generator, the same params as CPU
    tensors). The weights are the port's own init (the same names,
    shapes and distributions as tgi's, ``test_torch_generator.py``
    checks), carried to tgi as arrays: no JAX init to compile. Noise
    strengths are 0.3 and ``w_avg`` 0.5, so those paths carry signal."""
    from tgi.models import GeneratorConfig as JGeneratorConfig
    from tgi.models import TriPlaneGenerator as JTriPlaneGenerator
    from tgi.models import default_rendering_kwargs as jrk
    from tgi_torch.models.generator import (GeneratorConfig,
                                            TriPlaneGenerator,
                                            default_rendering_kwargs)
    gj = JTriPlaneGenerator(JGeneratorConfig(rendering_kwargs=jrk(**TINY_RK),
                                             **TINY))
    gt = TriPlaneGenerator(GeneratorConfig(
        rendering_kwargs=default_rendering_kwargs(**TINY_RK), **TINY))
    pt = gt.init(torch.Generator().manual_seed(0), device="cpu")
    for path, t in leaves_with_paths(pt):
        if path[-1] == "noise_strength":
            t.fill_(0.3)
    pt["mapping"]["w_avg"].fill_(0.5)
    pj = jax.tree.map(lambda t: jnp.asarray(t.numpy()), pt)
    return gj, pj, gt, pt


def tiny_camera(yaw=0.0):
    """Packed camera [1, 25] (numpy) at ``yaw`` around the FFHQ pivot."""
    from tgi.render import cameras as jcameras
    cam = jcameras.look_at_pose(np.pi / 2 + yaw, np.pi / 2,
                                jnp.asarray([0., 0., 0.2]), radius=2.7)
    return np.array(jcameras.pack_camera(
        cam[None], jcameras.fov_to_intrinsics(18.837)))


def render_draws(key, N, M, D, D_importance):
    """The (jitter, u) that ``tgi``'s ``synthesis(key=key, det=False)``
    draws: its key splits into (backbone, render, SR), the render key
    into (stratified, importance, density noise)
    (``tgi/models/generator.py:185``, ``tgi/render/renderer.py:70``)."""
    _, k_render, _ = jax.random.split(key, 3)
    k_strat, k_imp, _ = jax.random.split(k_render, 3)
    jitter = jax.random.uniform(k_strat, (N, M, D, 1))
    u = jax.random.uniform(k_imp, (N * M, D_importance))
    return (torch.from_numpy(np.array(jitter)),
            torch.from_numpy(np.array(u)))


class _DrawLog:
    """A draw source (``tgi_torch.utils.draws``) that notes each draw's
    place in the key tree: ``path`` is the chain of (n, i) splits from
    the root key. Its draws are ``table``'s, or stand-ins while the
    table is empty."""

    def __init__(self, log, table=None, path=()):
        self.log, self.table, self.path = log, table, path

    def split(self, n):
        return [_DrawLog(self.log, self.table, self.path + ((n, i),))
                for i in range(n)]

    def _draw(self, kind, shape, *extra):
        entry = (self.path, kind, tuple(shape), extra)
        if self.table is not None:
            return self.table[entry]
        self.log.append(entry)
        if kind == "randint":
            return torch.randint(extra[0], extra[1], tuple(shape))
        return torch.rand(tuple(shape))

    def uniform(self, shape):
        return self._draw("uniform", shape)

    def normal(self, shape):
        return self._draw("normal", shape)

    def randint(self, shape, lo, hi):
        return self._draw("randint", shape, lo, hi)


def with_tgi_draws(key, fn):
    """``fn(draws)`` with ``tgi``'s draws from ``key`` given as tensors.

    ``fn`` runs once with stand-in draws to learn where in the key tree
    it draws what (shapes never depend on the values), then again with
    each draw computed by ``jax.random`` from the matching split of
    ``key``, all in one jitted call: an eager ``jax.random`` call
    compiles anew for each shape."""
    log = []
    fn(_DrawLog(log))
    entries = tuple(dict.fromkeys(log))
    values = _draws_fn(entries)(key)
    table = {e: torch.from_numpy(np.array(v)) for e, v in zip(entries,
                                                              values)}
    return fn(_DrawLog(None, table))


_DRAWS_FNS = {}


def _draws_fn(entries):
    """The jitted draws of ``entries`` (one compile per set of entries);
    each split of the key tree is made once, and draws of one kind and
    shape are made together over their stacked keys."""
    if entries in _DRAWS_FNS:
        return _DRAWS_FNS[entries]

    def compute(root):
        keys = {(): root}

        def key_at(path):
            if path not in keys:
                n, i = path[-1]
                keys[path] = jax.random.split(key_at(path[:-1]), n)[i]
            return keys[path]

        groups = {}
        for j, (path, kind, shape, extra) in enumerate(entries):
            groups.setdefault((kind, shape, extra), []).append(j)
        out = [None] * len(entries)
        for (kind, shape, extra), idx in groups.items():
            ks = jnp.stack([key_at(entries[j][0]) for j in idx])
            if kind == "randint":
                vals = jax.vmap(lambda k: jax.random.randint(
                    k, shape, *extra))(ks)
            else:
                draw = getattr(jax.random, kind)
                vals = jax.vmap(lambda k: draw(k, shape))(ks)
            for j, v in zip(idx, vals):
                out[j] = v
        return out

    jitted = jit_ref(compute)

    def run(root):
        vals = jitted(root)
        return [np.array(v).astype(np.int64) if e[1] == "randint"
                else np.array(v) for e, v in zip(entries, vals)]

    _DRAWS_FNS[entries] = run
    return run


def leaves_with_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_paths(v, prefix + (k,))
    else:
        yield prefix, tree


def jit_ref(fn, **jit_kwargs):
    """``jax.jit`` for a reference computation: the same HLO, compiled at
    XLA's backend optimisation level 0, which halves the CPU compile of
    the generator's gradient; the tests compare values, not speed."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0},
                   **jit_kwargs)


def assert_updates_match(tuned, want, start, steps, grads, lr=3e-4,
                         ref_grads=None):
    """Tuned parameters against the reference's, through the update each
    element received (``Δ = tuned - start``).

    Adam moves a weight by about ``lr`` per step whatever the size of its
    gradient, so an element whose gradient sits at the rounding floor may
    step either way in either package. Every element is held within
    ``2 · steps · lr`` (the most Adam moves it). Elements whose gradient
    is sure at every step in ``grads`` (per-step gradient trees of the
    reference; the first step's alone where only it is at hand: three
    steps of lr 3e-4 barely move a gradient), so that the port's error
    cannot change its sign and changes its size little, are held within
    ``2e-2 · steps · lr``, and where their gradient is not zero the
    port's update on them is not zero either:
    at least ``lr / 4`` over one or two steps (Adam's two-step update is
    at least 0.26 · lr, whatever the ratio and signs of the two
    gradients; three steps can cancel).

    Float32 (``ref_grads`` None): sure where the gradient is at least
    1e-2 of the leaf's largest, since the gradients agree to 1e-4 of it
    and a 1e-2 relative error moves Adam's m/sqrt(v) by at most ~2e-2.
    Reduced precision (``ref_grads``: the same steps' float32 gradients
    of the reference): with D = ‖g − g_ref‖∞ over the leaf, the port's
    gradient is held within 2 · D + 2⁻⁷ · max|g_ref| of ``g`` (the bf16
    gradient bound), so an element is sure where
    |g| ≥ 2 · (2 · D + 2⁻⁷ · max|g_ref|): the port's gradient there is
    within half of the reference's and of the same sign. At least ten
    leaves must have sure elements.

    An element whose float32 spacing at its start is not below
    ``lr / 4`` (a BatchNorm variance of ~1e4 under lr 1e-4) cannot take
    Adam's step: its error counts beyond twice that spacing, and it need
    not move. O(1) weights have no such element."""
    start = dict(leaves_with_paths(start))
    got = dict(leaves_with_paths(tuned))
    hist = [dict(leaves_with_paths(g)) for g in grads]
    refs = ([dict(leaves_with_paths(g)) for g in ref_grads]
            if ref_grads is not None else [None] * len(hist))
    moved = held = 0
    for path, w in leaves_with_paths(want):
        d_want = np.asarray(w) - np.asarray(start[path])
        d_got = got[path].numpy() - np.asarray(start[path])
        # Float32 rounds a stored parameter to its spacing: an element of
        # a large leaf (a BatchNorm variance of ~1e4) whose spacing is not
        # below lr / 4 moves in those steps or not at all, so its error is
        # counted beyond two of them. O(1) weights have none such.
        ulp = 2 * np.spacing(np.abs(np.asarray(start[path], np.float32)))
        movable = ulp < lr / 4
        err = np.abs(d_got - d_want)
        err = np.where(movable, err, np.maximum(err - ulp, 0))
        assert err.max() <= 2 * steps * lr, (path, err.max())
        sure = np.ones(d_want.shape, bool)
        live = np.ones(d_want.shape, bool)
        for h, r in zip(hist, refs):
            g = np.asarray(h[path])
            live &= g != 0
            if r is None:
                sure &= np.abs(g) >= 1e-2 * np.abs(g).max()
            else:
                r = np.asarray(r[path])
                floor = 2 * np.abs(g - r).max() + 2.0 ** -7 * np.abs(r).max()
                sure &= (np.abs(g) >= 2 * floor) & (floor > 0)
        assert (err[sure] <= 2e-2 * steps * lr).all(), (path,
                                                        err[sure].max())
        least = lr / 4 if steps <= 2 else 0
        assert (np.abs(d_got[sure & live & movable]) > least).all(), path
        moved += int(np.abs(d_want).max() > 0)
        held += int((sure & live & movable).any())
    assert moved > 10 and held > 10, (moved, held)


def tiny_aux_nets(seed=0, camera_dims=4):
    """Stage 1's auxiliary networks, small: (pose-net params, VGG16
    params, LPIPS head) as CPU tensors, ``width_mult`` 1/8 and one block
    per pose-net stage."""
    from tgi_torch.models import pose_resnet, vgg
    gen = torch.Generator().manual_seed(seed)
    return (pose_resnet.resnet34_init(gen, camera_dims, "cpu",
                                      width_mult=0.125, blocks=(1, 1, 1, 1)),
            vgg.vgg16_init(gen, "cpu", width_mult=0.125),
            vgg.lpips_head_init(gen, "cpu", width_mult=0.125))


# The scale of ``tiny_aux_nets``. The command line checks weight files
# against the full-width nets, as tgi does; a test that hands it the
# small nets names their scale with ``check_aux_at_tiny_scale``.
TINY_AUX = dict(width_mult=0.125, pose_blocks=(1, 1, 1, 1))


def check_aux_at_tiny_scale(monkeypatch):
    """Make ``run_pti``'s weight-file check expect ``tiny_aux_nets``."""
    import functools
    from tgi_torch.apps import run_pti
    monkeypatch.setattr(run_pti, "validate_aux", functools.partial(
        run_pti.validate_aux, **TINY_AUX))


def script_defs(path, **overrides):
    """The imports, functions and constant assignments of a script that
    runs its work at import (``scripts/bench_*.py``), executed in a
    fresh namespace, then ``overrides`` set there (e.g. smaller shapes
    for the functions that read module globals). An assignment is kept
    when it calls nothing and reads only names bound by assignments kept
    before it. The file is only read."""
    import ast
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    keep, bound = [], set()
    for n in tree.body:
        if isinstance(n, (ast.Import, ast.ImportFrom, ast.FunctionDef)):
            keep.append(n)
        elif isinstance(n, ast.Assign):
            nodes = list(ast.walk(n.value))
            reads = {m.id for m in nodes if isinstance(m, ast.Name)}
            if (not any(isinstance(m, ast.Call) for m in nodes)
                    and reads <= bound):
                keep.append(n)
                bound |= {m.id for t in n.targets for m in ast.walk(t)
                          if isinstance(m, ast.Name)}
    ns = {"__name__": "script_defs", "__file__": path}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    ns.update(overrides)
    return ns


def gan_pair(augment=False, **over):
    """(tgi trainer, its G and D params, port trainer, the same params as
    CPU tensors): ``tiny_pair``'s generator, the tiny D drawn by the
    port's init, both trainers with ``AugmentPipe`` where ``augment``
    (it adds ~50 % to the compile of tgi's step)."""
    from tgi.nn.discriminator import DiscriminatorConfig as JD
    from tgi.train import augment as ja
    from tgi.train.gan import GANTrainConfig as JCfg
    from tgi.train.gan import GANTrainer as JTrainer
    from tgi_torch.nn.discriminator import (DiscriminatorConfig,
                                            discriminator_init)
    from tgi_torch.train import augment as ta
    from tgi_torch.train.gan import GANTrainConfig, GANTrainer
    gj, pj, gt, pt = tiny_pair()
    dt = discriminator_init(torch.Generator().manual_seed(1),
                            DiscriminatorConfig(**TINY_D), device="cpu")
    dj = jax.tree.map(lambda t: jnp.asarray(t.numpy()), dt)
    kw = {**TINY_GAN, **over}
    jt = JTrainer(gj, JD(**TINY_D), JCfg(**kw),
                  augment_fn=ja.AugmentPipe() if augment else None)
    tt = GANTrainer(gt, DiscriminatorConfig(**TINY_D), GANTrainConfig(**kw),
                    augment_fn=ta.AugmentPipe() if augment else None)
    return jt, pj, dj, tt, pt, dt


def gan_inputs(N=2, seed=0):
    """(z, c, real images) as numpy: two cameras, images in [-1, 1]."""
    rng = np.random.RandomState(seed)
    z = rng.randn(N, TINY["z_dim"]).astype(np.float32)
    c = np.concatenate([tiny_camera(0.4 * i - 0.2) for i in range(N)])
    real = rng.uniform(-1, 1, (N, 3, 64, 64)).astype(np.float32)
    return z, c.astype(np.float32), real


# tests/test_sg3.py's alias-free generator: 32², 6 layers, 16 channels.
TINY_SG3 = dict(z_dim=16, w_dim=16, img_resolution=32, channel_base=1024,
                channel_max=16, num_layers=6, margin_size=4, num_fp16_res=0)


def sg3_pair(seed=0):
    """(tgi SG3 generator, its params, port SG3 generator, the same params
    as CPU tensors) at TINY_SG3: the port's init, carried to tgi as
    arrays, with the magnitude EMAs moved off 1 so that path carries."""
    from tgi.nn import synthesis3 as j3
    from tgi_torch.nn import synthesis3 as t3
    gt = t3.SG3Generator(t3.SG3Config(**TINY_SG3))
    pt = gt.init(torch.Generator().manual_seed(seed), device="cpu")
    for i in range(TINY_SG3["num_layers"] + 1):
        pt["synthesis"][f"L{i}"]["magnitude_ema"].fill_(1.0 + 0.1 * i)
    gj = j3.SG3Generator(j3.SG3Config(**TINY_SG3))
    pj = jax.tree.map(lambda t: jnp.asarray(t.numpy()), pt)
    return gj, pj, gt, pt


def inception_params(seed, classes):
    """A params tree of the skeleton's shapes: conv weights N(0, 0.05²)
    (above tgi's init's 0.02, so that activations stay O(1) 94 layers
    deep), BN beta/mean N(0, 0.1²), var U(0.5, 1), gamma U(0.8, 1.2),
    and a ``classes``-way head."""
    from tgi_torch.metrics.inception import inception_spec
    rng = np.random.RandomState(seed)

    def node(shape):
        c = shape[0]
        return {"conv": {"weight": rng.randn(*shape).astype(np.float32)
                         * 0.05},
                "bn": {"weight": rng.uniform(0.8, 1.2, c).astype(np.float32),
                       "bias": rng.randn(c).astype(np.float32) * 0.1,
                       "running_mean": rng.randn(c).astype(np.float32)
                       * 0.1,
                       "running_var": rng.uniform(0.5, 1, c).astype(
                           np.float32)}}

    p = {name: node(s) if isinstance(s, tuple) else
         {b: node(bs) for b, bs in s.items()}
         for name, s in inception_spec().items()}
    p["fc"] = {"weight": rng.randn(classes, 2048).astype(np.float32) * 0.01,
               "bias": rng.randn(classes).astype(np.float32) * 0.01}
    return p


def fold_nvidia_bn(sd, eps):
    """An NVIDIA-named state dict with each conv's BatchNorm (``gamma``,
    ``beta``, ``mean``, ``var``) folded at ``eps`` into its ``weight``
    and a ``bias``: the detector's other published layout."""
    out = {}
    for key, v in sd.items():
        prefix, leaf = key.rsplit(".", 1)
        if f"{prefix}.gamma" not in sd:
            out[key] = v
        elif leaf == "weight":
            scale = sd[f"{prefix}.gamma"] * torch.rsqrt(sd[f"{prefix}.var"]
                                                        + eps)
            out[key] = v * scale[:, None, None, None]
            out[f"{prefix}.bias"] = (sd[f"{prefix}.beta"]
                                     - sd[f"{prefix}.mean"] * scale)
    return out
