"""Per-image weights through the port's layers, on the CPU at small sizes.

A leaf with a leading image axis carries one copy per image
(``tgi_torch/nn/layers.py``). For B = 3 drawn copies, each layer of the
batched inversion's path called once on the stacked tree is held
against

* the same port layer called on each image with its own copy, and
* tgi's ``jax.vmap`` of the same layer over the copies (one jitted
  function computes every tgi output of the file);

for the linear layer (2-D and 3-D inputs, lr multiplier), the conv layer
(plain, up, down), the modulated conv (plain, up, down, without
demodulation, with per-image noise), ``bias_act`` with a ``[B, C]``
bias, the synthesis layer (per-image ``noise_const`` and
``noise_strength``), ToRGB, the synthesis block (with and without its
const input), the OSG decoder and the pose ResNet. Then the tiny
generator (backbone, render and SR) with every leaf per image, and with
only its noise buffers per image, against per-image renders, gradients
included; and ``stack_params`` / ``take_image``.

Tolerances: float32 outputs within 1e-5 of the largest value per output
(the grouped conv and the batched matmul sum in another order);
gradients through the whole render within 1e-4 (as
``test_torch_gradients.py``); the bfloat16 grouped modulated conv within
3e-2 of its float32 result (bf16 keeps 8 bits).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tgi.models import pose_resnet as jpose
from tgi.nn import layers as jlayers
from tgi.nn import synthesis as jsyn
from tgi.ops.bias_act import bias_act as jbias_act
from tgi.render import decoder as jdecoder
from tgi_torch.models import pose_resnet
from tgi_torch.models.generator import stack_params, take_image
from tgi_torch.nn import layers, synthesis
from tgi_torch.ops.bias_act import bias_act
from tgi_torch.render import decoder

from torch_helpers import jit_ref, leaves_with_paths, tiny_camera, tiny_pair

B = 3
I, O, H = 6, 5, 8


def _rng(seed):
    return np.random.RandomState(seed)


def _stack(trees):
    return pose_resnet.stack_nets(trees)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _layer_copies(init, seed):
    """B copies of a layer's tree drawn by the port's init, every bias
    and noise strength moved off its init constant."""
    gen = torch.Generator().manual_seed(seed)
    rng = _rng(seed)
    out = []
    for _ in range(B):
        t = init(gen)
        for path, v in leaves_with_paths(t):
            if path[-1] in ("bias", "noise_strength"):
                v.copy_(torch.from_numpy(np.asarray(
                    rng.randn(*v.shape) * 0.3, np.float32)))
        out.append(t)
    return out


# name -> (port tree builder, input builder, port apply, tgi apply); the
# applies take one tree and a batch of inputs.
def _cases():
    filt_t = synthesis.RESAMPLE_FILTER
    filt_j = jsyn.RESAMPLE_FILTER

    def fc_init(i):
        return lambda g: layers.fully_connected_init(g, I, O, device="cpu")

    def conv_init(g):
        return layers.conv2d_layer_init(g, I, O, 3, device="cpu")

    def mod_init(g):
        return {"weight": layers.randn(g, (O, I, 3, 3), "cpu")}

    def syn_init(g):
        return synthesis.synthesis_layer_init(g, I, O, 4, H, device="cpu")

    def rgb_init(g):
        return synthesis.torgb_layer_init(g, I, 3, 4, device="cpu")

    def block_init(in_c):
        return lambda g: synthesis.synthesis_block_init(
            g, in_c, O, 4, H, 3, device="cpu")

    def dec_init(g):
        return decoder.osg_decoder_init(g, 4, hidden_dim=7, output_dim=4,
                                        device="cpu")

    def pose_init(g):
        return pose_resnet.resnet34_init(g, 4, "cpu", width_mult=0.0625,
                                         blocks=(1, 1, 1, 1))

    def x(shape):
        return lambda r: r.randn(*shape).astype(np.float32)

    def modconv(up, down, demod, noise):
        def t(p, xs, mod):
            return layers.modulated_conv2d(
                xs, p["weight"], mod[0], noise=mod[1] if noise else None,
                up=up, down=down, padding=1, demodulate=demod,
                resample_filter=filt_t if up > 1 or down > 1 else None,
                flip_weight=(up == 1))

        def j(p, xs, mod):
            return jlayers.modulated_conv2d(
                xs, p["weight"], mod[0], noise=mod[1] if noise else None,
                up=up, down=down, padding=1, demodulate=demod,
                resample_filter=filt_j if up > 1 or down > 1 else None,
                flip_weight=(up == 1))
        return t, j

    def mod_in(r):
        return (r.randn(B, 1, I).astype(np.float32),
                r.randn(B, 1, 1, H, H).astype(np.float32))

    cases = {
        "fc": (fc_init(0), x((B, 1, I)),
               lambda p, xs, _: layers.fully_connected_apply(
                   p, xs, activation="lrelu"),
               lambda p, xs, _: jlayers.fully_connected_apply(
                   p, xs, activation="lrelu")),
        "fc_rows_lrmul": (fc_init(1), x((B, 9, I)),
                          lambda p, xs, _: layers.fully_connected_apply(
                              p, xs, lr_multiplier=0.01),
                          lambda p, xs, _: jlayers.fully_connected_apply(
                              p, xs, lr_multiplier=0.01)),
        "conv2d": (conv_init, x((B, 1, I, H, H)),
                   lambda p, xs, _: layers.conv2d_layer_apply(
                       p, xs, activation="lrelu"),
                   lambda p, xs, _: jlayers.conv2d_layer_apply(
                       p, xs, activation="lrelu")),
        "conv2d_up": (conv_init, x((B, 1, I, H, H)),
                      lambda p, xs, _: layers.conv2d_layer_apply(
                          p, xs, up=2),
                      lambda p, xs, _: jlayers.conv2d_layer_apply(
                          p, xs, up=2)),
        "conv2d_down": (conv_init, x((B, 1, I, H, H)),
                        lambda p, xs, _: layers.conv2d_layer_apply(
                            p, xs, activation="lrelu", down=2),
                        lambda p, xs, _: jlayers.conv2d_layer_apply(
                            p, xs, activation="lrelu", down=2)),
    }
    for name, args in (("modconv", (1, 1, True, True)),
                       ("modconv_up", (2, 1, True, False)),
                       ("modconv_down", (1, 2, True, False)),
                       ("modconv_nodemod", (1, 1, False, True))):
        t, j = modconv(*args)
        cases[name] = (mod_init, x((B, 1, I, H, H)), t, j)
    cases.update({
        "synthesis_layer": (syn_init, x((B, 1, I, H // 2, H // 2)),
                            lambda p, xs, w: synthesis.synthesis_layer_apply(
                                p, xs, w, up=2, conv_clamp=256),
                            lambda p, xs, w: jsyn.synthesis_layer_apply(
                                p, xs, w, resolution=H, up=2,
                                conv_clamp=256)),
        "torgb": (rgb_init, x((B, 1, I, H, H)),
                  lambda p, xs, w: synthesis.torgb_layer_apply(p, xs, w),
                  lambda p, xs, w: jsyn.torgb_layer_apply(p, xs, w)),
        "block": (block_init(I), x((B, 1, I, H // 2, H // 2)),
                  lambda p, xs, w: torch.cat(synthesis.synthesis_block_apply(
                      p, xs, xs[:, :3], w, in_channels=I), 1),
                  lambda p, xs, w: jnp.concatenate(jsyn.synthesis_block_apply(
                      p, xs, xs[:, :3], w, in_channels=I, resolution=H,
                      fused_dtype="float32"), 1)),
        "block_const": (block_init(0), x((B, 1, 1, 1, 1)),
                        lambda p, xs, w: torch.cat(
                            synthesis.synthesis_block_apply(
                                p, None, None, w, in_channels=0), 1),
                        lambda p, xs, w: jnp.concatenate(
                            jsyn.synthesis_block_apply(
                                p, None, None, w, in_channels=0,
                                resolution=H, fused_dtype="float32"), 1)),
        "decoder": (dec_init, x((B, 1, 3, 11, 4)),
                    lambda p, xs, _: torch.cat(list(
                        decoder.osg_decoder_apply(p, xs).values()), -1),
                    lambda p, xs, _: jnp.concatenate(list(
                        jdecoder.osg_decoder_apply(p, xs).values()), -1)),
        "pose": (pose_init, lambda r: (r.rand(B, 1, 3, 32, 32) * 2 - 1)
                 .astype(np.float32),
                 lambda p, xs, _: pose_resnet.resnet34_apply(p, xs),
                 lambda p, xs, _: jpose.resnet34_apply(p, xs)),
    })
    return cases, mod_in


CASES, MOD_IN = _cases()
# Per-case extra input: styles and noise for the modulated conv, ws for
# the synthesis layers.
WS_SHAPES = {"synthesis_layer": (B, 1, 4), "torgb": (B, 1, 4),
             "block": (B, 1, 3, 4), "block_const": (B, 1, 2, 4)}


def _extra(name, r):
    if name.startswith("modconv"):
        return MOD_IN(r)
    if name in WS_SHAPES:
        return r.randn(*WS_SHAPES[name]).astype(np.float32)
    return None


@pytest.fixture(scope="module")
def data():
    inputs = {}
    for k, (name, (init, xin, _, _)) in enumerate(sorted(CASES.items())):
        r = _rng(100 + k)
        inputs[name] = (_layer_copies(init, 200 + k), xin(r),
                        _extra(name, r))

    def tgi_all(trees, xs, extras):
        out = {}
        for name, (_, _, _, japply) in CASES.items():
            out[name] = jax.vmap(japply)(trees[name], xs[name],
                                         extras[name])
        return out

    trees = {n: jax.tree.map(jnp.asarray, _np(_stack(v[0])))
             for n, v in inputs.items()}
    xs = {n: jnp.asarray(v[1]) for n, v in inputs.items()}
    extras = {n: jax.tree.map(jnp.asarray, v[2]) for n, v in inputs.items()}
    want = jit_ref(tgi_all)(trees, xs, extras)
    return inputs, {n: np.asarray(v) for n, v in want.items()}


def _rel(got, want, tol, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (name, err)


def _t(a):
    if a is None:
        return None
    if isinstance(a, tuple):
        return tuple(torch.from_numpy(v) for v in a)
    return torch.from_numpy(a)


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_with_per_image_leaves(data, name):
    """One call on B stacked copies = B one-image calls = tgi's vmap."""
    inputs, want = data
    copies, x, extra = inputs[name]
    _, _, apply, _ = CASES[name]
    extra_t = _t(extra)
    # One image per copy: the lane axis becomes the batch axis. The rows
    # case keeps it: copy b maps its own 9 rows.
    rows = name == "fc_rows_lrmul"
    xb = torch.from_numpy(x if rows else x.reshape(-1, *x.shape[2:]))
    eb = None if extra_t is None else (
        tuple(e.flatten(0, 1) for e in extra_t)
        if isinstance(extra_t, tuple) else extra_t.flatten(0, 1))
    got = apply(_stack(copies), xb, eb)
    for b in range(B):
        e = None if extra_t is None else (
            tuple(v[b] for v in extra_t) if isinstance(extra_t, tuple)
            else extra_t[b])
        one = apply(copies[b], torch.from_numpy(x[b]), e)
        _rel(got.reshape(B, *one.shape)[b], one, 1e-5,
             f"{name}[{b}] vs one image")
    _rel(got.reshape(want[name].shape), want[name], 1e-5, f"{name} vs tgi")


def test_bias_act_per_image_bias():
    r = _rng(7)
    x = torch.from_numpy(r.randn(B, O, 4, 4).astype(np.float32))
    b = torch.from_numpy(r.randn(B, O).astype(np.float32))
    got = bias_act(x, b, act="lrelu", clamp=0.5)
    want = np.stack([np.asarray(jbias_act(jnp.asarray(x[i:i + 1].numpy()),
                                          jnp.asarray(b[i].numpy()),
                                          act="lrelu", clamp=0.5))[0]
                     for i in range(B)])
    _rel(got, want, 1e-6)
    rows = bias_act(x.permute(0, 2, 3, 1), b, dim=3)
    _rel(rows.permute(0, 3, 1, 2), bias_act(x, b), 1e-6)
    with pytest.raises(AssertionError):
        bias_act(x, b[:2])
    with pytest.raises(AssertionError):
        bias_act(x, b, dim=0)


def test_modulated_conv_bf16_per_image():
    """The grouped form in bfloat16 (the reference's pre-normalization,
    networks_stylegan2.py:54-56) against its float32 result."""
    r = _rng(9)
    x = torch.from_numpy(r.randn(B, I, H, H).astype(np.float32))
    w = torch.from_numpy(r.randn(B, O, I, 3, 3).astype(np.float32))
    s = torch.from_numpy(r.randn(B, I).astype(np.float32))
    want = layers.modulated_conv2d(x, w, s, padding=1)
    got = layers.modulated_conv2d(x.bfloat16(), w, s, padding=1)
    assert got.dtype == torch.bfloat16
    _rel(got.float(), want, 3e-2)


def _map_paths(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, prefix + (k,)) for k, v in tree.items()}
    return fn(prefix, tree)


@pytest.fixture(scope="module")
def gen():
    """The tiny generator and B copies of it, each leaf moved by a small
    draw, with ws and cameras for B images."""
    _, _, gt, pt = tiny_pair()
    copies = []
    for b in range(B):
        g = torch.Generator().manual_seed(40 + b)
        copies.append(_map_paths(
            lambda _, v: v + 0.05 * torch.randn(v.shape, generator=g), pt))
    r = _rng(41)
    ws = torch.from_numpy((0.5 * r.randn(B, gt.cfg.num_ws, 32))
                          .astype(np.float32))
    cams = torch.from_numpy(np.concatenate(
        [tiny_camera(0.3 * b - 0.3) for b in range(B)]).astype(np.float32))
    return gt, pt, copies, ws, cams


def _render_loss(out, weights):
    return sum((out[k].float() * weights[k]).sum() for k in weights)


def _fresh(tree):
    return _map_paths(
        lambda _, v: v.detach().clone().requires_grad_(True), tree)


@pytest.mark.parametrize("per_image", ["every_leaf", "noise_only"])
def test_generator_with_per_image_leaves(gen, per_image):
    """The tiny generator's synthesis (backbone, tri-plane render, SR)
    with every leaf per image (stage 2's tree), or only the noise buffers
    per image (stage 1's), equals per-image renders: the images, each
    per-image leaf's gradient, and each shared leaf's gradient as the
    sum of the images'."""
    gt, pt, copies, ws, cams = gen
    if per_image == "noise_only":
        def noise_of(c):
            return lambda path, v: (dict(leaves_with_paths(c))[path]
                                    if path[-1] == "noise_const" else v)
        copies = [_map_paths(noise_of(c), pt) for c in copies]
        stacked = _map_paths(
            lambda path, v: (torch.stack([dict(leaves_with_paths(c))[path]
                                          for c in copies])
                             if path[-1] == "noise_const" else v), pt)
    else:
        stacked = _stack(copies)
    stacked = _fresh(stacked)
    weights = {k: torch.from_numpy(_rng(42 + i).randn(
        B, *s).astype(np.float32)) for i, (k, s) in enumerate(
            (("image", (3, 64, 64)), ("image_raw", (3, 16, 16)),
             ("image_depth", (1, 16, 16))))}
    out = gt.synthesis(stacked, ws, cams)
    _render_loss(out, weights).backward()
    got = dict(leaves_with_paths(stacked))
    summed = {}
    for b in range(B):
        one_p = _fresh(copies[b])
        one = gt.synthesis(one_p, ws[b:b + 1], cams[b:b + 1])
        _render_loss(one, {k: v[b:b + 1] for k, v in weights.items()}
                     ).backward()
        for k in weights:
            _rel(out[k][b], one[k][0].detach(), 1e-5, k)
        for path, v in leaves_with_paths(one_p):
            g = got[path].grad
            per = got[path].shape != v.shape
            if v.grad is None:
                assert g is None or not g.any(), path
            elif per:
                _rel(g[b], v.grad, 1e-4, f"{path}[{b}]")
            else:
                summed[path] = summed.get(path, 0) + v.grad
    for path, g in summed.items():
        _rel(got[path].grad, g, 1e-4, f"{path} summed")
    assert (len(summed) > 10) == (per_image == "noise_only")


def test_stack_params_and_take_image(gen):
    gt, pt, copies, _, _ = gen
    stacked = stack_params(pt, B)
    for path, v in leaves_with_paths(stacked):
        assert v.shape[0] == B and not v.requires_grad
    for b in range(B):
        for (p1, v1), (p2, v2) in zip(leaves_with_paths(take_image(
                stacked, b)), leaves_with_paths(pt)):
            assert p1 == p2 and torch.equal(v1, v2)
    back = take_image(_stack(copies), 1)
    for (_, v1), (_, v2) in zip(leaves_with_paths(back),
                                leaves_with_paths(copies[1])):
        assert torch.equal(v1, v2)
