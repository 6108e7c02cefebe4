"""The face networks against tgi's, on the CPU: the IR-SE trunk
(``models/irse.py``, with taps), e4e (``models/e4e.py``: the progressive
codes, the first code the projector reads, ``convert_psp_checkpoint`` in
its three published layouts and a wrong file refused), ArcFace
(``models/arcface.py`` and its converter) and the ID loss
(``losses/id_loss.py``).

The numerics run at depth 50 with every channel count scaled by 1/8
(the port's ``width_mult``; tgi's apply functions read channels off the
weights), the weights drawn by the port with random BatchNorm statistics
and carried to tgi as arrays; the full-width trees are held against
tgi's by shape. Tolerances, relative to the largest magnitude per output:
1e-5 for one IR-SE block, the face crop and the converters (bitwise);
1e-4 for the 50-layer networks' outputs, whose random-weight activations
grow to ~1e6 through 24 residual blocks, and for the ID loss."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tgi.io.validate import expected_spec as jexpected_spec
from tgi.losses.id_loss import extract_face_crop as jcrop
from tgi.losses.id_loss import id_loss as jid_loss
from tgi.models import arcface as jarc
from tgi.models import e4e as je4e
from tgi.models import irse as jirse
from tgi_torch.io.validate import arcface_spec, e4e_spec, validate_tree
from tgi_torch.losses import id_loss
from tgi_torch.models import arcface, e4e, irse

from torch_helpers import jit_ref, leaves_with_paths

WIDTH = 0.125
NET_TOL = 1e-4


def _j(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


def _rel(got, want, tol=1e-5, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (name, err)


def _random_bn(tree, gen):
    """Every BatchNorm of ``tree`` given non-trivial statistics and
    affine parameters, in place."""
    if isinstance(tree, dict):
        if "running_var" in tree:
            c = tree["running_var"].shape
            tree["running_mean"] = torch.randn(c, generator=gen) * 0.1
            tree["running_var"] = torch.rand(c, generator=gen) + 0.5
            tree["weight"] = 1 + 0.1 * torch.randn(c, generator=gen)
            tree["bias"] = 0.1 * torch.randn(c, generator=gen)
        else:
            for v in tree.values():
                _random_bn(v, gen)
    return tree


def _state_dict(tree):
    return {".".join(p): t.numpy() for p, t in leaves_with_paths(tree)}


@pytest.fixture(scope="module")
def nets():
    gen = torch.Generator().manual_seed(51)
    pe = _random_bn(e4e.e4e_init(gen, device="cpu", width_mult=WIDTH), gen)
    pa = _random_bn(arcface.arcface_init(gen, device="cpu",
                                         width_mult=WIDTH), gen)
    rng = np.random.RandomState(52)
    xe = (rng.rand(2, 3, 64, 64) * 255).astype(np.float32)
    xa = rng.randn(2, 3, 112, 112).astype(np.float32)

    def ref(pe, xe, pa, xa):
        trunk, taps = jirse.trunk_apply(pe, xe, taps=je4e.TAPS)
        return (je4e.e4e_apply(pe, xe), trunk, taps,
                jarc.arcface_apply(pa, xa))

    want = jit_ref(ref)(_j(pe), jnp.asarray(xe), _j(pa), jnp.asarray(xa))
    return dict(pe=pe, pa=pa, xe=xe, xa=xa, want=want)


@pytest.mark.parametrize("depth", [50, 100, 152])
def test_get_blocks(depth):
    assert irse.get_blocks(depth) == jirse.get_blocks(depth)


def test_full_width_trees_match_tgi():
    """e4e and ArcFace at full width: tgi's names and shapes."""
    key = jax.random.PRNGKey(0)
    assert e4e_spec() == jexpected_spec(je4e.e4e_init, key)
    assert arcface_spec() == jexpected_spec(jarc.arcface_init, key)


def test_trunk_taps(nets):
    with torch.no_grad():
        x, taps = irse.trunk_apply(nets["pe"], torch.from_numpy(nets["xe"]),
                                   taps=e4e.TAPS)
    _, want_x, want_taps, _ = nets["want"]
    _rel(x, want_x, NET_TOL, name="trunk")
    assert sorted(taps) == sorted(want_taps) == [6, 20, 23]
    for i in taps:
        _rel(taps[i], want_taps[i], NET_TOL, name=f"tap {i}")


@pytest.mark.parametrize("index", [0, 1, 3])
def test_bottleneck_block(nets, index):
    """One IR-SE block against tgi's: index 0 strides 2 with the
    subsampling shortcut, 1 strides 1, 3 strides 2 with a shortcut
    conv."""
    in_c, depth, stride = irse.get_blocks(50)[index]
    p = nets["pe"]["body"][str(index)]
    c_in = irse.scaled(in_c, WIDTH)
    x = np.random.RandomState(55 + index).randn(2, c_in, 16, 16).astype(
        np.float32)
    with torch.no_grad():
        got = irse.bottleneck_apply(p, torch.from_numpy(x), stride, True)
    want = jirse.bottleneck_apply(_j(p), jnp.asarray(x), in_c, depth,
                                  stride, True)
    _rel(got, want, name=f"block {index}")


def test_e4e_apply_and_first_code(nets):
    x = torch.from_numpy(nets["xe"])
    with torch.no_grad():
        codes = e4e.e4e_apply(nets["pe"], x)
        w0 = e4e.e4e_encode_w0(nets["pe"], x)
        staged = e4e.e4e_apply(nets["pe"], x, progressive_stage=5)
    want = np.asarray(nets["want"][0])
    assert codes.shape == (2, e4e.STYLE_COUNT, 64)
    _rel(codes, want, NET_TOL, name="codes")
    _rel(w0, want[:, 0], NET_TOL, name="w0")
    # Past the progressive stage every code is w0.
    torch.testing.assert_close(staged[:, :6], codes[:, :6], rtol=0, atol=0)
    assert torch.equal(staged[:, 6:], w0[:, None].expand(2, 12, 64))


def test_arcface_apply_and_converter(nets):
    sd = _state_dict(nets["pa"])
    sd["input_layer.1.num_batches_tracked"] = np.zeros((), np.int64)
    params = arcface.convert_torch_state_dict(sd)
    assert _state_dict(params).keys() == _state_dict(nets["pa"]).keys()
    want_tree = jarc.convert_torch_state_dict(
        {k: v for k, v in sd.items() if "num_batches" not in k})
    for (p, got), (_, want) in zip(leaves_with_paths(params),
                                   leaves_with_paths(want_tree)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with torch.no_grad():
        emb = arcface.arcface_apply(params, torch.from_numpy(nets["xa"]))
    _rel(emb, nets["want"][3], NET_TOL, name="arcface")
    np.testing.assert_allclose(torch.linalg.norm(emb, dim=1).numpy(), 1.0,
                               rtol=1e-6)


@pytest.mark.parametrize("layout", ["full_dump", "data_parallel", "bare"])
def test_convert_psp_checkpoint_layouts(nets, layout):
    """Every published layout gives the same tree, and the same as tgi's
    converter on the same file; a full dump's latent_avg is returned."""
    enc = _state_dict(nets["pe"])
    enc["input_layer.1.num_batches_tracked"] = np.zeros((), np.int64)
    avg = np.random.RandomState(53).randn(18, 64).astype(np.float32)
    if layout == "full_dump":
        ckpt = {"state_dict": {f"encoder.{k}": v for k, v in enc.items()},
                "latent_avg": avg, "opts": {"device": "cuda"}}
        ckpt["state_dict"]["decoder.style.1.weight"] = np.zeros(
            (64, 64), np.float32)
    elif layout == "data_parallel":
        ckpt = {f"module.encoder.{k}": v for k, v in enc.items()}
    else:
        ckpt = dict(enc)
    got, got_avg = e4e.convert_psp_checkpoint(ckpt, validate=False)
    want, want_avg = je4e.convert_psp_checkpoint(ckpt, validate=False)
    validate_tree(got, e4e_spec(WIDTH), "e4e")
    got_l = dict(leaves_with_paths(got))
    want_l = dict(leaves_with_paths(want))
    assert got_l.keys() == want_l.keys()
    for k in got_l:
        np.testing.assert_array_equal(got_l[k].numpy(), np.asarray(want_l[k]))
        np.testing.assert_array_equal(got_l[k].numpy(),
                                      dict(leaves_with_paths(nets["pe"]))[k]
                                      .numpy())
    if layout == "full_dump":
        np.testing.assert_array_equal(got_avg.numpy(), avg)
        np.testing.assert_array_equal(np.asarray(want_avg), avg)
    else:
        assert got_avg is None and want_avg is None


def test_convert_psp_checkpoint_validates_at_full_width():
    """A full-width file (meta tensors: shapes only) passes; a pose-net
    file and a truncated encoder are refused with the difference."""
    with torch.device("meta"):
        full = e4e.e4e_init(None, device="meta")
    sd = {".".join(p): t for p, t in leaves_with_paths(full)}
    params, _ = e4e.convert_psp_checkpoint(sd, device="meta")
    assert len(list(leaves_with_paths(params))) == len(e4e_spec())
    with pytest.raises(ValueError, match="expected parameter layout"):
        e4e.convert_psp_checkpoint(
            {"conv1.weight": np.zeros((64, 3, 7, 7), np.float32)})
    broken = {k: v for k, v in sd.items() if not k.startswith("styles.9.")}
    with pytest.raises(ValueError, match="missing"):
        e4e.convert_psp_checkpoint(broken, device="meta")


@pytest.mark.parametrize("res", [256, 512])
def test_face_crop_and_id_loss(res):
    """The 188² crop shrunk to 112² as jax.image.resize does (antialiased),
    and the loss of two images at 256² and 512² (area-shrunk), with the
    same linear embedding on both sides."""
    rng = np.random.RandomState(54 + res)
    a = rng.uniform(-1, 1, (2, 3, res, res)).astype(np.float32)
    b = rng.uniform(-1, 1, (2, 3, res, res)).astype(np.float32)
    m = rng.randn(3 * 112 * 112, 16).astype(np.float32) * 0.01
    if res == 256:
        _rel(id_loss.extract_face_crop(torch.from_numpy(a)),
             jcrop(jnp.asarray(a)), name="crop")
    got = id_loss.id_loss(lambda x: x.reshape(x.shape[0], -1)
                          @ torch.from_numpy(m),
                          torch.from_numpy(a), torch.from_numpy(b))
    want = jid_loss(lambda x: x.reshape(x.shape[0], -1) @ jnp.asarray(m),
                    jnp.asarray(a), jnp.asarray(b))
    assert abs(float(got) - float(want)) <= 1e-4 * max(1.0, abs(float(want)))
