"""Inception-V3 (the port's ``metrics/inception.py``) against tgi's, on the
CPU, with tgi run eagerly.

Both weight layouts: torchvision names through ``inception_feature_fn``
(tf_layout off) and NVIDIA's TF-graph names through the converter and
``nvidia_detector_fn`` (tf_layout on, [0, 255] input), BatchNorm separate
and folded; logits with and without the output bias; one upscale (128²
-> 299², plain bilinear) and one downscale (320² -> 299², antialiased).
Weights are drawn with numpy as tests/test_apps.py draws the NVIDIA
state dict. Features and logits agree within 1e-5 of their largest
magnitude (two float32 convolution libraries, 94 convolutions deep)."""

import pickle
import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_helpers import fold_nvidia_bn, inception_params
from tgi.metrics import inception as ji
from tgi_torch.metrics import inception as ti

REL = 1e-5


@pytest.fixture
def traced_skeleton(monkeypatch):
    """tgi's NVIDIA converter checks shapes against ``inception_v3_init``'s
    tree, which eagerly draws ~100 arrays (a minute of compiles on one
    core): hand it the traced tree, the same shapes."""
    import jax
    init = ji.inception_v3_init
    monkeypatch.setattr(ji, "inception_v3_init",
                        lambda key: jax.eval_shape(init, key))


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), (err, np.abs(want).max())


def _images(res, scale, seed=1):
    rng = np.random.RandomState(seed)
    return rng.uniform(0, 1, (2, 3, res, res)).astype(np.float32) * scale


def test_spec_is_tgi_skeleton():
    """The port's shape table is tgi's init tree, slot for slot (traced,
    not run: eager draws compile one program per shape)."""
    import jax
    skel = jax.eval_shape(ji.inception_v3_init, jax.random.PRNGKey(0))
    spec = ti.inception_spec()
    assert skel.keys() == spec.keys()
    for name, s in spec.items():
        if isinstance(s, tuple):
            assert skel[name]["conv"]["weight"].shape == s
        else:
            assert {b: skel[name][b]["conv"]["weight"].shape
                    for b in s} == s
    p = ti.inception_v3_init(torch.Generator().manual_seed(0), "cpu")
    assert tuple(p["Mixed_7c"]["branch_pool"]["conv"]["weight"].shape) == (
        192, 2048, 1, 1) and "fc" not in p


def _torchvision_pair(seed):
    """(port params, tgi params) from one torchvision-layout state dict,
    with a BN counter and an aux head that both converters drop."""
    sd = ti.torch_state_dict(_torch(inception_params(seed, 1000)))
    sd["Conv2d_1a_3x3.bn.num_batches_tracked"] = torch.tensor(3)
    sd["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    tp = ti.convert_torch_inception(sd)
    assert "AuxLogits" not in tp and \
        "num_batches_tracked" not in tp["Conv2d_1a_3x3"]["bn"]
    return tp, ji.convert_torch_inception({k: v.numpy()
                                           for k, v in sd.items()})


@pytest.mark.parametrize("res", [128, 320])
def test_torchvision_layout_matches_tgi(res):
    """torchvision names through ``inception_feature_fn``: the resize to
    299² inside, up from 128² and down from 320²."""
    tp, jp = _torchvision_pair(0)
    img = _images(res, 2.0) - 1.0
    _close(ti.inception_feature_fn(tp)(torch.from_numpy(img)),
           ji.inception_feature_fn(jp)(jnp.asarray(img)))


@pytest.mark.parametrize("no_output_bias", [False, True])
def test_torchvision_logits_match_tgi(no_output_bias):
    tp, jp = _torchvision_pair(0)
    x = _images(299, 2.0, seed=2) - 1.0
    _close(ti.inception_logits(tp, torch.from_numpy(x),
                               no_output_bias=no_output_bias),
           ji.inception_logits(jp, jnp.asarray(x),
                               no_output_bias=no_output_bias))


@pytest.mark.parametrize("res,kw", [
    (128, {}), (320, {}), (320, {"return_logits": True}),
    (320, {"return_logits": True, "no_output_bias": True})])
def test_nvidia_layout_matches_tgi(res, kw, traced_skeleton):
    """NVIDIA names, BatchNorm separate: the port's state dict of the
    same tree converts to that tree in both packages; the detector's
    features (up from 128², down from 320²) and its 1008-way logits with
    and without the bias."""
    p = inception_params(1, 1008)
    sd = ti.nvidia_state_dict(_torch(p))
    assert "layers.mixed_10.tower_1.mixed.conv_1.weight" in sd and \
        sd["output.weight"].shape == (1008, 2048)
    tp = ti.convert_nvidia_inception(sd)
    jp = ji.convert_nvidia_inception({k: v.numpy() for k, v in sd.items()})
    img = _images(res, 255.0)
    _close(ti.nvidia_detector_fn(tp, **kw)(torch.from_numpy(img)),
           ji.nvidia_detector_fn(jp, **kw)(jnp.asarray(img)))


def test_nvidia_round_trip_and_folded_bn():
    """convert(nvidia_state_dict(p)) is p; the BN-folded state dict (at
    the apply path's eps) gives the separate one's features; TF's
    [in, out] head is transposed; unknown or missing nodes fail."""
    p = _torch(inception_params(2, 1008))
    sd = ti.nvidia_state_dict(p)
    back = ti.convert_nvidia_inception(sd)
    for name, sub in ti.inception_spec().items():
        nodes = ({None: (p[name], back[name])} if isinstance(sub, tuple)
                 else {b: (p[name][b], back[name][b]) for b in sub})
        for a, b in nodes.values():
            assert torch.equal(a["conv"]["weight"], b["conv"]["weight"])
            for k in a["bn"]:
                assert torch.equal(a["bn"][k], b["bn"][k])
    fused = ti.convert_nvidia_inception(fold_nvidia_bn(sd, ti.BN_EPS))
    assert "bn" not in fused["Conv2d_1a_3x3"]
    img = torch.from_numpy(_images(96, 255.0))
    want = ti.nvidia_detector_fn(back)(img)
    got = ti.nvidia_detector_fn(fused)(img)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()

    tf_head = dict(sd, **{"output.weight": sd["output.weight"].T})
    assert torch.equal(ti.convert_nvidia_inception(tf_head)["fc"]["weight"],
                       p["fc"]["weight"])
    bad = dict(sd, **{"layers.mixed_11.conv.weight": torch.zeros(8, 8, 1,
                                                                  1)})
    with pytest.raises(ValueError, match="unrecognized"):
        ti.convert_nvidia_inception(bad)
    with pytest.raises(ValueError, match="missing"):
        ti.convert_nvidia_inception({k: v for k, v in sd.items()
                                     if "mixed_9" not in k})
    wrong = dict(sd, **{"layers.conv.weight": torch.zeros(32, 3, 5, 5)})
    with pytest.raises(ValueError, match="shape"):
        ti.convert_nvidia_inception(wrong)


class _Sub:
    """A plain module as the detector pickle holds one (``__dict__`` with
    ``_parameters``, ``_buffers``, ``_modules``)."""

    def __init__(self, params=None, modules=None):
        self._parameters = params or {}
        self._buffers = {}
        self._modules = modules or {}


def _detector_pickle(sd, monkeypatch):
    """The bytes of a persistence-pickled detector module holding ``sd``
    (numpy leaves) as a ``layers`` tree and an ``output`` linear. The
    reconstruct function's module exists only while pickling."""
    mod = types.ModuleType("torch_utils.persistence")

    def _reconstruct_persistent_obj(meta):
        raise RuntimeError("only written here")

    _reconstruct_persistent_obj.__module__ = mod.__name__
    _reconstruct_persistent_obj.__qualname__ = "_reconstruct_persistent_obj"
    mod._reconstruct_persistent_obj = _reconstruct_persistent_obj
    monkeypatch.setitem(sys.modules, "torch_utils",
                        types.ModuleType("torch_utils"))
    monkeypatch.setitem(sys.modules, mod.__name__, mod)

    root = _Sub()
    for key, value in sd.items():
        *path, leaf = key.split(".")
        node = root
        for part in path:
            node = node._modules.setdefault(part, _Sub())
        node._parameters[leaf] = value.numpy()

    class Persistent:
        def __reduce__(self):
            return _reconstruct_persistent_obj, (dict(
                type="class", version=6, module_src="",
                class_name="metrics.inception.InceptionV3",
                state=root.__dict__),)

    return pickle.dumps(Persistent())


def test_detector_pickle_converts(tmp_path, monkeypatch):
    """A detector pickle (read code-free by the port's unpickler) converts
    to the state dict's tree, through ``calc_metrics``' loader."""
    from tgi_torch.apps.calc_metrics import load_detector_feature_fn
    p = _torch(inception_params(3, 1008))
    sd = ti.nvidia_state_dict(p)
    path = tmp_path / "inception.pkl"
    path.write_bytes(_detector_pickle(sd, monkeypatch))
    fn = load_detector_feature_fn(str(path), device="cpu")
    img = torch.from_numpy(_images(64, 2.0)) - 1
    want = ti.nvidia_detector_fn(ti.convert_nvidia_inception(sd))(
        (img + 1) * 127.5)
    assert torch.equal(fn(img), want)


def test_avgpool_and_resize():
    """The padded average divides by the in-image count (TF), the resize
    antialiases only downscaling (jax.image.resize's linear)."""
    import jax
    x = np.random.RandomState(4).randn(1, 2, 7, 9).astype(np.float32)
    _close(ti._avgpool(torch.from_numpy(x)), ji._avgpool(jnp.asarray(x)))
    _close(ti._maxpool(torch.from_numpy(x), 3, 1, 1),
           ji._maxpool(jnp.asarray(x), 3, 1, 1))
    for res in (64, 299, 512):
        img = _images(res, 1.0, seed=res)
        got = ti.resize_299(torch.from_numpy(img))
        want = jax.image.resize(jnp.asarray(img), (2, 3, 299, 299),
                                method="linear")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
