"""TF-era StyleGAN2 pickles in tgi_torch (``io/legacy_tf.py``,
``models/stylegan2.py``, ``apps/legacy_convert.py`` and
``io/pickle_import.py``'s TF branch) against tgi's, on the CPU.

The ``(G, D, Gs)`` pickles are drawn at 32² (``chip_smoke.
tf_network_pickle``: ``dnnlib.tflib.network.Network`` stand-ins with the
variable names and layouts of a TF export, ``tests/test_legacy_tf.py``'s
names), unconditional and with 3 labels. Both packages read the same
bytes: the converted trees are equal bit for bit and the configs field
for field; the generators (const and random noise, truncation) and the
discriminators agree within 1e-5 of the largest output. All of tgi's
forwards run in one jitted call.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from tgi.io import legacy_tf as jlegacy
from tgi.io import load_network_pkl as j_load_network_pkl
from tgi.models.stylegan2 import sg2_generator_apply as j_sg2_apply
from tgi.nn.discriminator import discriminator_apply as j_d_apply
from tgi_torch.io import legacy_tf, load_checkpoint, load_network_pkl
from tgi_torch.io.pickle_import import ReferenceUnpickler, load_generator
from tgi_torch.models.stylegan2 import sg2_generator_apply
from tgi_torch.nn.discriminator import discriminator_apply
from tgi_torch.nn.synthesis import random_noise

import chip_smoke
from torch_helpers import (close, jit_ref, leaves_with_paths, tiny_pair,
                           with_tgi_draws)

TOL = 1e-5
N = 2


def _kwargs(labels):
    g = dict(latent_size=32, dlatent_size=32, resolution=32, fmap_base=64,
             fmap_max=32, mapping_layers=2, label_size=labels,
             truncation_psi=0.5, style_mixing_prob=0.9)
    d = dict(resolution=32, fmap_base=64, fmap_max=32, mbstd_group_size=2,
             label_size=labels, nonlinearity="lrelu",
             resample_kernel=[1, 3, 3, 1])
    return g, d


@pytest.fixture(scope="module")
def blobs():
    return {labels: chip_smoke.tf_network_pickle(*_kwargs(labels), seed=7,
                                                 scale=0.3)
            for labels in (0, 3)}


@pytest.fixture(scope="module")
def nets(blobs):
    """{labels: (the port's dict, tgi's dict)} from the same bytes."""
    return {k: (load_network_pkl(b), j_load_network_pkl(b))
            for k, b in blobs.items()}


def _inputs(labels, seed):
    rng = np.random.RandomState(seed)
    z = rng.randn(N, 32).astype(np.float32)
    c = np.eye(N, labels, dtype=np.float32)
    img = rng.randn(N, 3, 32, 32).astype(np.float32)
    return z, c, img


@pytest.fixture(scope="module")
def tgi_outputs(nets):
    """tgi's G (const noise; random noise from a key; truncation 0.7 at
    cutoff 4) and D on every network pair, in one jit."""
    key = jax.random.PRNGKey(11)

    def run(params):
        out = {}
        for labels, (_, j) in nets.items():
            z, c, img = _inputs(labels, labels)
            g, d = params[labels]
            gcfg, dcfg = j["G_ema"].config, j["D"].config
            out[labels] = {
                "const": j_sg2_apply(g, z, c, gcfg, noise_mode="const"),
                "random": j_sg2_apply(g, z, c, gcfg, noise_mode="random",
                                      noise_key=key),
                "trunc": j_sg2_apply(g, z, c, gcfg, truncation_psi=0.7,
                                     truncation_cutoff=4),
                "D": j_d_apply(d, img, c, dcfg)}
        return out

    params = {k: (j["G_ema"].params, j["D"].params)
              for k, (_, j) in nets.items()}
    return jax.tree.map(np.asarray, jit_ref(run)(params)), key


@pytest.mark.parametrize("labels", [0, 3])
def test_tree_and_config_equal_tgi(nets, labels):
    """``load_network_pkl`` converts the tuple to tgi's tree bit for bit
    (float32 CPU tensors; the 0-d noise strengths stay 0-d) and to the
    same configs; tgi's dict's other fields too."""
    ours, theirs = nets[labels]
    assert set(ours) == set(theirs) == {"G", "D", "G_ema",
                                        "training_set_kwargs",
                                        "augment_pipe"}
    assert ours["training_set_kwargs"] is ours["augment_pipe"] is None
    for name in ("G", "D", "G_ema"):
        a, b = ours[name], theirs[name]
        assert a.kind == b.kind
        assert dataclasses.asdict(a.config) == dataclasses.asdict(b.config)
        got, want = dict(leaves_with_paths(a.params)), dict(
            leaves_with_paths(b.params))
        assert set(got) == set(want)
        for path, t in got.items():
            w = np.asarray(want[path])
            assert t.dtype == torch.float32 and t.device.type == "cpu"
            assert tuple(t.shape) == w.shape, path
            np.testing.assert_array_equal(t.numpy(), w, err_msg=str(path))
    assert ours["G_ema"].config.c_dim == labels
    assert ours["G_ema"].config.channel_base == 128


@pytest.mark.parametrize("labels", [0, 3])
def test_generator_and_discriminator_match_tgi(nets, tgi_outputs, labels):
    want, key = tgi_outputs
    want = want[labels]
    ours = nets[labels][0]
    z, c, img = (torch.from_numpy(a) for a in _inputs(labels, labels))
    g, gcfg = ours["G_ema"].params, ours["G_ema"].config
    got = sg2_generator_apply(g, z, c, gcfg, noise_mode="const")
    assert got.shape == (N, 3, 32, 32) and got.dtype == torch.float32
    close(got, want["const"], TOL)
    close(sg2_generator_apply(g, z, c, gcfg, truncation_psi=0.7,
                              truncation_cutoff=4), want["trunc"], TOL)
    random = with_tgi_draws(key, lambda d: sg2_generator_apply(
        g, z, c, gcfg, noise_mode="random",
        noise=random_noise(gcfg.synthesis_cfg, N, d)))
    close(random, want["random"], TOL)
    assert np.abs(want["random"] - want["const"]).max() > 1e-3
    close(discriminator_apply(ours["D"].params, img, c, ours["D"].config),
          want["D"], TOL)


def _stub(blob, index):
    import io
    return ReferenceUnpickler(io.BytesIO(blob)).load()[index]


@pytest.mark.parametrize("kwarg,value,match", [
    ("bogus_knob", 3, "bogus_knob"),
    ("architecture", "resnet", "architecture"),
    ("nonlinearity", "relu", "nonlinearity"),
    ("resample_kernel", [1, 2, 1], "resample kernel"),
    ("use_noise", False, "use_noise")])
def test_generator_kwarg_rejections(blobs, kwarg, value, match):
    """Unknown kwargs and the knobs the SG2 stack fixes are refused, with
    tgi's error types, by both packages."""
    for convert in (legacy_tf.convert_tf_generator,
                    jlegacy.convert_tf_generator):
        stub = _stub(blobs[0], 0)
        stub.__dict__["static_kwargs"] = dict(stub.static_kwargs,
                                              **{kwarg: value})
        error = ValueError if kwarg == "bogus_knob" else NotImplementedError
        with pytest.raises(error, match=match):
            convert(stub)


def test_progressive_growing_and_version_rejected(blobs):
    """``ToRGB_lod`` / ``FromRGB_lod`` exports and pickles before version
    4 are refused."""
    stub = _stub(blobs[0], 0)
    syn = stub.components["synthesis"]
    syn.__dict__["variables"] = list(syn.variables) + [
        ("ToRGB_lod0/weight", np.zeros((1, 1, 32, 3), np.float32))]
    with pytest.raises(NotImplementedError, match="ToRGB_lod"):
        legacy_tf.convert_tf_generator(stub)
    d = _stub(blobs[0], 1)
    d.__dict__["variables"] = list(d.variables) + [
        ("FromRGB_lod1/weight", np.zeros((1, 1, 3, 32), np.float32))]
    with pytest.raises(NotImplementedError, match="FromRGB_lod"):
        legacy_tf.convert_tf_discriminator(d)
    old = _stub(blobs[0], 1)
    old.__dict__["version"] = 3
    with pytest.raises(ValueError, match="version too low"):
        legacy_tf.convert_tf_discriminator(old)
    short = _stub(blobs[0], 2)
    short.components["mapping"].__dict__["variables"] = list(
        short.components["mapping"].variables)[:-1]
    with pytest.raises(KeyError, match="Dense1/bias"):
        legacy_tf.convert_tf_generator(short)


def test_legacy_convert_round_trip(blobs, nets, tmp_path):
    """The command line (on the CPU) writes the port's checkpoint: every
    tensor reads back bit for bit, with each network's kind and config;
    ``--force-fp16 true`` rewrites the generators' configs as tgi does.
    A modern reference pickle converts to a tri-plane generator."""
    from tgi_torch.apps.legacy_convert import convert_pickle, main
    src = tmp_path / "tf.pkl"
    src.write_bytes(blobs[3])
    dst = tmp_path / "tf.ckpt"
    with pytest.raises(SystemExit) as e:
        main(["--source", str(src), "--dest", str(dst), "--force-fp16",
              "true"])
    assert e.value.code == 0
    out = load_checkpoint(str(dst))
    assert out["metadata"] == {"source": str(src)}
    ours = nets[3][0]
    for name, kind in (("G", "sg2_generator"), ("D", "sg2_discriminator"),
                       ("G_ema", "sg2_generator")):
        cfg = dict(out["config"][name])
        assert cfg.pop("kind") == kind
        want = dataclasses.asdict(ours[name].config)
        if kind == "sg2_generator":
            want.update(num_fp16_res=4, conv_clamp=256,
                        fused_dtype="bfloat16")
        assert cfg == want
        got = dict(leaves_with_paths(out["params"][name]))
        for path, t in leaves_with_paths(ours[name].params):
            assert torch.equal(got[path], t), (name, path)
    kinds = convert_pickle(str(src), str(tmp_path / "plain.ckpt"))
    assert kinds == {"G": "sg2_generator", "D": "sg2_discriminator",
                     "G_ema": "sg2_generator"}
    assert load_checkpoint(str(tmp_path / "plain.ckpt"))["config"][
        "G_ema"]["fused_dtype"] == "float32"

    _, _, gt, pt = tiny_pair()
    modern = tmp_path / "eg3d.pkl"
    modern.write_bytes(chip_smoke.reference_pickle(gt.cfg, pt))
    assert convert_pickle(str(modern), str(tmp_path / "eg3d.ckpt")) == {
        "G_ema": "triplane_generator"}
    back = load_checkpoint(str(tmp_path / "eg3d.ckpt"))
    for path, t in leaves_with_paths(pt):
        got = back["params"]["G_ema"]
        for k in path:
            got = got[k]
        assert torch.equal(got, t), path


def test_load_generator_refuses_a_tf_pickle(blobs, tmp_path):
    p = tmp_path / "tf.pkl"
    p.write_bytes(blobs[0])
    with pytest.raises(ValueError, match="2D StyleGAN2"):
        load_generator(str(p), device="cpu")
