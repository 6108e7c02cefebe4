"""tgi_torch's reference-pickle reader (``io/pickle_import.py``) and
structural validation (``io/validate.py``) against tgi's, on the CPU.

No EG3D ``.pkl`` is in the tree: the pickles are written in memory by
``chip_smoke.reference_pickle`` from the tiny pair's weights (plane
C = 8, 32² backbone, SuperresolutionTiny), in the reference's layout
(persistent-class metas, reference ``state_dict`` names, resample-filter
buffers, a plain OSGDecoder around an ``nn.Sequential``), and read by
both packages from the same bytes. Values are compared bit for bit.

Two differences by design: EG3D's backbone is always 256² × 3 × 32
(triplane.py:28) and tgi assumes it, while the port reads the backbone's
size from its pickled init kwargs (equal on EG3D's pickles); and tgi's
reader turns 0-d tensors (``noise_strength``) into shape (1,)
(``np.ascontiguousarray``), where the port keeps the generator's ().
"""

import dataclasses
import io
import pickle
import sys
import types

import numpy as np
import pytest
import torch

from tgi.io import pickle_import as jpi
from tgi_torch.io import pickle_import as pi
from tgi_torch.io.validate import expected_spec, tree_spec, validate_tree
from tgi_torch.models.generator import GeneratorConfig, TriPlaneGenerator

import chip_smoke
from torch_helpers import leaves_with_paths, tiny_pair

BACKBONE_FIELDS = ("backbone_resolution", "plane_channels")


@pytest.fixture(scope="module")
def tiny():
    gj, pj, gt, pt = tiny_pair()
    return {"gt": gt, "pt": pt,
            "blob": chip_smoke.reference_pickle(gt.cfg, pt)}


def _same_values(got, want):
    """Bitwise equality of a port tensor and a tgi array (tgi's 0-d
    tensors come back as shape (1,))."""
    want = np.asarray(want)
    if want.shape != tuple(got.shape):
        assert got.ndim == 0 and want.shape == (1,)
        want = want.reshape(())
    if want.dtype != np.float32 and want.dtype.name == "bfloat16":
        return torch.equal(got, torch.from_numpy(
            want.astype(np.float32)).bfloat16())
    return torch.equal(got, torch.from_numpy(np.array(want)))


@pytest.mark.parametrize("force_fp16", [False, True])
def test_load_generator_matches_tgi(tiny, force_fp16):
    """Same bytes, both readers: the same leaf names, values bit for bit
    (and equal to the weights written), and the same config but for the
    backbone's size, which the port reads from the pickle."""
    cfg, params = pi.load_generator(tiny["blob"], force_fp16=force_fp16,
                                    device="cpu")
    jcfg, jparams = jpi.load_generator(tiny["blob"], force_fp16=force_fp16)
    got = dict(leaves_with_paths(params))
    want = dict(leaves_with_paths(jparams))
    assert set(got) == set(want) == set(dict(leaves_with_paths(tiny["pt"])))
    for path, t in got.items():
        assert t.dtype == torch.float32, path
        assert _same_values(t, want[path]), path
        assert torch.equal(t, dict(leaves_with_paths(tiny["pt"]))[path])
    for field in GeneratorConfig.__dataclass_fields__:
        if field in BACKBONE_FIELDS:
            assert getattr(jcfg, field) == {"backbone_resolution": 256,
                                            "plane_channels": 32}[field]
            continue
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert cfg.sr_num_fp16_res == 4
    assert cfg.neural_rendering_resolution == 16
    assert cfg.fused_dtype == ("bfloat16" if force_fp16 else "float32")
    assert dataclasses.replace(cfg, fused_dtype="float32") == tiny["gt"].cfg


def test_captured_state_dict_matches_tgi(tiny):
    """The reference state_dict names (resample filters included) and
    their values, from both readers."""
    got = pi.captured_state_dict(pi.load_network_pkl(tiny["blob"])["G_ema"])
    want = jpi.captured_state_dict(
        jpi.load_network_pkl(tiny["blob"])["G_ema"])
    assert sorted(got) == sorted(want)
    assert "backbone.synthesis.b8.conv0.resample_filter" in got
    assert "decoder.net.2.weight" in got and "backbone.mapping.w_avg" in got
    for k, t in got.items():
        assert _same_values(t, want[k]), k


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_reduced_precision_weights_load_bitwise(tiny, dtype):
    """A pickle whose weights are stored in fp16 (a force-fp16 pickle) or
    bf16 loads as those values in float32, as tgi's reader gives them."""
    blob = chip_smoke.reference_pickle(tiny["gt"].cfg, tiny["pt"],
                                       dtype=dtype)
    _, params = pi.load_generator(blob, device="cpu")
    src = dict(leaves_with_paths(tiny["pt"]))
    for path, t in leaves_with_paths(params):
        assert torch.equal(t, src[path].to(dtype).float()), path
    sd = pi.captured_state_dict(pi.load_network_pkl(blob)["G_ema"])
    jsd = jpi.captured_state_dict(jpi.load_network_pkl(blob)["G_ema"])
    for k, t in sd.items():
        # The resample filters stay float32 buffers.
        assert t.dtype == (torch.float32 if k.endswith("resample_filter")
                           else dtype), k
        assert _same_values(t, jsd[k]), k


TENSORS = {
    "f32": lambda: torch.randn(3, 5),
    "f16": lambda: torch.randn(4, 2).half(),
    "bf16": lambda: torch.randn(2, 7).bfloat16(),
    "i64": lambda: torch.arange(10),
    "u8": lambda: torch.arange(6, dtype=torch.uint8).reshape(2, 3),
    "bool": lambda: torch.tensor([True, False, True]),
    "view": lambda: torch.randn(4, 6).t(),      # non-contiguous strides
    "slice": lambda: torch.randn(10)[2:7],      # nonzero storage offset
    "param": lambda: torch.nn.Parameter(torch.randn(2, 2)),
    "scalar": lambda: torch.tensor(0.3),
}


@pytest.mark.parametrize("kind", sorted(TENSORS))
def test_tensors_decode_bitwise(kind):
    """Pickled torch tensors of every kind come back bit for bit, in
    their dtype and shape, through the stand-ins (mirrors
    tests/test_utils.py::test_torch_free_tensor_deserialization)."""
    torch.manual_seed(0)
    t = TENSORS[kind]().detach()
    out = pi.ReferenceUnpickler(io.BytesIO(pickle.dumps({"t": t}))).load()
    got = out["t"]
    assert isinstance(got, torch.Tensor) and got.is_contiguous()
    assert got.dtype == t.dtype and got.shape == t.shape
    assert torch.equal(got, t)


def test_no_pickle_bytes_reach_torch_load(tiny, monkeypatch):
    """The storage hook is the module's own stand-in, and a whole
    generator loads with torch.load and torch's own _load_from_bytes
    made to fail."""
    hook = pi._TORCH_STANDINS[("torch.storage", "_load_from_bytes")]
    assert hook is pi._safe_load_from_bytes
    assert hook.__module__ == "tgi_torch.io.pickle_import"

    def refuse(*a, **k):
        raise AssertionError("pickle bytes reached torch")

    monkeypatch.setattr(torch, "load", refuse)
    monkeypatch.setattr(torch.storage, "_load_from_bytes", refuse)
    cfg, params = pi.load_generator(tiny["blob"], device="cpu")
    assert cfg.z_dim == 32 and "mapping" in params


def test_unsafe_globals_become_stubs():
    """A REDUCE of anything outside the allowlist calls an inert stub."""
    class Evil:
        def __reduce__(self):
            return (eval, ("1 + 1",))

    out = pi.ReferenceUnpickler(io.BytesIO(pickle.dumps(Evil()))).load()
    assert isinstance(out, pi.StubModule)


def _tf_tuple():
    """Bytes of a (G, D, Gs) tuple of dnnlib.tflib.network.Network."""
    mods = {k: types.ModuleType(k)
            for k in ("dnnlib", "dnnlib.tflib", "dnnlib.tflib.network")}

    class Network(dict):
        pass

    Network.__module__ = "dnnlib.tflib.network"
    Network.__qualname__ = "Network"
    mods["dnnlib.tflib.network"].Network = Network
    saved = {k: sys.modules.get(k) for k in mods}
    sys.modules.update(mods)
    try:
        return pickle.dumps((Network(), Network(), Network()))
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def test_tf_tuple_and_non_dict_payloads_raise():
    """A TF-era tuple now converts through io/legacy_tf.py
    (``tests/test_torch_legacy_tf.py`` holds it against tgi); one of bare
    Network stubs (no version, no variables) is refused, and so is a
    payload that is neither a dict nor such a tuple."""
    blob = chip_smoke.tf_network_pickle(
        dict(latent_size=8, dlatent_size=8, resolution=8, fmap_base=16,
             fmap_max=8, mapping_layers=1),
        dict(resolution=8, fmap_base=16, fmap_max=8), seed=0)
    data = pi.load_network_pkl(blob)
    assert {data[k].kind for k in ("G", "D", "G_ema")} == {
        "generator", "discriminator"}
    with pytest.raises(ValueError, match="version too low"):
        pi.load_network_pkl(_tf_tuple())
    with pytest.raises(ValueError, match="unrecognized"):
        pi.load_network_pkl(pickle.dumps([1, 2]))


def test_load_generator_refuses_a_mismatched_tree(tiny):
    """A pickle missing a leaf, or with a leaf of another shape, fails
    the check against TriPlaneGenerator(cfg).init."""
    pt = tiny["pt"]
    short = {**pt, "decoder": {"net0": pt["decoder"]["net0"],
                               "net1": {"weight": pt["decoder"]["net1"][
                                   "weight"]}}}
    with pytest.raises(ValueError, match="missing 1 leaves"):
        pi.load_generator(chip_smoke.reference_pickle(tiny["gt"].cfg, short),
                          device="cpu")
    wide = {**pt, "mapping": {**pt["mapping"],
                              "w_avg": torch.zeros(33)}}
    with pytest.raises(ValueError, match="shape mismatches"):
        pi.load_generator(chip_smoke.reference_pickle(tiny["gt"].cfg, wide),
                          device="cpu")


def _meta(**state):
    return {"class_name": "training.triplane.TriPlaneGenerator",
            "state": {"_init_args": (512, 25, 512, 512, 3),
                      "_init_kwargs": {"rendering_kwargs": {
                          "depth_resolution": 8}, "sr_num_fp16_res": 2,
                          "mapping_kwargs": {"num_layers": 2}},
                      "_modules": {}, "_parameters": {}, "_buffers": {},
                      **state}}


def test_config_from_captured_matches_tgi():
    """On an EG3D-shaped meta every config field agrees with tgi's, the
    pickled neural_rendering_resolution attribute included, and its
    absence gives triplane.py:43's 64."""
    for state in ({"neural_rendering_resolution": 128}, {}):
        meta = _meta(**state)
        cfg = pi.generator_config_from_captured(pi.CapturedModule(meta))
        jcfg = jpi.generator_config_from_captured(jpi.CapturedModule(meta))
        for field in GeneratorConfig.__dataclass_fields__:
            assert getattr(cfg, field) == getattr(jcfg, field), field
        assert cfg.neural_rendering_resolution == state.get(
            "neural_rendering_resolution", 64)
        assert cfg.sr_num_fp16_res == 2 and cfg.mapping_layers == 2


def test_validate_tree_cases():
    good = {"a": {"w": torch.zeros(3, 4), "b": torch.zeros(4)},
            "c": torch.ones(2)}
    assert tree_spec(good) == {"a.w": (3, 4), "a.b": (4,), "c": (2,)}
    assert validate_tree(good, good, "m") is good
    assert validate_tree(good, tree_spec(good), "m") is good
    with pytest.raises(ValueError, match="missing"):
        validate_tree({"a": {"w": torch.zeros(3, 4)}}, good, "m")
    with pytest.raises(ValueError, match="unexpected"):
        validate_tree({**good, "extra": torch.zeros(1)}, good, "m")
    with pytest.raises(ValueError, match="shape mismatches"):
        validate_tree({**good, "c": torch.ones(5)}, good, "m")


def test_expected_spec_runs_init_on_the_meta_device(tiny):
    """expected_spec draws nothing: the init runs on the meta device and
    gives the tree of names and shapes of a real init."""
    seen = []

    def init(generator, device="cuda"):
        t = torch.randn((2, 3), generator=generator).to(device)
        seen.append(t.device.type)
        return {"w": t, "b": torch.zeros((3,), device=device)}

    assert expected_spec(init, torch.Generator()) == {"w": (2, 3),
                                                      "b": (3,)}
    assert seen == ["meta"]
    G = TriPlaneGenerator(tiny["gt"].cfg)
    assert expected_spec(G.init, torch.Generator()) == tree_spec(tiny["pt"])
