"""Import reference EG3D / 3DGAN-Inversion pickles into the port's params
(twin of ``tgi/io/pickle_import.py``).

The reference pickles carry *source code* next to the weights
(torch_utils/persistence.py:37-60: every module reduces to
``_reconstruct_persistent_obj(meta)`` with
``meta = {type, version, module_src, class_name, state}``). This loader
never runs that code: a restricted unpickler captures ``state`` (the
nn.Module ``__dict__`` with ``_parameters`` / ``_buffers`` /
``_modules``) into lightweight nodes, and every class outside an exact
allowlist becomes an inert stub.

Tensors are rebuilt without running any torch deserializer. A pickled
torch tensor reduces to ``torch._utils._rebuild_tensor_v2(
torch.storage._load_from_bytes(b), ...)``, with ``b`` a legacy
``torch.save`` stream; the real ``_load_from_bytes`` hands ``b`` to an
unrestricted ``torch.load``, so a crafted pickle could reach arbitrary
code. The stand-ins below parse ``b`` themselves under the same
restricted policy (:func:`_safe_load_from_bytes`) and copy its raw data
section into tensors with ``torch.frombuffer``: bf16 storages decode
without ``ml_dtypes``.

Captured leaves are CPU tensors in their stored dtype;
:func:`convert_generator_params` renames the reference ``state_dict`` to
the port's params tree (the same keys as ``tgi``'s) as float32 tensors
on a named device.
"""

from __future__ import annotations

import collections
import dataclasses
import io
import pickle
import struct

import numpy as np
import torch

from tgi_torch import default_device


class CapturedModule:
    """Stand-in for a persistent-class instance: holds the raw state."""

    def __init__(self, meta: dict):
        self.class_name = meta.get("class_name")
        self.state = meta.get("state", {})

    @property
    def init_args(self):
        return self.state.get("_init_args", ())

    @property
    def init_kwargs(self):
        return dict(self.state.get("_init_kwargs", {}))

    def submodules(self):
        return dict(self.state.get("_modules", {}) or {})

    def parameters_and_buffers(self):
        out = {}
        for src in ("_parameters", "_buffers"):
            for name, t in (self.state.get(src, {}) or {}).items():
                if t is not None:
                    out[name] = t
        return out

    def __repr__(self):
        return f"CapturedModule({self.class_name})"


def _reconstruct_captured(meta):
    return CapturedModule(meta)


class _EasyDict(dict):
    """Attribute-style dict standing in for dnnlib.EasyDict in pickles."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v


class StubModule:
    """Permissive stand-in for non-persistent reference classes (e.g.
    OSGDecoder, triplane.py:113 has no @persistent_class): absorbs any
    constructor args and keeps the pickled state in ``__dict__`` so the
    tree walk below can still reach its parameters."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


def _make_stub(module, name):
    return type(name, (StubModule,), {"_source": f"{module}.{name}"})


# ---------------------------------------------------------------------------
# Tensor deserialization that runs no torch deserializer.

_STORAGE_DTYPES = {
    "FloatStorage": torch.float32,
    "DoubleStorage": torch.float64,
    "HalfStorage": torch.float16,
    "BFloat16Storage": torch.bfloat16,
    "LongStorage": torch.int64,
    "IntStorage": torch.int32,
    "ShortStorage": torch.int16,
    "CharStorage": torch.int8,
    "ByteStorage": torch.uint8,
    "BoolStorage": torch.bool,
}


class _StorageType:
    """Marker for a torch storage class GLOBAL inside the legacy stream."""

    def __init__(self, name):
        self.name = name
        self.dtype = _STORAGE_DTYPES[name]


class _Storage:
    """Deserialized storage: a flat tensor, filled when the stream's raw
    data section is read."""

    def __init__(self, dtype, numel):
        self.dtype = dtype
        self.numel = numel
        self.tensor = None


_LEGACY_MAGIC = 0x1950A86A20F9469CFC6C


class _LegacyStreamUnpickler(pickle.Unpickler):
    """Restricted unpickler for the pickles inside a legacy torch.save
    stream (magic/protocol/sysinfo/object/keys). Only storage-class
    globals and OrderedDict resolve; persistent ids allocate storages."""

    def __init__(self, f, storages):
        super().__init__(f)
        self._storages = storages

    def find_class(self, module, name):
        if module in ("torch", "torch.storage") and name in _STORAGE_DTYPES:
            return _StorageType(name)
        if (module, name) == ("collections", "OrderedDict"):
            return collections.OrderedDict
        return _make_stub(module, name)

    def persistent_load(self, pid):
        # ('storage', storage_type, root_key, location, numel[, view_meta])
        if not (isinstance(pid, tuple) and pid and pid[0] == "storage"):
            raise pickle.UnpicklingError(f"unsupported persistent id {pid!r}")
        storage_type, root_key, _location, numel = pid[1:5]
        if not isinstance(storage_type, _StorageType):
            raise pickle.UnpicklingError(
                f"unsupported storage type {storage_type!r}")
        if root_key not in self._storages:
            self._storages[root_key] = _Storage(storage_type.dtype, numel)
        return self._storages[root_key]


def _safe_load_from_bytes(b):
    """Parse a legacy torch.save stream into a _Storage, running no torch
    deserializer.

    Format (torch/serialization.py ``_legacy_save``): four pickles —
    magic number, protocol version, sys info, the object — then a pickle
    of the serialized storage keys, then per key: int64 numel + raw data.
    """
    f = io.BytesIO(bytes(b))
    storages: dict = {}

    def load_one():
        return _LegacyStreamUnpickler(f, storages).load()

    magic = load_one()
    if magic != _LEGACY_MAGIC:
        raise pickle.UnpicklingError(
            "embedded storage payload is not a legacy torch.save stream")
    load_one()  # protocol version
    load_one()  # sys info
    obj = load_one()
    keys = load_one()
    for key in keys:
        st = storages[key]
        (numel,) = struct.unpack("<q", f.read(8))
        nbytes = numel * torch.empty((), dtype=st.dtype).element_size()
        raw = bytearray(nbytes)
        if f.readinto(raw) != nbytes:
            raise pickle.UnpicklingError("truncated storage data section")
        st.tensor = (torch.frombuffer(raw, dtype=st.dtype) if nbytes
                     else torch.empty((0,), dtype=st.dtype))
    return obj


def _safe_rebuild_tensor_v2(storage, storage_offset, size, stride, *args):
    """torch._utils._rebuild_tensor_v2 stand-in -> a contiguous CPU tensor
    copied out of the storage (strides are in elements)."""
    if not isinstance(storage, _Storage) or storage.tensor is None:
        raise pickle.UnpicklingError("tensor without a decoded storage")
    view = torch.as_strided(storage.tensor, tuple(size), tuple(stride),
                            storage_offset)
    return view.clone(memory_format=torch.contiguous_format)


def _safe_rebuild_tensor(storage, storage_offset, size, stride):
    return _safe_rebuild_tensor_v2(storage, storage_offset, size, stride)


def _safe_rebuild_parameter(data, requires_grad=True, backward_hooks=None):
    return data


# Exact (module, name) pairs required to deserialize tensors/arrays. A
# broader prefix allowlist (e.g. all of 'builtins' or 'torch*') would let
# a crafted pickle reach exec/eval or the untrusted torch_utils package
# via REDUCE — everything outside this set becomes an inert stub. Torch
# hooks never resolve to torch itself: they map to the stand-ins above.
_SAFE_CLASSES = {
    ("collections", "OrderedDict"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("_codecs", "encode"),
}
_TORCH_STANDINS = {
    ("torch._utils", "_rebuild_tensor"): _safe_rebuild_tensor,
    ("torch._utils", "_rebuild_tensor_v2"): _safe_rebuild_tensor_v2,
    ("torch._utils", "_rebuild_parameter"): _safe_rebuild_parameter,
    ("torch.storage", "_load_from_bytes"): _safe_load_from_bytes,
    ("torch", "Size"): tuple,
}


class _TFNetworkStub(_EasyDict):
    """Marker for dnnlib.tflib.network.Network entries (TF-era pickles,
    legacy.py:64-66)."""


class ReferenceUnpickler(pickle.Unpickler):
    """Unpickler that captures persistent modules instead of executing
    their embedded source, and never resolves classes outside the exact
    tensor-deserialization allowlist above."""

    def find_class(self, module, name):
        if name == "_reconstruct_persistent_obj":
            return _reconstruct_captured
        if module == "dnnlib.tflib.network" and name == "Network":
            return _TFNetworkStub
        if (module, name) == ("dnnlib", "EasyDict") or name == "EasyDict":
            return _EasyDict
        if (module, name) in _TORCH_STANDINS:
            return _TORCH_STANDINS[(module, name)]
        if (module, name) in _SAFE_CLASSES:
            return super().find_class(module, name)
        # Anything else (reference package code, builtins, torch_utils…):
        # a permissive stub that keeps state without importing or
        # executing anything.
        return _make_stub(module, name)


def load_network_pkl(path_or_bytes, device="cpu") -> dict:
    """Load a reference pickle; returns the raw dict with CapturedModule
    values for G/D/G_ema (plus any plain entries).

    Modern pickles (force-fp16 variants included) load as CapturedModule
    trees. TF-era pickles (a (G, D, Gs) tuple of tflib Networks,
    legacy.py:28-33) predate the tri-plane generator: their networks are
    converted into the standalone 2D StyleGAN2 family by
    ``io/legacy_tf.py`` (the reference's convert_tf_generator /
    _discriminator mapping), and the dict's entries come back as
    ConvertedSG2 (config + params on ``device``), ready for
    ``tgi_torch.models.stylegan2``.
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = ReferenceUnpickler(io.BytesIO(path_or_bytes)).load()
    else:
        with open(path_or_bytes, "rb") as f:
            data = ReferenceUnpickler(f).load()
    if isinstance(data, tuple) and len(data) == 3 and \
            all(isinstance(net, _TFNetworkStub) for net in data):
        from tgi_torch.io.legacy_tf import convert_tf_network_tuple

        return convert_tf_network_tuple(data, device)
    if not isinstance(data, dict):
        raise ValueError(
            f"unrecognized network pickle payload: {type(data).__name__} "
            "(expected a dict with G/D/G_ema entries)")
    # legacy.py:36-40 'add missing fields'
    data.setdefault("training_set_kwargs", None)
    data.setdefault("augment_pipe", None)
    return data


def _to_tensor(t) -> torch.Tensor:
    if isinstance(t, np.ndarray):
        return torch.from_numpy(np.array(t))
    return t.detach().cpu()


def _module_state(obj):
    """(params_and_buffers, submodules) for CapturedModule, StubModule or a
    real torch nn.Module — all keep nn.Module's __dict__ layout."""
    if isinstance(obj, CapturedModule):
        d = obj.state
    else:
        d = getattr(obj, "__dict__", None)
    if not isinstance(d, dict) or "_modules" not in d:
        return None
    tensors = {}
    for src in ("_parameters", "_buffers"):
        for name, t in (d.get(src) or {}).items():
            if t is not None:
                tensors[name] = t
    return tensors, dict(d.get("_modules") or {})


def captured_state_dict(cap, prefix: str = "") -> dict:
    """Flatten a captured module tree to {dotted_name: CPU tensor}.

    Walks persistent CapturedModules, stubbed plain modules and real torch
    modules (e.g. nn.Sequential) uniformly.
    """
    out = {}
    state = _module_state(cap)
    if state is None:
        return out
    tensors, modules = state
    for name, t in tensors.items():
        out[prefix + name] = _to_tensor(t)
    for name, sub in modules.items():
        if sub is not None:
            out.update(captured_state_dict(sub, prefix + name + "."))
    return out


# ---------------------------------------------------------------------------
# state_dict -> the port's params


def _nest(tree: dict, path: list[str], value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def convert_generator_params(state_dict: dict, device="cpu") -> dict:
    """Map a reference TriPlaneGenerator state_dict to the port's params.

    Accepts {dotted_name: tensor or numpy array}; returns the nested dict
    of float32 tensors on ``device`` consumed by
    ``tgi_torch.models.generator.TriPlaneGenerator``. Filter buffers
    (resample_filter) are recomputed constants and skipped.
    """
    params: dict = {}
    for name, value in state_dict.items():
        parts = name.split(".")
        if parts[-1] == "resample_filter":
            continue
        v = _to_tensor(torch.as_tensor(value)).to(device=device,
                                                  dtype=torch.float32)

        if parts[0] == "backbone" and parts[1] == "mapping":
            # backbone.mapping.fc0.weight -> mapping.fc0.weight
            _nest(params, ["mapping"] + parts[2:], v)
        elif parts[0] == "backbone" and parts[1] == "synthesis":
            # backbone.synthesis.b64.conv0.affine.weight -> backbone.b64...
            _nest(params, ["backbone"] + parts[2:], v)
        elif parts[0] == "superresolution":
            _nest(params, parts, v)
        elif parts[0] == "decoder":
            # decoder.net.0.weight -> decoder.net0.weight;  net.2 -> net1
            idx = {"0": "net0", "2": "net1"}[parts[2]]
            _nest(params, ["decoder", idx, parts[3]], v)
        # anything else (e.g. renderer plane_axes const) is derived state
    return params


def generator_config_from_captured(cap: CapturedModule):
    """Build a GeneratorConfig from the pickled init args/kwargs
    (triplane.py:20-46 signature).

    EG3D builds its backbone at 256² with 3 × 32 channels (triplane.py:28,
    ``img_resolution=256, img_channels=32*3``), which ``tgi`` assumes. The
    port reads both from the backbone's own pickled init kwargs where it
    has them, so that a smaller tri-plane generator's pickle loads too; on
    EG3D's pickles the two agree."""
    from tgi_torch.models.generator import GeneratorConfig

    args = list(cap.init_args)
    kw = cap.init_kwargs
    names = ["z_dim", "c_dim", "w_dim", "img_resolution", "img_channels"]
    merged = dict(zip(names, args))
    merged.update({k: v for k, v in kw.items() if k in names})
    rendering_kwargs = dict(kw.get("rendering_kwargs", {}))
    mapping_kwargs = dict(kw.get("mapping_kwargs", {}))
    # neural_rendering_resolution is not an init kwarg: triplane.py:43
    # sets it to 64 and training overwrites the attribute (e.g.
    # ffhqrebalanced512-128 ships with 128); it persists in the pickled
    # module __dict__, and G.synthesis renders at it when no resolution
    # is passed (triplane.py:57-60), so it is read from the state.
    nrr = int(cap.state.get("neural_rendering_resolution", 64))
    backbone = cap.submodules().get("backbone")
    bb_kw = (backbone.init_kwargs if isinstance(backbone, CapturedModule)
             else {})
    return GeneratorConfig(
        z_dim=merged.get("z_dim", 512),
        c_dim=merged.get("c_dim", 25),
        w_dim=merged.get("w_dim", 512),
        img_resolution=merged.get("img_resolution", 512),
        img_channels=merged.get("img_channels", 3),
        backbone_resolution=bb_kw.get("img_resolution", 256),
        plane_channels=bb_kw.get("img_channels", 32 * 3) // 3,
        channel_base=kw.get("channel_base", 32768),
        channel_max=kw.get("channel_max", 512),
        mapping_layers=mapping_kwargs.get("num_layers", 8),
        sr_num_fp16_res=kw.get("sr_num_fp16_res", 4),
        neural_rendering_resolution=nrr,
        rendering_kwargs=rendering_kwargs,
    )


def load_generator(path, key: str = "G_ema", force_fp16: bool = False,
                   device=None):
    """One call: pickle path (or bytes) -> (GeneratorConfig, params on
    ``device``), the params checked against ``TriPlaneGenerator(cfg)``'s
    tree of names and shapes.

    ``force_fp16`` mirrors legacy.py:48-60's init-kwargs rewrite
    (num_fp16_res=4, conv_clamp=256): mixed precision is a config switch
    here as in ``tgi``, so the rewrite is ``fused_dtype='bfloat16'`` +
    ``sr_num_fp16_res=4``, with no parameter copy.
    """
    from tgi_torch.io.legacy_tf import ConvertedSG2
    from tgi_torch.io.validate import expected_spec, validate_tree
    from tgi_torch.models.generator import TriPlaneGenerator

    device = device or default_device()
    cap = load_network_pkl(path)[key]
    if isinstance(cap, ConvertedSG2):
        raise ValueError(
            "this pickle holds a TF-era 2D StyleGAN2 (no tri-plane "
            "decoder) — it converts to the tgi_torch.models.stylegan2 "
            "family, not TriPlaneGenerator; use load_network_pkl() and "
            "sg2_generator_apply, or tgi_torch.apps.legacy_convert")
    cfg = generator_config_from_captured(cap)
    if force_fp16:
        cfg = dataclasses.replace(cfg, fused_dtype="bfloat16",
                                  sr_num_fp16_res=4)
    params = convert_generator_params(captured_state_dict(cap), device)
    validate_tree(params, expected_spec(TriPlaneGenerator(cfg).init,
                                        torch.Generator()),
                  f"generator {key!r}")
    return cfg, params
