"""Convert TF-era StyleGAN2 pickles into the port's SG2 trees (twin of
``tgi/io/legacy_tf.py``).

The reference handles legacy TensorFlow pickles — a ``(G, D, Gs)`` tuple of
``dnnlib.tflib`` Networks — by re-expressing their variables as a modern
torch StyleGAN2 (legacy.py:24-33, convert_tf_generator :109-206,
convert_tf_discriminator :210-291). ``tgi`` and the port do the same
re-expression into their functional SG2 trees
(``tgi_torch.models.stylegan2`` / ``tgi_torch.nn.discriminator``): the TF
variable names are mapped with the exact transposes/flips the reference
applies, the converted tree is structurally validated (keys + shapes)
against the module's own ``init`` run on the meta device
(``io/validate.py``; ``tgi`` uses ``jax.eval_shape``), and the float32
numpy leaves become tensors on the caller's device
(``io/from_jax.py::params_from_numpy``).

Scope matches the reference converter: the main TF StyleGAN2 /
StyleGAN2-ADA export configs (E/F). Progressive-growing 'orig'
architecture exports (``ToRGB_lod``/``FromRGB_lod`` variables,
legacy.py:162-166) and knobs the SG2 stack fixes structurally (non-lrelu
nonlinearity, non-[1,3,3,1] resample kernel, noise disabled) are rejected
loudly rather than silently mis-converted.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np


@dataclass(frozen=True)
class ConvertedSG2:
    """A TF network re-expressed as a port module: config + params tree.

    ``kind`` is 'generator' (use ``tgi_torch.models.stylegan2``) or
    'discriminator' (use ``tgi_torch.nn.discriminator``).
    """

    kind: str
    config: Any
    params: dict


def _collect_tf_params(tf_net) -> dict[str, np.ndarray]:
    """Flatten a tflib Network stub tree to {scoped_name: numpy}
    (legacy.py:75-84: component names become name prefixes)."""
    out: dict[str, np.ndarray] = {}

    def recurse(prefix, net):
        for name, value in getattr(net, "variables", []) or []:
            out[prefix + name] = np.asarray(value)
        comps = getattr(net, "components", None) or {}
        for name, comp in dict(comps).items():
            recurse(prefix + name + "/", comp)

    recurse("", tf_net)
    return out


class _KwargReader:
    """static_kwargs reader that tracks consumption and rejects unknowns
    (legacy.py:115-119, :148-157)."""

    def __init__(self, tf_net, what):
        self.kwargs = dict(getattr(tf_net, "static_kwargs", {}) or {})
        self.known: set[str] = set()
        self.what = what

    def __call__(self, name, default=None, none=None):
        self.known.add(name)
        val = self.kwargs.get(name, default)
        return val if val is not None else none

    def finish(self):
        unknown = sorted(set(self.kwargs) - self.known)
        if unknown:
            raise ValueError(
                f"unknown TensorFlow kwarg in {self.what}: {unknown[0]!r}")


def _require(cond, what, detail):
    if not cond:
        raise NotImplementedError(
            f"TF {what} uses {detail}, which the SG2 stack fixes "
            "structurally — this pickle cannot be converted faithfully")


def _check_version(tf_net, what):
    if getattr(tf_net, "version", 0) < 4:
        raise ValueError(
            f"TensorFlow pickle version too low for {what} (need >= 4)")


def _nest(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    v = np.asarray(value, dtype=np.float32)
    if v.ndim:                     # flips ([::-1]) leave negative strides;
        v = np.ascontiguousarray(v)  # 0-d stays 0-d (ascontiguous would 1-d it)
    # Host numpy until the whole tree is checked; then tensors on the
    # caller's device (_to_device).
    node[path[-1]] = v


def _to_device(params, spec, what, device):
    from tgi_torch.io.from_jax import params_from_numpy
    from tgi_torch.io.validate import validate_tree

    validate_tree(params, spec, what)
    return params_from_numpy(params, device)


# ---------------------------------------------------------------------------
# Generator (legacy.py:109-206)


def convert_tf_generator(tf_G, device="cpu") -> ConvertedSG2:
    """TF G/Gs network stub -> (SG2Config, params on ``device``) as a
    ConvertedSG2."""
    from tgi_torch.io.validate import expected_spec
    from tgi_torch.models.stylegan2 import SG2Config, sg2_generator_init

    _check_version(tf_G, "generator")
    kwarg = _KwargReader(tf_G, "generator")

    cfg = SG2Config(
        z_dim=kwarg("latent_size", 512),
        c_dim=kwarg("label_size", 0),
        w_dim=kwarg("dlatent_size", 512),
        img_resolution=kwarg("resolution", 1024),
        img_channels=kwarg("num_channels", 3),
        channel_base=kwarg("fmap_base", 16384) * 2,
        channel_max=kwarg("fmap_max", 512),
        mapping_layers=kwarg("mapping_layers", 8),
        num_fp16_res=kwarg("num_fp16_res", 0),
        conv_clamp=kwarg("conv_clamp", None),
        fused_dtype="bfloat16" if kwarg("num_fp16_res", 0) else "float32",
    )
    _require(kwarg("architecture", "skip") == "skip", "generator",
             f"architecture={kwarg('architecture', 'skip')!r}")
    _require(list(kwarg("resample_kernel", [1, 3, 3, 1], none=[1, 3, 3, 1]))
             == [1, 3, 3, 1], "generator", "a non-[1,3,3,1] resample kernel")
    _require(kwarg("use_noise", True), "generator", "use_noise=False")
    _require(kwarg("nonlinearity", "lrelu") == "lrelu", "generator",
             f"nonlinearity={kwarg('nonlinearity', 'lrelu')!r}")
    _require(kwarg("mapping_nonlinearity", "lrelu") == "lrelu", "generator",
             "a non-lrelu mapping nonlinearity")
    _require(float(kwarg("mapping_lrmul", 0.01)) == 0.01, "generator",
             f"mapping_lrmul={kwarg('mapping_lrmul', 0.01)}")
    _require(kwarg("label_fmaps", None) is None, "generator",
             "label_fmaps (custom embed width)")
    _require(kwarg("mapping_fmaps", None) in (None, cfg.w_dim), "generator",
             "mapping_fmaps != dlatent_size")
    # Accepted-and-ignored runtime knobs (legacy.py:149-154).
    for name in ("truncation_psi", "truncation_cutoff", "style_mixing_prob",
                 "structure", "conditioning", "fused_modconv", "w_avg_beta",
                 "randomize_noise"):
        kwarg(name)
    kwarg.finish()

    tf_params = _collect_tf_params(tf_G)
    if any(k.startswith("ToRGB_lod") or "/ToRGB_lod" in k for k in tf_params):
        raise NotImplementedError(
            "progressive-growing 'orig'-architecture TF export "
            "(ToRGB_lod variables, legacy.py:162-166): the synthesis "
            "stack is skip-architecture only")

    params: dict = {}
    _nest(params, ["mapping", "w_avg"], tf_params["dlatent_avg"])
    if cfg.c_dim > 0:
        _nest(params, ["mapping", "embed", "weight"],
              tf_params["mapping/LabelEmbed/weight"].T)
        _nest(params, ["mapping", "embed", "bias"],
              tf_params["mapping/LabelEmbed/bias"])
    for i in range(cfg.mapping_layers):
        _nest(params, ["mapping", f"fc{i}", "weight"],
              tf_params[f"mapping/Dense{i}/weight"].T)
        _nest(params, ["mapping", f"fc{i}", "bias"],
              tf_params[f"mapping/Dense{i}/bias"])

    def conv(dst_block, dst_name, src, noise_idx, *, flip=False):
        w = tf_params[f"synthesis/{src}/weight"]
        if flip:                       # up-convs: legacy.py:186
            w = w[::-1, ::-1]
        base = ["synthesis", dst_block, dst_name]
        _nest(params, base + ["weight"], w.transpose(3, 2, 0, 1))
        _nest(params, base + ["bias"], tf_params[f"synthesis/{src}/bias"])
        _nest(params, base + ["noise_const"],
              tf_params[f"synthesis/noise{noise_idx}"][0, 0])
        _nest(params, base + ["noise_strength"],
              np.asarray(tf_params[f"synthesis/{src}/noise_strength"])
              .reshape(()))
        _nest(params, base + ["affine", "weight"],
              tf_params[f"synthesis/{src}/mod_weight"].T)
        _nest(params, base + ["affine", "bias"],
              tf_params[f"synthesis/{src}/mod_bias"] + 1)

    def torgb(dst_block, src):
        base = ["synthesis", dst_block, "torgb"]
        _nest(params, base + ["weight"],
              tf_params[f"synthesis/{src}/weight"].transpose(3, 2, 0, 1))
        _nest(params, base + ["bias"], tf_params[f"synthesis/{src}/bias"])
        _nest(params, base + ["affine", "weight"],
              tf_params[f"synthesis/{src}/mod_weight"].T)
        _nest(params, base + ["affine", "bias"],
              tf_params[f"synthesis/{src}/mod_bias"] + 1)

    _nest(params, ["synthesis", "b4", "const"],
          tf_params["synthesis/4x4/Const/const"][0])
    conv("b4", "conv1", "4x4/Conv", 0)
    torgb("b4", "4x4/ToRGB")
    for res in cfg.synthesis_cfg.resolutions[1:]:
        lg = int(math.log2(res))
        conv(f"b{res}", "conv0", f"{res}x{res}/Conv0_up", lg * 2 - 5,
             flip=True)
        conv(f"b{res}", "conv1", f"{res}x{res}/Conv1", lg * 2 - 4)
        torgb(f"b{res}", f"{res}x{res}/ToRGB")

    params = _to_device(params, expected_spec(sg2_generator_init, None, cfg),
                        "tf-generator", device)
    return ConvertedSG2("generator", cfg, params)


# ---------------------------------------------------------------------------
# Discriminator (legacy.py:210-291)


def convert_tf_discriminator(tf_D, device="cpu") -> ConvertedSG2:
    """TF D network stub -> (DiscriminatorConfig, params on ``device``)."""
    from tgi_torch.io.validate import expected_spec
    from tgi_torch.nn.discriminator import (DiscriminatorConfig,
                                            discriminator_init)

    _check_version(tf_D, "discriminator")
    kwarg = _KwargReader(tf_D, "discriminator")

    cfg = DiscriminatorConfig(
        c_dim=kwarg("label_size", 0),
        img_resolution=kwarg("resolution", 1024),
        img_channels=kwarg("num_channels", 3),
        channel_base=kwarg("fmap_base", 16384) * 2,
        channel_max=kwarg("fmap_max", 512),
        mbstd_group_size=kwarg("mbstd_group_size", None),
        mbstd_num_channels=kwarg("mbstd_num_features", 1),
        conv_clamp=kwarg("conv_clamp", None),
        mapping_layers=kwarg("mapping_layers", 0),
    )
    _require(kwarg("architecture", "resnet") == "resnet", "discriminator",
             f"architecture={kwarg('architecture', 'resnet')!r}")
    _require(list(kwarg("resample_kernel", [1, 3, 3, 1], none=[1, 3, 3, 1]))
             == [1, 3, 3, 1], "discriminator",
             "a non-[1,3,3,1] resample kernel")
    _require(kwarg("nonlinearity", "lrelu") == "lrelu", "discriminator",
             f"nonlinearity={kwarg('nonlinearity', 'lrelu')!r}")
    _require(cfg.mapping_layers == 0, "discriminator",
             "a label mapping trunk (mapping_layers > 0, lrmul 0.1)")
    _require(kwarg("mapping_fmaps", None) in (None, cfg.cmap_dim),
             "discriminator", "mapping_fmaps != channels[4]")
    for name in ("structure", "conditioning", "mapping_lrmul",
                 "freeze_layers", "num_fp16_res"):
        kwarg(name)   # runtime/training knobs with no parameters
    kwarg.finish()

    tf_params = _collect_tf_params(tf_D)
    if any(k.startswith("FromRGB_lod") for k in tf_params):
        raise NotImplementedError(
            "progressive-growing 'orig'-architecture TF export "
            "(FromRGB_lod variables, legacy.py:261-265): the "
            "discriminator is resnet-architecture only")

    params: dict = {}

    def conv(dst_path, src):
        _nest(params, dst_path + ["weight"],
              tf_params[f"{src}/weight"].transpose(3, 2, 0, 1))
        if f"{src}/bias" in tf_params:
            _nest(params, dst_path + ["bias"], tf_params[f"{src}/bias"])

    def dense(dst_path, src):
        _nest(params, dst_path + ["weight"], tf_params[f"{src}/weight"].T)
        _nest(params, dst_path + ["bias"], tf_params[f"{src}/bias"])

    for res in cfg.block_resolutions:
        if res == cfg.img_resolution:
            conv([f"b{res}", "fromrgb"], f"{res}x{res}/FromRGB")
        conv([f"b{res}", "conv0"], f"{res}x{res}/Conv0")
        conv([f"b{res}", "conv1"], f"{res}x{res}/Conv1_down")
        conv([f"b{res}", "skip"], f"{res}x{res}/Skip")
    if cfg.c_dim > 0:
        dense(["mapping", "embed"], "LabelEmbed")
    conv(["b4", "conv"], "4x4/Conv")
    dense(["b4", "fc"], "4x4/Dense0")
    dense(["b4", "out"], "Output")

    params = _to_device(params, expected_spec(discriminator_init, None, cfg),
                        "tf-discriminator", device)
    return ConvertedSG2("discriminator", cfg, params)


def convert_tf_network_tuple(data, device="cpu") -> dict:
    """(G, D, Gs) tflib stub tuple -> reference-shaped dict
    (legacy.py:28-39), the params on ``device``."""
    tf_G, tf_D, tf_Gs = data
    return {
        "G": convert_tf_generator(tf_G, device),
        "D": convert_tf_discriminator(tf_D, device),
        "G_ema": convert_tf_generator(tf_Gs, device),
        "training_set_kwargs": None,
        "augment_pipe": None,
    }
