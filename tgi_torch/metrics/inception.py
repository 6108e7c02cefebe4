"""Inception-V3 feature extractor for FID/KID/PR/IS (twin of
``tgi/metrics/inception.py``).

The reference downloads NVIDIA's pickled Inception-2015-12-05 detector
at runtime (metrics/metric_utils.py:44-57; the TF classify_image graph
ported to torch). Two weight sources convert into the same param tree:

  * :func:`convert_torch_inception` — torchvision ``inception_v3``
    state_dicts (same block layout, 1000-class head);
  * :func:`convert_nvidia_inception` — NVIDIA's detector pickle (read
    code-free by ``tgi_torch.io.pickle_import``) or a state dict in its
    names, which keep the TF graph's (``layers.mixed_4.tower.conv``, ...)
    and whose head is the original 1008-class softmax.
    :func:`nvidia_state_dict` writes a params tree back in those names.

TF-2015 fidelity (the pytorch-fid patch list): average pools divide by
the window's true size (``count_include_pad=False``, the TF semantics),
and ``tf_layout=True`` switches Mixed_7c's pool branch to MAX pooling, a
quirk of the 2015-12-05 graph that torchvision's re-implementation
dropped. Images of another size are resized to 299² bilinearly with
half-pixel centres, antialiased only when downscaling, as
``jax.image.resize(method="linear")`` resizes them in ``tgi``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tgi_torch.models.irse import bn_init
from tgi_torch.nn.superres import bilinear_resize

BN_EPS = 1e-3


def _bn(p, x, eps=BN_EPS):
    scale = p["weight"] * torch.rsqrt(p["running_var"] + eps)
    shift = p["bias"] - p["running_mean"] * scale
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def _conv(x, w, stride=1, padding=(0, 0)):
    if isinstance(padding, int):
        padding = (padding, padding)
    return F.conv2d(x, w, stride=stride, padding=padding)


def _basic_conv(p, x, stride=1, padding=0):
    x = _conv(x, p["conv"]["weight"], stride=stride, padding=padding)
    if "bias" in p["conv"]:        # BN-folded weights (NVIDIA detector)
        x = x + p["conv"]["bias"][None, :, None, None]
    if "bn" in p:
        x = _bn(p["bn"], x)
    return torch.relu(x)


def _maxpool(x, k=3, s=2, pad=0):
    return F.max_pool2d(x, k, s, pad)


def _avgpool(x, k=3, s=1, pad=1):
    """Mean over the window's in-image samples (TF's padded average)."""
    return F.avg_pool2d(x, k, s, pad, count_include_pad=False)


def inception_spec():
    """Conv weight shapes ``(out, in, kh, kw)`` of every basic conv, by
    torchvision's module names: a stem name maps to its shape, a mixed
    block's name to ``{branch: shape}``."""
    spec = {}

    def bc(in_c, out_c, k):
        return (out_c, in_c, *((k, k) if isinstance(k, int) else k))

    for name, args in (("Conv2d_1a_3x3", (3, 32, 3)),
                       ("Conv2d_2a_3x3", (32, 32, 3)),
                       ("Conv2d_2b_3x3", (32, 64, 3)),
                       ("Conv2d_3b_1x1", (64, 80, 1)),
                       ("Conv2d_4a_3x3", (80, 192, 3))):
        spec[name] = bc(*args)

    for name, in_c, pool_c in (("Mixed_5b", 192, 32), ("Mixed_5c", 256, 64),
                               ("Mixed_5d", 288, 64)):
        spec[name] = {
            "branch1x1": bc(in_c, 64, 1),
            "branch5x5_1": bc(in_c, 48, 1), "branch5x5_2": bc(48, 64, 5),
            "branch3x3dbl_1": bc(in_c, 64, 1),
            "branch3x3dbl_2": bc(64, 96, 3),
            "branch3x3dbl_3": bc(96, 96, 3),
            "branch_pool": bc(in_c, pool_c, 1),
        }
    spec["Mixed_6a"] = {
        "branch3x3": bc(288, 384, 3),
        "branch3x3dbl_1": bc(288, 64, 1), "branch3x3dbl_2": bc(64, 96, 3),
        "branch3x3dbl_3": bc(96, 96, 3),
    }
    for name, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160),
                     ("Mixed_6d", 160), ("Mixed_6e", 192)):
        spec[name] = {
            "branch1x1": bc(768, 192, 1),
            "branch7x7_1": bc(768, c7, 1),
            "branch7x7_2": bc(c7, c7, (1, 7)),
            "branch7x7_3": bc(c7, 192, (7, 1)),
            "branch7x7dbl_1": bc(768, c7, 1),
            "branch7x7dbl_2": bc(c7, c7, (7, 1)),
            "branch7x7dbl_3": bc(c7, c7, (1, 7)),
            "branch7x7dbl_4": bc(c7, c7, (7, 1)),
            "branch7x7dbl_5": bc(c7, 192, (1, 7)),
            "branch_pool": bc(768, 192, 1),
        }
    spec["Mixed_7a"] = {
        "branch3x3_1": bc(768, 192, 1), "branch3x3_2": bc(192, 320, 3),
        "branch7x7x3_1": bc(768, 192, 1),
        "branch7x7x3_2": bc(192, 192, (1, 7)),
        "branch7x7x3_3": bc(192, 192, (7, 1)),
        "branch7x7x3_4": bc(192, 192, 3),
    }
    for name, in_c in (("Mixed_7b", 1280), ("Mixed_7c", 2048)):
        spec[name] = {
            "branch1x1": bc(in_c, 320, 1),
            "branch3x3_1": bc(in_c, 384, 1),
            "branch3x3_2a": bc(384, 384, (1, 3)),
            "branch3x3_2b": bc(384, 384, (3, 1)),
            "branch3x3dbl_1": bc(in_c, 448, 1),
            "branch3x3dbl_2": bc(448, 384, 3),
            "branch3x3dbl_3a": bc(384, 384, (1, 3)),
            "branch3x3dbl_3b": bc(384, 384, (3, 1)),
            "branch_pool": bc(in_c, 192, 1),
        }
    return spec


def inception_v3_init(generator, device="cuda"):
    """Random-init parameter tree with torchvision's module names: conv
    weights N(0, 0.02²) from ``generator`` (a CPU torch.Generator), the
    identity BatchNorm, no classifier (``tgi``'s init)."""
    def bc(shape):
        return {"conv": {"weight": (torch.randn(shape, generator=generator)
                                    * 0.02).to(device)},
                "bn": bn_init(shape[0], device)}

    return {name: bc(s) if isinstance(s, tuple) else
            {b: bc(bs) for b, bs in s.items()}
            for name, s in inception_spec().items()}


def inception_v3_features(params, x, tf_layout=False):
    """x: [N, 3, 299, 299] in [-1, 1] -> [N, 2048] pool3 features.

    ``tf_layout=True`` reproduces the 2015-12-05 TF graph exactly
    (NVIDIA detector weights): Mixed_7c's pool branch is a MAX pool
    there (the pytorch-fid ``FIDInceptionE_2`` patch).
    """
    def B(name, x, stride=1, padding=0):
        return _basic_conv(params[name], x, stride, padding)

    x = B("Conv2d_1a_3x3", x, 2)
    x = B("Conv2d_2a_3x3", x)
    x = B("Conv2d_2b_3x3", x, padding=1)
    x = _maxpool(x)
    x = B("Conv2d_3b_1x1", x)
    x = B("Conv2d_4a_3x3", x)
    x = _maxpool(x)

    def sub(block, name, x, stride=1, padding=0):
        return _basic_conv(params[block][name], x, stride, padding)

    for blk in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        b1 = sub(blk, "branch1x1", x)
        b5 = sub(blk, "branch5x5_2", sub(blk, "branch5x5_1", x), padding=2)
        b3 = sub(blk, "branch3x3dbl_3",
                 sub(blk, "branch3x3dbl_2",
                     sub(blk, "branch3x3dbl_1", x), padding=1), padding=1)
        bp = sub(blk, "branch_pool", _avgpool(x))
        x = torch.cat([b1, b5, b3, bp], dim=1)

    blk = "Mixed_6a"
    b3 = sub(blk, "branch3x3", x, stride=2)
    bd = sub(blk, "branch3x3dbl_3",
             sub(blk, "branch3x3dbl_2",
                 sub(blk, "branch3x3dbl_1", x), padding=1), stride=2)
    x = torch.cat([b3, bd, _maxpool(x)], dim=1)

    for blk in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        b1 = sub(blk, "branch1x1", x)
        b7 = sub(blk, "branch7x7_3",
                 sub(blk, "branch7x7_2",
                     sub(blk, "branch7x7_1", x), padding=(0, 3)),
                 padding=(3, 0))
        bd = x
        for i, pad in (("1", 0), ("2", (3, 0)), ("3", (0, 3)),
                       ("4", (3, 0)), ("5", (0, 3))):
            bd = sub(blk, f"branch7x7dbl_{i}", bd, padding=pad)
        bp = sub(blk, "branch_pool", _avgpool(x))
        x = torch.cat([b1, b7, bd, bp], dim=1)

    blk = "Mixed_7a"
    b3 = sub(blk, "branch3x3_2", sub(blk, "branch3x3_1", x), stride=2)
    b7 = sub(blk, "branch7x7x3_1", x)
    b7 = sub(blk, "branch7x7x3_2", b7, padding=(0, 3))
    b7 = sub(blk, "branch7x7x3_3", b7, padding=(3, 0))
    b7 = sub(blk, "branch7x7x3_4", b7, stride=2)
    x = torch.cat([b3, b7, _maxpool(x)], dim=1)

    for blk in ("Mixed_7b", "Mixed_7c"):
        b1 = sub(blk, "branch1x1", x)
        b3 = sub(blk, "branch3x3_1", x)
        b3 = torch.cat(
            [sub(blk, "branch3x3_2a", b3, padding=(0, 1)),
             sub(blk, "branch3x3_2b", b3, padding=(1, 0))], dim=1)
        bd = sub(blk, "branch3x3dbl_2",
                 sub(blk, "branch3x3dbl_1", x), padding=1)
        bd = torch.cat(
            [sub(blk, "branch3x3dbl_3a", bd, padding=(0, 1)),
             sub(blk, "branch3x3dbl_3b", bd, padding=(1, 0))], dim=1)
        pooled = (_maxpool(x, 3, 1, 1) if tf_layout and blk == "Mixed_7c"
                  else _avgpool(x))
        bp = sub(blk, "branch_pool", pooled)
        x = torch.cat([b1, b3, bd, bp], dim=1)

    return x.mean(dim=(2, 3))            # [N, 2048]


def resize_299(img):
    """[N, C, H, W] -> [N, C, 299, 299], bilinear with half-pixel centres,
    antialiased when downscaling (``jax.image.resize(method="linear")``)."""
    if img.shape[-2:] == (299, 299):
        return img
    return bilinear_resize(img, 299, antialias=img.shape[-1] > 299)


def inception_feature_fn(params, resize=True, tf_layout=False):
    """Returns fn(img_unit [-1,1] NCHW) -> [N, 2048]."""
    def fn(img):
        if resize:
            img = resize_299(img)
        return inception_v3_features(params, img, tf_layout=tf_layout)
    return fn


def inception_logits(params, x, tf_layout=False, no_output_bias=False):
    """[N, 3, 299, 299] -> class logits ([N, 1000] torchvision head /
    [N, 1008] NVIDIA head; the 'fc' entry of the converted tree).
    ``no_output_bias`` mirrors the reference Inception Score call
    (inception_score.py:23: detector_kwargs=dict(no_output_bias=True))."""
    feats = inception_v3_features(params, x, tf_layout=tf_layout)
    fc = params["fc"]
    logits = feats @ fc["weight"].T
    if not no_output_bias:
        logits = logits + fc["bias"]
    return logits


def nvidia_detector_fn(params, return_logits=False, no_output_bias=False):
    """The NVIDIA detector's calling convention: fn(images_255) with raw
    [N, 3, H, W] images in [0, 255], the bilinear resize to 299² and
    (x - 128) / 128 normalization (the TF classify_image graph's Sub/Mul
    preprocessing), TF-layout blocks.

    Pool features (FID/KID/PR) are returned by default;
    ``return_logits=True`` selects the 1008-way head for the Inception
    Score.
    """
    def fn(images_255):
        x = resize_299(images_255.float())
        x = (x - 128.0) / 128.0
        if return_logits:
            return inception_logits(params, x, tf_layout=True,
                                    no_output_bias=no_output_bias)
        return inception_v3_features(params, x, tf_layout=True)
    return fn


# ---------------------------------------------------------------------------
# NVIDIA Inception-2015-12-05 detector conversion
#
# The detector pickle (metric_utils.py:44-57) is a persistence-pickled
# torch module whose submodules keep the TF classify_image graph names:
# a 'layers' stack (conv, conv_1, ..., mixed, mixed_1, ..., mixed_10)
# where each mixed block nests branches as tower/tower_1/tower_2, plus
# the 1008-way 'output' linear. These tables map every TF node onto the
# torchvision-style slots used by inception_v3_features (the same
# correspondence the pytorch-fid TF->PT conversion established).

_NV_STEM = {
    "conv": "Conv2d_1a_3x3", "conv_1": "Conv2d_2a_3x3",
    "conv_2": "Conv2d_2b_3x3", "conv_3": "Conv2d_3b_1x1",
    "conv_4": "Conv2d_4a_3x3",
}
_NV_BLOCKS = {
    "mixed": "Mixed_5b", "mixed_1": "Mixed_5c", "mixed_2": "Mixed_5d",
    "mixed_3": "Mixed_6a", "mixed_4": "Mixed_6b", "mixed_5": "Mixed_6c",
    "mixed_6": "Mixed_6d", "mixed_7": "Mixed_6e", "mixed_8": "Mixed_7a",
    "mixed_9": "Mixed_7b", "mixed_10": "Mixed_7c",
}
_NV_BRANCH_A = {
    "conv": "branch1x1",
    "tower.conv": "branch5x5_1", "tower.conv_1": "branch5x5_2",
    "tower_1.conv": "branch3x3dbl_1", "tower_1.conv_1": "branch3x3dbl_2",
    "tower_1.conv_2": "branch3x3dbl_3",
    "tower_2.conv": "branch_pool",
}
_NV_BRANCH_6A = {
    "conv": "branch3x3",
    "tower.conv": "branch3x3dbl_1", "tower.conv_1": "branch3x3dbl_2",
    "tower.conv_2": "branch3x3dbl_3",
}
_NV_BRANCH_C = {
    "conv": "branch1x1",
    "tower.conv": "branch7x7_1", "tower.conv_1": "branch7x7_2",
    "tower.conv_2": "branch7x7_3",
    "tower_1.conv": "branch7x7dbl_1", "tower_1.conv_1": "branch7x7dbl_2",
    "tower_1.conv_2": "branch7x7dbl_3", "tower_1.conv_3": "branch7x7dbl_4",
    "tower_1.conv_4": "branch7x7dbl_5",
    "tower_2.conv": "branch_pool",
}
_NV_BRANCH_7A = {
    "tower.conv": "branch3x3_1", "tower.conv_1": "branch3x3_2",
    "tower_1.conv": "branch7x7x3_1", "tower_1.conv_1": "branch7x7x3_2",
    "tower_1.conv_2": "branch7x7x3_3", "tower_1.conv_3": "branch7x7x3_4",
}
_NV_BRANCH_E = {
    "conv": "branch1x1",
    "tower.conv": "branch3x3_1",
    "tower.mixed.conv": "branch3x3_2a",
    "tower.mixed.conv_1": "branch3x3_2b",
    "tower_1.conv": "branch3x3dbl_1", "tower_1.conv_1": "branch3x3dbl_2",
    "tower_1.mixed.conv": "branch3x3dbl_3a",
    "tower_1.mixed.conv_1": "branch3x3dbl_3b",
    "tower_2.conv": "branch_pool",
}
_NV_BRANCH_BY_BLOCK = {
    "Mixed_5b": _NV_BRANCH_A, "Mixed_5c": _NV_BRANCH_A,
    "Mixed_5d": _NV_BRANCH_A, "Mixed_6a": _NV_BRANCH_6A,
    "Mixed_6b": _NV_BRANCH_C, "Mixed_6c": _NV_BRANCH_C,
    "Mixed_6d": _NV_BRANCH_C, "Mixed_6e": _NV_BRANCH_C,
    "Mixed_7a": _NV_BRANCH_7A, "Mixed_7b": _NV_BRANCH_E,
    "Mixed_7c": _NV_BRANCH_E,
}
# TF batchnorm leaf spellings (gamma is fixed at 1 in the 2015 graph —
# batch_norm without scale).
_NV_BN_LEAVES = {
    "beta": "bias", "gamma": "weight",
    "mean": "running_mean", "moving_mean": "running_mean",
    "running_mean": "running_mean",
    "var": "running_var", "variance": "running_var",
    "moving_variance": "running_var", "running_var": "running_var",
}


def _f32(v, device):
    return torch.as_tensor(v).to(device=device, dtype=torch.float32)


def _nv_assemble_conv(leaves: dict, what: str, device) -> dict:
    """One TF conv node's leaves -> {'conv': ..., 'bn': ...} slot.

    Handles both layouts found in the wild: BN kept separate
    (weight + beta/mean/var, gamma implied 1) and BN folded into the
    conv (weight + bias only).
    """
    if "weight" not in leaves:
        raise ValueError(f"NVIDIA inception: {what} has no conv weight "
                         f"(leaves: {sorted(leaves)})")
    w = _f32(leaves.pop("weight"), device)
    if w.ndim != 4:
        raise ValueError(f"NVIDIA inception: {what}.weight is not a conv "
                         f"kernel (shape {tuple(w.shape)})")
    node = {"conv": {"weight": w}}
    bn = {}
    for name in list(leaves):
        if name in _NV_BN_LEAVES:
            bn[_NV_BN_LEAVES[name]] = _f32(leaves.pop(name), device)
    if bn:
        c = w.shape[0]
        f32 = dict(dtype=torch.float32, device=device)
        bn.setdefault("weight", torch.ones((c,), **f32))
        bn.setdefault("running_mean", torch.zeros((c,), **f32))
        bn.setdefault("running_var", torch.ones((c,), **f32))
        if "bias" not in bn:
            raise ValueError(f"NVIDIA inception: {what} has BN stats but "
                             "no beta")
        node["bn"] = bn
    elif "bias" in leaves:
        node["conv"]["bias"] = _f32(leaves.pop("bias"), device)
    if leaves:
        raise ValueError(f"NVIDIA inception: unconsumed leaves in {what}: "
                         f"{sorted(leaves)}")
    return node


def _check_against_spec(params, what):
    """Every slot of :func:`inception_spec` present with its shape."""
    missing = []
    for block, sub in inception_spec().items():
        slots = ({None: sub} if isinstance(sub, tuple) else sub)
        for name, shape in slots.items():
            node = (params.get(block) if name is None
                    else params.get(block, {}).get(name))
            label = block if name is None else f"{block}.{name}"
            if node is None:
                missing.append(label)
            elif tuple(node["conv"]["weight"].shape) != shape:
                raise ValueError(
                    f"{what}: {label} weight shape "
                    f"{tuple(node['conv']['weight'].shape)} != expected "
                    f"{shape}")
    if missing:
        raise ValueError(f"{what}: missing nodes: {missing[:8]}")


def convert_nvidia_inception(obj, device="cpu") -> dict:
    """NVIDIA Inception-2015-12-05 detector -> params for
    :func:`inception_v3_features` (use ``tf_layout=True`` /
    :func:`nvidia_detector_fn`), on ``device``.

    ``obj``: the loaded detector pickle — a CapturedModule from
    ``tgi_torch.io.pickle_import.ReferenceUnpickler`` — or a flat
    ``state_dict``-style mapping with the TF graph names. Every input key
    must map onto a known slot; anything unrecognized fails loudly
    (structural validation, not best-effort).
    """
    if not isinstance(obj, dict) or any(not isinstance(k, str)
                                        for k in obj):
        from tgi_torch.io.pickle_import import captured_state_dict
        obj = captured_state_dict(obj)

    # Group leaves per TF conv node.
    grouped: dict = {}
    fc_leaves: dict = {}
    unmapped = []
    for key, value in obj.items():
        if "num_batches_tracked" in key:
            continue
        parts = key.split(".")
        if parts[0] == "layers":
            parts = parts[1:]
        if parts[0] == "output" or parts[0] == "fc":
            fc_leaves[parts[-1]] = value
            continue
        head, rest = parts[0], parts[1:]
        # Drop an explicit bn submodule level: conv.bn.beta == conv.beta.
        rest = [p for p in rest if p != "bn"]
        if head in _NV_STEM:
            slot = (_NV_STEM[head],)
            leaf_path = rest
        elif head in _NV_BLOCKS:
            block = _NV_BLOCKS[head]
            table = _NV_BRANCH_BY_BLOCK[block]
            # Longest branch-path prefix match ("tower.mixed.conv" before
            # "tower.conv").
            match = None
            for blen in range(len(rest) - 1, 0, -1):
                cand = ".".join(rest[:blen])
                if cand in table:
                    match = cand
                    break
            if match is None:
                unmapped.append(key)
                continue
            slot = (block, table[match])
            leaf_path = rest[len(match.split(".")):]
        else:
            unmapped.append(key)
            continue
        if len(leaf_path) != 1:
            unmapped.append(key)
            continue
        grouped.setdefault(slot, {})[leaf_path[0]] = value
    if unmapped:
        raise ValueError("NVIDIA inception: unrecognized keys "
                         f"(not the 2015-12-05 layout?): {unmapped[:8]}")

    params: dict = {}
    for slot, leaves in grouped.items():
        node = _nv_assemble_conv(leaves, ".".join(slot), device)
        if len(slot) == 1:
            params[slot[0]] = node
        else:
            params.setdefault(slot[0], {})[slot[1]] = node
    _check_against_spec(params, "NVIDIA inception")

    if fc_leaves:
        w = _f32(fc_leaves["weight"], device)
        if w.shape[0] == 2048 and w.shape[1] != 2048:
            w = w.T.contiguous()      # TF stores [in, out]
        fc = {"weight": w}
        fc["bias"] = (_f32(fc_leaves["bias"], device) if "bias" in fc_leaves
                      else torch.zeros((w.shape[0],), dtype=torch.float32,
                                       device=device))
        params["fc"] = fc
    return params


def nvidia_state_dict(params) -> dict:
    """A params tree in the NVIDIA detector's TF-graph names (the inverse
    of :func:`convert_nvidia_inception`), as CPU tensors: each conv's
    ``weight`` with its BatchNorm as ``gamma``/``beta``/``mean``/``var``;
    the classifier (where the tree has one) as ``output.weight`` /
    ``output.bias``."""
    inv_stem = {v: k for k, v in _NV_STEM.items()}
    inv_blocks = {v: k for k, v in _NV_BLOCKS.items()}
    sd = {}

    def emit(prefix, node):
        sd[f"{prefix}.weight"] = node["conv"]["weight"].detach().cpu()
        for leaf, key in (("gamma", "weight"), ("beta", "bias"),
                          ("mean", "running_mean"), ("var", "running_var")):
            sd[f"{prefix}.{leaf}"] = node["bn"][key].detach().cpu()

    for block, sub in inception_spec().items():
        if isinstance(sub, tuple):
            emit(f"layers.{inv_stem[block]}", params[block])
            continue
        inv_branch = {v: k for k, v in _NV_BRANCH_BY_BLOCK[block].items()}
        for name in sub:
            emit(f"layers.{inv_blocks[block]}.{inv_branch[name]}",
                 params[block][name])
    if "fc" in params:
        sd["output.weight"] = params["fc"]["weight"].detach().cpu()
        sd["output.bias"] = params["fc"]["bias"].detach().cpu()
    return sd


def convert_torch_inception(sd: dict, device="cpu") -> dict:
    """torchvision inception_v3 state_dict -> params tree (fc kept for
    the Inception Score; aux head dropped), on ``device``."""
    out: dict = {}
    for name, v in sd.items():
        if "num_batches_tracked" in name or name.startswith("AuxLogits"):
            continue
        parts = name.split(".")
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _f32(v, device)
    return out


def torch_state_dict(params) -> dict:
    """A params tree as a torchvision-layout state dict of CPU tensors
    (the inverse of :func:`convert_torch_inception`)."""
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[prefix + k] = v.detach().cpu()

    walk(params, "")
    return out
