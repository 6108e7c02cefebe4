"""e4e (Encoder4Editing) latent initializer (twin of ``tgi/models/e4e.py``).

Behavioral parity target: models/e4e/encoders/psp_encoders.py:124-200 +
models/e4e/psp.py:17-64 (pSp2). The IR-SE50 trunk feeds an FPN whose
GradualStyleBlocks produce w0 + progressive per-layer deltas; the pSp2
wrapper used by the inversion pipeline returns only ``codes[:, 0, :]``
(psp.py:64), i.e. styles[0](c3), which :func:`e4e_encode_w0` computes.
The full progressive encoder is :func:`e4e_apply`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tgi_torch.models.irse import (conv, conv_init, scaled, trunk_apply,
                                   trunk_init)

STYLE_COUNT = 18           # log2(1024)*2 - 2 (psp_encoders.py:147)
COARSE_IND = 3
MIDDLE_IND = 7
TAPS = (6, 20, 23)         # c1 (128ch), c2 (256ch), c3 (512ch)


def _spatial(i):
    return 16 if i < COARSE_IND else (32 if i < MIDDLE_IND else 64)


def _equal_linear_init(generator, in_f, out_f, device):
    # rosinality EqualLinear: weight ~ N(0,1)/lr_mul, runtime scale
    # 1/sqrt(in_f).
    return {"weight": torch.randn((out_f, in_f), generator=generator)
            .to(device), "bias": torch.zeros((out_f,), device=device)}


def _equal_linear_apply(p, x):
    scale = 1.0 / math.sqrt(p["weight"].shape[1])
    return x @ (p["weight"].T * scale) + p["bias"]


def gradual_style_block_init(generator, in_c, out_c, spatial,
                             device="cuda"):
    num_pools = int(math.log2(spatial))
    convs = {"0": {"weight": conv_init(generator, out_c, in_c, 3, device),
                   "bias": torch.zeros((out_c,), device=device)}}
    for i in range(1, num_pools):
        convs[str(2 * i)] = {
            "weight": conv_init(generator, out_c, out_c, 3, device),
            "bias": torch.zeros((out_c,), device=device)}
    return {"convs": convs,
            "linear": _equal_linear_init(generator, out_c, out_c, device)}


def gradual_style_block_apply(p, x, spatial):
    for i in range(int(math.log2(spatial))):
        c = p["convs"][str(2 * i)]
        x = conv(x, c["weight"], stride=2, padding=1, bias=c["bias"])
        x = F.leaky_relu(x, 0.01)       # nn.LeakyReLU's default slope
    return _equal_linear_apply(p["linear"], x.reshape(x.shape[0], -1))


def _upsample_add(x, y):
    """Bilinear ``align_corners=True`` upsample of x to y's size, plus y
    (helpers.py:124-140)."""
    return F.interpolate(x, size=y.shape[-2:], mode="bilinear",
                         align_corners=True) + y


def e4e_init(generator, num_layers=50, device="cuda",
             width_mult: float = 1.0):
    """Random weights from ``generator`` (a CPU torch.Generator) with
    ``tgi``'s distributions. ``width_mult`` scales every channel count,
    the codes' 512 included (a small twin for tests)."""
    params = trunk_init(generator, num_layers=num_layers, se=True,
                        device=device, width_mult=width_mult)
    c = scaled(512, width_mult)
    params["styles"] = {
        str(i): gradual_style_block_init(generator, c, c, _spatial(i),
                                         device)
        for i in range(STYLE_COUNT)}
    params["latlayer1"] = {
        "weight": conv_init(generator, c, scaled(256, width_mult), 1, device),
        "bias": torch.zeros((c,), device=device)}
    params["latlayer2"] = {
        "weight": conv_init(generator, c, scaled(128, width_mult), 1, device),
        "bias": torch.zeros((c,), device=device)}
    return params


def e4e_apply(params, x, num_layers=50, progressive_stage=STYLE_COUNT):
    """x: [N, 3, 256, 256] (raw [0, 255] as the pipeline feeds it) ->
    [N, 18, 512] w+ codes."""
    _, taps = trunk_apply(params, x, num_layers=num_layers, se=True,
                          taps=TAPS)
    c1, c2, c3 = taps[6], taps[20], taps[23]
    w0 = gradual_style_block_apply(params["styles"]["0"], c3, 16)
    codes = [w0]
    features = c3
    p2 = None
    for i in range(1, STYLE_COUNT):
        if i > progressive_stage:
            codes.append(w0)
            continue
        if i == COARSE_IND:
            p2 = _upsample_add(c3, conv(c2, params["latlayer1"]["weight"],
                                        bias=params["latlayer1"]["bias"]))
            features = p2
        elif i == MIDDLE_IND:
            features = _upsample_add(p2, conv(
                c1, params["latlayer2"]["weight"],
                bias=params["latlayer2"]["bias"]))
        codes.append(w0 + gradual_style_block_apply(
            params["styles"][str(i)], features, _spatial(i)))
    return torch.stack(codes, dim=1)


def e4e_encode_w0(params, x, num_layers=50):
    """pSp2.forward equivalent: only the first style code (psp.py:64)."""
    _, taps = trunk_apply(params, x, num_layers=num_layers, se=True,
                          taps=(23,))
    return gradual_style_block_apply(params["styles"]["0"], taps[23], 16)


def convert_psp_checkpoint(ckpt: dict, validate: bool = True,
                           device="cpu"):
    """Port a published e4e/pSp checkpoint -> (params, latent_avg or
    None), tensors on ``device``.

    Handles the real artifact layouts:

    * the reference's own initializer: ``DataParallel(pSp2)`` state_dict
      (scripts/run_pti.py:33-49), keys ``module.encoder.*``;
    * the official e4e-repo full dump (psp.py:31-40): weights under
      ``state_dict`` with ``encoder.`` / ``decoder.`` prefixes plus a
      top-level ``latent_avg``; only the ``encoder.`` subtree (psp.py:36)
      and ``latent_avg`` are loaded;
    * a bare ``Encoder4Editing.state_dict()`` dump (no prefixes).

    ``decoder.`` (a rosinality SG2 the pipeline never calls) and ``opts``
    are ignored. With ``validate`` the tree is checked against
    ``e4e_init``'s at full width (keys and shapes), so a wrong file fails
    with the difference instead of mis-nesting.
    """
    from tgi_torch.io.validate import e4e_spec, validate_tree

    def tensor(v):
        return torch.as_tensor(v, dtype=torch.float32).to(device)

    latent_avg = tensor(ckpt["latent_avg"]) if "latent_avg" in ckpt else None
    sd = ckpt.get("state_dict", ckpt)
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in sd.items()}
    has_prefix = any(k.startswith("encoder.") for k in sd)
    params: dict = {}
    for name, v in sd.items():
        if has_prefix:
            if not name.startswith("encoder."):
                continue            # decoder.* / face_pool / opts etc.
            name = name[len("encoder."):]
        elif name.startswith("decoder.") or "." not in name:
            continue
        if "num_batches_tracked" in name or "progressive_stage" in name:
            continue
        parts = name.split(".")
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = tensor(v)
    if validate:
        validate_tree(params, e4e_spec(), "e4e encoder")
    return params, latent_avg
