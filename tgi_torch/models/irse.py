"""IR / IR-SE residual blocks shared by the ArcFace and e4e encoders (twin
of ``tgi/models/irse.py``).

Behavioral parity target: models/e4e/encoders/helpers.py:22-121
(bottleneck_IR, bottleneck_IR_SE, SEModule, get_blocks). Param names
follow the torch Sequential indices (res_layer.0 = BN, .1 = conv, ...) so
pretrained ir_se50 checkpoints port by rename.

BatchNorm runs on its running statistics (these encoders are always used
in eval mode in the pipeline, run_pti.py:33-51).

``width_mult < 1`` (the port's own knob, as in ``models/vgg.py``) scales
every channel count for small tests; the apply path reads the channels
off the weights, so the same functions run both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv(x, w, stride=1, padding=0, bias=None):
    return F.conv2d(x, w.to(x.dtype),
                    None if bias is None else bias.to(x.dtype),
                    stride=stride, padding=padding)


def batchnorm(p, x, eps=1e-5):
    scale = p["weight"] * torch.rsqrt(p["running_var"] + eps)
    shift = p["bias"] - p["running_mean"] * scale
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def prelu(p, x):
    a = p["weight"].to(x.dtype)[None, :, None, None]
    return torch.where(x >= 0, x, a * x)


def bn_init(c, device="cuda"):
    return {"weight": torch.ones((c,), device=device),
            "bias": torch.zeros((c,), device=device),
            "running_mean": torch.zeros((c,), device=device),
            "running_var": torch.ones((c,), device=device)}


def conv_init(generator, out_c, in_c, k, device="cuda"):
    """He-normal [out_c, in_c, k, k] from ``generator`` (a CPU
    torch.Generator), moved to ``device``."""
    std = (2.0 / (in_c * k * k)) ** 0.5
    return (torch.randn((out_c, in_c, k, k), generator=generator)
            * std).to(device)


def scaled(c, width_mult):
    return max(1, int(round(c * width_mult)))


def get_blocks(num_layers: int):
    """(in_channel, depth, stride) specs (helpers.py:26-54)."""
    def block(in_c, depth, num_units, stride=2):
        return [(in_c, depth, stride)] + [(depth, depth, 1)] * (num_units - 1)

    if num_layers == 50:
        units = [(64, 64, 3), (64, 128, 4), (128, 256, 14), (256, 512, 3)]
    elif num_layers == 100:
        units = [(64, 64, 3), (64, 128, 13), (128, 256, 30), (256, 512, 3)]
    elif num_layers == 152:
        units = [(64, 64, 3), (64, 128, 8), (128, 256, 36), (256, 512, 3)]
    else:
        raise ValueError(num_layers)
    out = []
    for in_c, depth, n in units:
        out += block(in_c, depth, n)
    return out


def se_module_init(generator, channels, reduction=16, device="cuda"):
    # max(1, ...) only matters below full width.
    mid = max(1, channels // reduction)
    return {"fc1": {"weight": conv_init(generator, mid, channels, 1, device)},
            "fc2": {"weight": conv_init(generator, channels, mid, 1, device)}}


def se_module_apply(p, x):
    s = x.mean(dim=(2, 3), keepdim=True)
    s = F.relu(conv(s, p["fc1"]["weight"]))
    s = torch.sigmoid(conv(s, p["fc2"]["weight"]))
    return x * s


def bottleneck_init(generator, in_c, depth, stride, se: bool,
                    device="cuda"):
    p = {"res_layer": {
        "0": bn_init(in_c, device),
        "1": {"weight": conv_init(generator, depth, in_c, 3, device)},
        "2": {"weight": torch.full((depth,), 0.25, device=device)},  # PReLU
        "3": {"weight": conv_init(generator, depth, depth, 3, device)},
        "4": bn_init(depth, device),
    }}
    if se:
        p["res_layer"]["5"] = se_module_init(generator, depth, device=device)
    if in_c != depth:
        p["shortcut_layer"] = {
            "0": {"weight": conv_init(generator, depth, in_c, 1, device)},
            "1": bn_init(depth, device)}
    return p


def bottleneck_apply(p, x, stride, se: bool):
    if "shortcut_layer" in p:
        shortcut = batchnorm(p["shortcut_layer"]["1"],
                             conv(x, p["shortcut_layer"]["0"]["weight"],
                                  stride=stride))
    else:
        # MaxPool2d(1, stride): pure stride-subsampling.
        shortcut = x[:, :, ::stride, ::stride]
    r = p["res_layer"]
    y = batchnorm(r["0"], x)
    y = conv(y, r["1"]["weight"], padding=1)
    y = prelu(r["2"], y)
    y = conv(y, r["3"]["weight"], stride=stride, padding=1)
    y = batchnorm(r["4"], y)
    if se:
        y = se_module_apply(r["5"], y)
    return y + shortcut


def trunk_init(generator, num_layers=50, se=True, device="cuda",
               width_mult: float = 1.0):
    """input_layer + body of the IR(-SE) trunk, drawn from ``generator``
    (a CPU torch.Generator) with ``tgi``'s distributions."""
    c64 = scaled(64, width_mult)
    params = {"input_layer": {
        "0": {"weight": conv_init(generator, c64, 3, 3, device)},
        "1": bn_init(c64, device),
        "2": {"weight": torch.full((c64,), 0.25, device=device)}}}
    params["body"] = {
        str(i): bottleneck_init(generator, scaled(in_c, width_mult),
                                scaled(d, width_mult), s, se, device)
        for i, (in_c, d, s) in enumerate(get_blocks(num_layers))}
    return params


def trunk_apply(params, x, num_layers=50, se=True, taps=()):
    """Run input_layer + body; with ``taps``, also return the activations
    after those body block indices (e4e uses 6 / 20 / 23)."""
    il = params["input_layer"]
    x = prelu(il["2"], batchnorm(il["1"], conv(x, il["0"]["weight"],
                                               padding=1)))
    collected = {}
    for i, (_, _, s) in enumerate(get_blocks(num_layers)):
        x = bottleneck_apply(params["body"][str(i)], x, s, se)
        if i in taps:
            collected[i] = x
    return (x, collected) if taps else x
