"""ResNet-34 pose estimator (twin of ``tgi/models/pose_resnet.py``).

Behavioral parity target: scripts/resnet/resnet.py:124-368 (torchvision
ResNet fork with a configurable ``output_dims`` head: 2 = euler
yaw/pitch, 4 = quaternion, 6 = 6D rotation; scripts/run_pti.py:36-45).

Param names mirror the torchvision state_dict (conv1, bn1, layer{1-4}.{i}.
conv{1,2}/bn{1,2}/downsample), so pretrained ``pose_estimator.pt``
weights port by rename (:func:`convert_torch_state_dict`).

BatchNorm runs on its running statistics, never in training mode, as
the reference's ``.eval()`` copy does (w_projector.py:62). The statistics
enter the forward through :func:`_bn`'s explicit formula, as in ``tgi``,
so they receive gradients; stage 1's camera Adam updates them as ``tgi``
does (ROADMAP Queue C, differences by design).

B pose nets run in one forward when every leaf carries a leading image
axis (:func:`stack_nets`): image b of ``x`` [B, 3, H, W] goes through
net b, its convolutions grouped B ways. Each image keeps its own
BatchNorm statistics, so nothing mixes images.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCKS_34 = (3, 4, 6, 3)
WIDTHS = (64, 128, 256, 512)


def _bn(params, x, eps=1e-5):
    scale = params["weight"] * torch.rsqrt(params["running_var"] + eps)
    shift = params["bias"] - params["running_mean"] * scale
    if scale.ndim == 1:
        scale, shift = scale[None], shift[None]
    return x * scale[:, :, None, None] + shift[:, :, None, None]


def _conv(x, w, stride=1, padding=0):
    """F.conv2d; a per-image weight [B, O, I, k, k] convolves image b of
    x [B, I, H, W] with weight b, as one grouped conv."""
    if w.ndim == 4:
        return F.conv2d(x, w, stride=stride, padding=padding)
    B, O, I, k, _ = w.shape
    y = F.conv2d(x.reshape(1, B * I, *x.shape[2:]), w.reshape(B * O, I, k, k),
                 stride=stride, padding=padding, groups=B)
    return y.reshape(B, O, *y.shape[2:])


def _linear(params, x):
    w, b = params["weight"], params["bias"]
    if w.ndim == 2:
        return x @ w.T + b
    return torch.einsum("bi,boi->bo", x, w) + b


def stack_nets(nets):
    """One tree from B pose nets' trees: each leaf stacked on a new
    leading axis."""
    if isinstance(nets[0], dict):
        return {k: stack_nets([n[k] for n in nets]) for k in nets[0]}
    return torch.stack(nets)


def _bn_init(c, device):
    return {"weight": torch.ones((c,), device=device),
            "bias": torch.zeros((c,), device=device),
            "running_mean": torch.zeros((c,), device=device),
            "running_var": torch.ones((c,), device=device)}


def resnet34_init(generator, output_dims: int = 6, device="cuda",
                  width_mult: float = 1.0, blocks=BLOCKS_34):
    """Random weights from ``generator`` (a CPU torch.Generator), the
    distributions of ``tgi``'s init: He-normal convs, identity BatchNorm,
    the head's linears uniform in ±1/sqrt(fan_in). ``width_mult`` and
    ``blocks`` shrink the net (the same residual topology; the apply
    path reads both off the params) for small tests."""
    def sc(c):
        return max(1, int(round(c * width_mult)))

    def conv(out_c, in_c, k):
        std = (2.0 / (in_c * k * k)) ** 0.5
        return (torch.randn((out_c, in_c, k, k), generator=generator)
                * std).to(device)

    def linear(out_f, in_f):
        bound = (1.0 / in_f) ** 0.5
        w = torch.rand((out_f, in_f), generator=generator) * 2 - 1
        b = torch.rand((out_f,), generator=generator) * 2 - 1
        return {"weight": (w * bound).to(device),
                "bias": (b * bound).to(device)}

    params = {"conv1": {"weight": conv(sc(64), 3, 7)},
              "bn1": _bn_init(sc(64), device)}
    in_c = sc(64)
    widths = tuple(sc(w) for w in WIDTHS)
    for li, (n_blocks, width) in enumerate(zip(blocks, widths), start=1):
        layer = {}
        for bi in range(n_blocks):
            stride = 2 if (li > 1 and bi == 0) else 1
            block = {"conv1": {"weight": conv(width, in_c, 3)},
                     "bn1": _bn_init(width, device),
                     "conv2": {"weight": conv(width, width, 3)},
                     "bn2": _bn_init(width, device)}
            if stride != 1 or in_c != width:
                block["downsample"] = {"0": {"weight": conv(width, in_c, 1)},
                                       "1": _bn_init(width, device)}
            layer[str(bi)] = block
            in_c = width
        params[f"layer{li}"] = layer
    # Reference head: fc(512->1000) -> relu -> fc2(1000->128) -> relu ->
    # fc3(128->output_dims) -> tanh (scripts/resnet/resnet.py:158-224).
    params["fc"] = linear(sc(1000), widths[-1])
    params["fc2"] = linear(sc(128), sc(1000))
    params["fc3"] = linear(output_dims, sc(128))
    return params


def _stride(li, bi):
    return 2 if (li > 1 and bi == 0) else 1


def _basic_block(params, x, stride):
    identity = x
    out = _conv(x, params["conv1"]["weight"], stride=stride, padding=1)
    out = F.relu(_bn(params["bn1"], out))
    out = _conv(out, params["conv2"]["weight"], padding=1)
    out = _bn(params["bn2"], out)
    if "downsample" in params:
        identity = _bn(params["downsample"]["1"],
                       _conv(x, params["downsample"]["0"]["weight"],
                             stride=stride))
    return F.relu(out + identity)


def _stem(params, x):
    x = _conv(x, params["conv1"]["weight"], stride=2, padding=3)
    x = F.relu(_bn(params["bn1"], x))
    return F.max_pool2d(x, 3, stride=2, padding=1)


def resnet34_apply(params, x, pre_tanh=False):
    """x: [N, 3, H, W] -> [N, output_dims]; with a stacked tree
    (:func:`stack_nets`) N is the number of nets, one image each.

    ``pre_tanh=True`` returns the final layer's pre-activation."""
    x = _stem(params, x)
    for li in range(1, len(BLOCKS_34) + 1):
        # Block counts read off the params, for depth-scaled twins.
        for bi in range(len(params[f"layer{li}"])):
            x = _basic_block(params[f"layer{li}"][str(bi)], x, _stride(li, bi))
    x = x.mean(dim=(2, 3))  # adaptive avg pool to 1x1
    x = F.relu(_linear(params["fc"], x))
    x = F.relu(_linear(params["fc2"], x))
    x = _linear(params["fc3"], x)
    return x if pre_tanh else torch.tanh(x)


def _bn_calibrated(params, x, eps=1e-5):
    """BN params whose running statistics are the actual per-channel
    statistics of ``x`` over (N, H, W), population variance."""
    return {**params, "running_mean": x.mean(dim=(0, 2, 3)),
            "running_var": torch.clamp(
                x.var(dim=(0, 2, 3), unbiased=False), min=eps)}


def resnet34_calibrate(params, x):
    """Set every BatchNorm's running statistics to those of the
    activations that input ``x`` gives it, layer by layer (each BN sees
    the output of the already-calibrated prefix); returns new params.

    A randomly initialised ResNet-34 with identity statistics compounds
    the activations' variance through 34 layers, saturating tanh; the
    reference's estimator is pretrained with O(1) activations. Calibrating
    on the target restores that operating point without weights. Conv
    and fc weights are untouched."""
    params = dict(params)
    y = F.conv2d(x, params["conv1"]["weight"], stride=2, padding=3)
    params["bn1"] = _bn_calibrated(params["bn1"], y)
    y = F.max_pool2d(F.relu(_bn(params["bn1"], y)), 3, stride=2, padding=1)
    for li in range(1, len(BLOCKS_34) + 1):
        layer = dict(params[f"layer{li}"])
        for bi in range(len(layer)):
            stride = _stride(li, bi)
            block = dict(layer[str(bi)])
            out = F.conv2d(y, block["conv1"]["weight"], stride=stride,
                           padding=1)
            block["bn1"] = _bn_calibrated(block["bn1"], out)
            out = F.relu(_bn(block["bn1"], out))
            out = F.conv2d(out, block["conv2"]["weight"], padding=1)
            block["bn2"] = _bn_calibrated(block["bn2"], out)
            out = _bn(block["bn2"], out)
            identity = y
            if "downsample" in block:
                ds = dict(block["downsample"])
                idn = F.conv2d(y, ds["0"]["weight"], stride=stride)
                ds["1"] = _bn_calibrated(ds["1"], idn)
                identity = _bn(ds["1"], idn)
                block["downsample"] = ds
            y = F.relu(out + identity)
            layer[str(bi)] = block
        params[f"layer{li}"] = layer
    return params


def convert_torch_state_dict(sd: dict, device="cpu") -> dict:
    """torchvision-style ResNet state_dict {name: tensor or array} ->
    params tree."""
    out: dict = {}
    for name, v in sd.items():
        if "num_batches_tracked" in name:
            continue
        parts = name.split(".")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.as_tensor(v, dtype=torch.float32).to(device)
    return out
