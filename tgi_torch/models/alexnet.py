"""AlexNet feature trunk + LPIPS metric head, the lpips package's
``LPIPS(net='alex')`` (twin of ``tgi/models/alexnet.py``).

The reference tunes stage 2 with AlexNet-LPIPS (configs/hyperparameters.py:2
``lpips_type = 'alex'``; training/coaches/base_coach.py:48) and early-stops
at LPIPS <= 0.06 on that scale (single_id_coach.py:69).

Architecture (torchvision ``alexnet().features`` layout, as sliced by the
lpips package):

    0 Conv(3,64,k11,s4,p2)  1 ReLU          -> stage 1 (relu1)
    2 MaxPool(k3,s2)  3 Conv(64,192,k5,p2)   4 ReLU   -> stage 2
    5 MaxPool         6 Conv(192,384,k3,p1)  7 ReLU   -> stage 3
    8 Conv(384,256,k3,p1)  9 ReLU                      -> stage 4
    10 Conv(256,256,k3,p1) 11 ReLU                     -> stage 5

Param names mirror the torch state_dict (``features.{idx}`` /
``lin{l}``), as in ``tgi``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# torchvision alexnet.features conv layout: idx -> (cin, cout, kernel,
# stride, pad)
ALEXNET_CONVS = {
    0: (3, 64, 11, 4, 2),
    3: (64, 192, 5, 1, 2),
    6: (192, 384, 3, 1, 1),
    8: (384, 256, 3, 1, 1),
    10: (256, 256, 3, 1, 1),
}
ALEXNET_POOLS = (2, 5)          # only pools BEFORE the last lpips stage
# Last ReLU index of each LPIPS stage (relu1 .. relu5).
ALEX_STAGES = (1, 4, 7, 9, 11)
ALEX_CHANNELS = (64, 192, 384, 256, 256)

# lpips ScalingLayer constants (lpips/lpips.py): input is in [-1, 1].
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def alexnet_init(generator, device="cuda"):
    """He-normal conv weights and zero biases from ``generator`` (a CPU
    torch.Generator), the distributions of ``tgi``'s init."""
    params = {"features": {}}
    for idx, (cin, cout, ksz, _, _) in ALEXNET_CONVS.items():
        std = (2.0 / (cin * ksz * ksz)) ** 0.5
        params["features"][str(idx)] = {
            "weight": (torch.randn((cout, cin, ksz, ksz), generator=generator)
                       * std).to(device),
            "bias": torch.zeros((cout,), device=device),
        }
    return params


def alex_head_init(generator, device="cuda"):
    """Per-stage 1x1 linear weights (lpips 'lin' layers), non-negative."""
    return {f"lin{i}": {"weight": (torch.randn((c,), generator=generator)
                                   * 0.1).abs().to(device)}
            for i, c in enumerate(ALEX_CHANNELS)}


def alexnet_stage_features(params, x):
    """Run the trunk on pre-scaled input; return the 5 stage activations."""
    acts = []
    for idx in range(ALEX_STAGES[-1] + 1):
        if idx in ALEXNET_CONVS:
            _, _, _, stride, pad = ALEXNET_CONVS[idx]
            p = params["features"][str(idx)]
            x = F.conv2d(x, p["weight"], p["bias"], stride=stride,
                         padding=pad)
        elif idx in ALEXNET_POOLS:
            x = F.max_pool2d(x, 3, 2)   # VALID, as tgi's reduce_window
        else:
            x = F.relu(x)
        if idx in ALEX_STAGES:
            acts.append(x)
    return acts


def alex_lpips_embed(params, head_params, images_unit):
    """LPIPS feature embedding of [-1, 1] images: flat [N, D] vectors whose
    squared L2 difference is ``lpips.LPIPS(net='alex')(a, b)``.

    Scaling layer, per-stage channel unit normalisation
    ``x / (||x||_c + 1e-10)``, lin-layer weights, spatial average (folded
    in as 1/sqrt(HW)).
    """
    shift = images_unit.new_tensor(_SHIFT)[None, :, None, None]
    scale = images_unit.new_tensor(_SCALE)[None, :, None, None]
    acts = alexnet_stage_features(params, (images_unit - shift) / scale)
    N = images_unit.shape[0]
    feats = []
    for i, a in enumerate(acts):
        norm = torch.sqrt(torch.sum(torch.square(a), dim=1, keepdim=True))
        a = a / (norm + 1e-10)
        w = head_params[f"lin{i}"]["weight"]
        a = a * torch.sqrt(torch.clamp(w, min=0.0))[None, :, None, None]
        hw = a.shape[2] * a.shape[3]
        feats.append((a / hw ** 0.5).reshape(N, -1))
    return torch.cat(feats, dim=-1)


def alex_lpips_distance(params, head_params, img_a_unit, img_b_unit):
    """lpips.LPIPS(net='alex')(a, b) for [-1, 1] images -> [N]."""
    fa = alex_lpips_embed(params, head_params, img_a_unit)
    fb = alex_lpips_embed(params, head_params, img_b_unit)
    return torch.sum(torch.square(fa - fb), dim=-1)


def convert_lpips_alex(sd: dict) -> tuple[dict, dict]:
    """lpips-package ``LPIPS(net='alex')`` state_dict -> (trunk, head) of
    numpy float32 arrays (``io.from_jax.params_from_numpy`` makes them
    tensors).

    Handles both the full-model dict (``net.slice1.0.weight`` /
    ``lin0.model.1.weight``, also the ``lins.0...`` alias) and a bare
    torchvision ``alexnet`` dict (``features.0.weight``) for the trunk.
    """
    convs = {str(i) for i in ALEXNET_CONVS}

    def arr(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.asarray(v, np.float32)

    # lpips slices net.slice{k}.{torchvision idx}: slice boundaries are at
    # the stage ReLUs, so the inner index is the torchvision features index.
    params = {"features": {}}
    head = {}
    for name, v in sd.items():
        parts = name.split(".")
        if (len(parts) == 4 and parts[0].startswith("net")
                and parts[1].startswith("slice") and parts[2] in convs):
            params["features"].setdefault(parts[2], {})[parts[3]] = arr(v)
        elif len(parts) == 3 and parts[0] == "features" and parts[1] in convs:
            params["features"].setdefault(parts[1], {})[parts[2]] = arr(v)
    for i in range(5):
        for k in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if k in sd:
                head[f"lin{i}"] = {"weight": arr(sd[k]).reshape(-1)}
    return params, head
