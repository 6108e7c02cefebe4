"""VGG16 feature trunk + LPIPS metric head (twin of ``tgi/models/vgg.py``).

Two reference roles:
  * NVIDIA's metric ``vgg16.pt`` with ``return_lpips=True``, the
    projection distance (w_projector.py:50-52, 215-218): unit-normalized
    per-layer features scaled by learned LPIPS weights, flattened so that
    the squared L2 between two feature vectors is the LPIPS distance;
  * torchvision ``vgg16().features`` up to layer 15, the warping-loss
    feature map (warping_loss.py:74-109).

Param names mirror torchvision's ``features.{idx}``, as in ``tgi``, so
pretrained weights port by rename (:func:`convert_torch_features`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# torchvision vgg16.features conv layout: idx -> (in, out)
VGG16_CONVS = {
    0: (3, 64), 2: (64, 64),
    5: (64, 128), 7: (128, 128),
    10: (128, 256), 12: (256, 256), 14: (256, 256),
    17: (256, 512), 19: (512, 512), 21: (512, 512),
    24: (512, 512), 26: (512, 512), 28: (512, 512),
}
VGG16_POOLS = (4, 9, 16, 23, 30)
# Last ReLU index of each LPIPS stage (relu1_2 ... relu5_3).
LPIPS_STAGES = (3, 8, 15, 22, 29)
LPIPS_CHANNELS = (64, 128, 256, 512, 512)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _scaled(c, width_mult):
    return max(1, int(round(c * width_mult)))


def vgg16_init(generator, device="cuda", width_mult: float = 1.0):
    """He-normal conv weights and zero biases from ``generator`` (a CPU
    torch.Generator), the distributions of ``tgi``'s init.
    ``width_mult < 1`` builds a channel-scaled twin (the same 13 convs;
    the apply path reads channels off the weights), for small tests; pair
    it with ``lpips_head_init(..., width_mult)``."""
    params = {"features": {}}
    for idx, (cin, cout) in VGG16_CONVS.items():
        cin = 3 if cin == 3 else _scaled(cin, width_mult)
        cout = _scaled(cout, width_mult)
        std = (2.0 / (cin * 9)) ** 0.5
        params["features"][str(idx)] = {
            "weight": (torch.randn((cout, cin, 3, 3), generator=generator)
                       * std).to(device),
            "bias": torch.zeros((cout,), device=device),
        }
    return params


def lpips_head_init(generator, device="cuda", width_mult: float = 1.0):
    """Per-stage 1x1 linear weights (lpips 'lin' layers), non-negative."""
    return {f"lin{i}": {"weight": (torch.randn((_scaled(c, width_mult),),
                                               generator=generator)
                                   * 0.1).abs().to(device)}
            for i, c in enumerate(LPIPS_CHANNELS)}


def vgg16_features(params, x, up_to: int = 15, outputs=()):
    """Run torchvision-indexed features; return the activation after
    layer ``up_to - 1``, or a dict of the requested ``outputs`` indices
    (the value after that layer)."""
    grab = set(outputs)
    collected = {}
    for idx in range(max([up_to - 1] + list(grab)) + 1):
        if idx in VGG16_CONVS:
            p = params["features"][str(idx)]
            x = F.conv2d(x, p["weight"], p["bias"], padding=1)
        elif idx in VGG16_POOLS:
            x = F.max_pool2d(x, 2)
        else:
            x = F.relu(x)
        if idx in grab:
            collected[idx] = x
    return collected if outputs else x


def warping_features(params, images):
    """'14' mode of warping_loss.get_features (warping_loss.py:78-115).

    The reference appears to return the pre-ReLU conv14 output
    (``x15 = layer_list[14](x14)``), but it computes on to x22 and layer
    15 is ``nn.ReLU(inplace=True)``: ``x16 = layer_list[15](x15)``
    overwrites x15, so the tensor it returns is the post-ReLU activation.
    ``tgi`` and the port follow the behaviour: the value after
    features[15].
    """
    return vgg16_features(params, images, outputs=(15,))[15]


def lpips_stages(params, head_params, images_255):
    """The LPIPS stages of [0, 255] images: each [N, C, H, W] activation
    unit-normalized over its channels at every position and scaled by
    the square root of the clamped LPIPS head weight."""
    dev = images_255.device
    mean = torch.tensor(IMAGENET_MEAN, device=dev)[None, :, None, None]
    std = torch.tensor(IMAGENET_STD, device=dev)[None, :, None, None]
    x = (images_255 / 255.0 - mean) / std
    acts = vgg16_features(params, x, outputs=LPIPS_STAGES)
    out = []
    for i, idx in enumerate(LPIPS_STAGES):
        a = acts[idx]
        # channel-wise unit normalization
        a = a * torch.rsqrt(torch.sum(torch.square(a), dim=1, keepdim=True)
                            + 1e-10)
        w = head_params[f"lin{i}"]["weight"]
        out.append(a * torch.sqrt(torch.clamp(w, min=0.0))[None, :, None,
                                                             None])
    return out


def lpips_features(params, head_params, images_255):
    """NVIDIA metric-VGG LPIPS embedding of [0, 255] images: a flat
    [N, D] vector such that sum((a - b)**2) between two embeddings is
    the LPIPS distance (w_projector.py:112, 215-218)."""
    N = images_255.shape[0]
    return torch.cat([(a / (a.shape[2] * a.shape[3]) ** 0.5).reshape(N, -1)
                      for a in lpips_stages(params, head_params,
                                            images_255)], dim=-1)


def lpips_distance(params, head_params, img_a, img_b):
    fa = lpips_features(params, head_params, img_a)
    fb = lpips_features(params, head_params, img_b)
    return torch.sum(torch.square(fa - fb), dim=-1)


def convert_torch_features(sd: dict, device="cpu") -> dict:
    """torchvision vgg16 state_dict ('features.0.weight', ...) -> params."""
    params = {"features": {}}
    for name, v in sd.items():
        parts = name.split(".")
        if parts[0] != "features":
            continue
        params["features"].setdefault(parts[1], {})[parts[2]] = \
            torch.as_tensor(v, dtype=torch.float32).to(device)
    return params


def convert_lpips_head(sd: dict, device="cpu") -> dict:
    """lpips-package 'lin{i}.model.1.weight' [C,1,1,1] tensors -> head."""
    head = {}
    for i in range(5):
        for k in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if k in sd:
                head[f"lin{i}"] = {"weight": torch.as_tensor(
                    sd[k], dtype=torch.float32).reshape(-1).to(device)}
    return head
