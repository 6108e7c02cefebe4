"""ArcFace IR-SE50 backbone for the identity loss (twin of
``tgi/models/arcface.py``).

Behavioral parity target: models/facial_recognition/model_irse.py:9-50
(Backbone(input_size=112, num_layers=50, mode='ir_se')): trunk -> BN ->
flatten -> linear(512*7*7 -> 512) -> BN1d -> l2-normalize. Dropout is
inference-off.
"""

from __future__ import annotations

import torch

from tgi_torch.models.irse import (batchnorm, bn_init, scaled, trunk_apply,
                                   trunk_init)


def arcface_init(generator, num_layers=50, device="cuda",
                 width_mult: float = 1.0):
    """Random weights from ``generator`` (a CPU torch.Generator) with
    ``tgi``'s distributions; ``width_mult`` scales every channel count,
    the embedding's 512 included (a small twin for tests)."""
    params = trunk_init(generator, num_layers=num_layers, se=True,
                        device=device, width_mult=width_mult)
    c = scaled(512, width_mult)
    params["output_layer"] = {
        "0": bn_init(c, device),
        "3": {"weight": (torch.randn((c, c * 7 * 7), generator=generator)
                         * 0.01).to(device),
              "bias": torch.zeros((c,), device=device)},
        "4": bn_init(c, device),
    }
    return params


def arcface_apply(params, x, num_layers=50):
    """x: [N, 3, 112, 112] -> l2-normalized [N, 512] embeddings."""
    x = trunk_apply(params, x, num_layers=num_layers, se=True)
    ol = params["output_layer"]
    x = batchnorm(ol["0"], x)
    x = x.reshape(x.shape[0], -1)
    x = x @ ol["3"]["weight"].T + ol["3"]["bias"]
    bn = ol["4"]
    x = ((x - bn["running_mean"]) * torch.rsqrt(bn["running_var"] + 1e-5)
         * bn["weight"] + bn["bias"])
    return x / torch.linalg.norm(x, dim=1, keepdim=True)


def convert_torch_state_dict(sd: dict, device="cpu") -> dict:
    """Port a torch Backbone state_dict by structural rename."""
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
