"""OSG decoder: the tiny MLP turning aggregated tri-plane features into
(sigma, rgb-features) (twin of ``tgi/render/decoder.py``; parity target
training/triplane.py:113-136)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tgi_torch.nn.layers import fully_connected_apply, fully_connected_init


def osg_decoder_init(generator, n_features=32, hidden_dim=64, output_dim=32,
                     device="cuda"):
    return {
        "net0": fully_connected_init(generator, n_features, hidden_dim,
                                     device=device),
        "net1": fully_connected_init(generator, hidden_dim, 1 + output_dim,
                                     device=device),
    }


def osg_decoder_apply(params, sampled_features, lr_multiplier=1.0):
    """sampled_features: [N, 3, M, C] -> {'rgb': [N, M, out], 'sigma': [N, M, 1]}.

    With per-image weights (``[N, O, I]`` leaves, ``nn/layers.py``)
    image n's M points go through decoder n."""
    x = sampled_features.mean(dim=1)                # aggregate planes [N,M,C]
    N, M, C = x.shape
    if params["net0"]["weight"].ndim == 2:
        x = x.reshape(N * M, C)
    x = fully_connected_apply(params["net0"], x, lr_multiplier=lr_multiplier)
    x = F.softplus(x)
    x = fully_connected_apply(params["net1"], x, lr_multiplier=lr_multiplier)
    x = x.reshape(N, M, -1)
    rgb = torch.sigmoid(x[..., 1:]) * (1 + 2 * 0.001) - 0.001
    sigma = x[..., 0:1]
    return {"rgb": rgb, "sigma": sigma}
