"""Mapping network z (+c) -> w with truncation (twin of
``tgi/nn/mapping.py``; parity target networks_stylegan2.py:192-271).

``w_avg`` is a tensor of the params dict: truncation reads it and
:func:`update_w_avg` returns params with its moving average advanced.
"""

from __future__ import annotations

import torch

from tgi_torch.nn.layers import (fully_connected_apply, fully_connected_init,
                                 normalize_2nd_moment)


def mapping_network_init(generator, z_dim, c_dim, w_dim, num_ws,
                         num_layers=8, embed_features=None,
                         layer_features=None, device="cuda"):
    if embed_features is None:
        embed_features = w_dim
    if c_dim == 0:
        embed_features = 0
    if layer_features is None:
        layer_features = w_dim
    features = ([z_dim + embed_features] + [layer_features] * (num_layers - 1)
                + [w_dim])
    params = {}
    for i in range(num_layers):
        params[f"fc{i}"] = fully_connected_init(
            generator, features[i], features[i + 1], lr_multiplier=0.01,
            device=device)
    if c_dim > 0:
        params["embed"] = fully_connected_init(generator, c_dim,
                                               embed_features, device=device)
    params["w_avg"] = torch.zeros((w_dim,), dtype=torch.float32,
                                  device=device)
    return params


def mapping_network_apply(params, z, c, *, z_dim, c_dim, num_ws,
                          num_layers=8, truncation_psi=1.0,
                          truncation_cutoff=None):
    """Returns ws of shape [N, num_ws, w_dim] (or [N, w_dim] if num_ws None)."""
    x = None
    if z_dim > 0:
        x = normalize_2nd_moment(z.float())
    if c_dim > 0:
        y = normalize_2nd_moment(fully_connected_apply(params["embed"],
                                                       c.float()))
        x = torch.cat([x, y], dim=1) if x is not None else y
    for i in range(num_layers):
        x = fully_connected_apply(params[f"fc{i}"], x, activation="lrelu",
                                  lr_multiplier=0.01)
    if num_ws is not None:
        x = x[:, None, :].repeat(1, num_ws, 1)
    if truncation_psi != 1:
        w_avg = params["w_avg"]
        if num_ws is None or truncation_cutoff is None:
            x = w_avg + truncation_psi * (x - w_avg)
        else:
            trunc = w_avg + truncation_psi * (x[:, :truncation_cutoff] - w_avg)
            x = torch.cat([trunc, x[:, truncation_cutoff:]], dim=1)
    return x


def update_w_avg(params, ws_detached, beta=0.998):
    """Functional EMA update of w_avg (reference update_emas path): the
    params with ``w_avg`` moved toward the batch mean of ``ws_detached``
    [N, w_dim]; ``params`` is not changed."""
    mean_w = ws_detached.mean(dim=0)
    return {**params, "w_avg": mean_w + (params["w_avg"] - mean_w) * beta}
