"""Parameters from the JAX package's pytrees.

``tgi`` params are nested dicts whose keys mirror the reference
``state_dict`` and whose array layouts are already PyTorch's (OIHW conv
weights, ``[out, in]`` dense weights: ``tgi/nn/layers.py:36-74``). So
the conversion keeps every key verbatim and copies every leaf.

The caller turns the JAX arrays into numpy first
(``jax.tree.map(np.asarray, params)``); this module never imports jax.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cuda"):
    """Nested dict of numpy arrays -> the same dict of float tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind != "f":
        raise TypeError(f"expected a float array, got {arr.dtype}")
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device)
