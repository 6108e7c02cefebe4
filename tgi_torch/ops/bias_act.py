"""Fused bias + activation + gain + clamp (twin of ``tgi/ops/bias_act.py``).

Plain PyTorch elementwise math: the JAX package left this chain to XLA's
fusion, so it has no TPU kernel to port. Semantics follow the reference
op (torch_utils/ops/bias_act.py:54-126): the default gain is the
activation's variance-preserving gain, and clamping is symmetric.

The chain runs in the input's dtype. As in ``tgi``, whose Python
constants take the array's dtype, ``alpha`` and ``gain`` are rounded to
that dtype first (a no-op for float32).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class ActivationSpec:
    func: Callable
    def_alpha: float
    def_gain: float


activation_funcs: dict[str, ActivationSpec] = {
    "linear": ActivationSpec(lambda x, alpha: x, 0.0, 1.0),
    "relu": ActivationSpec(lambda x, alpha: torch.relu(x), 0.0, math.sqrt(2)),
    "lrelu": ActivationSpec(lambda x, alpha: torch.where(x >= 0, x, x * alpha),
                            0.2, math.sqrt(2)),
    "tanh": ActivationSpec(lambda x, alpha: torch.tanh(x), 0.0, 1.0),
    "sigmoid": ActivationSpec(lambda x, alpha: torch.sigmoid(x), 0.0, 1.0),
    "elu": ActivationSpec(lambda x, alpha: F.elu(x), 0.0, 1.0),
    "selu": ActivationSpec(lambda x, alpha: F.selu(x), 0.0, 1.0),
    "softplus": ActivationSpec(lambda x, alpha: F.softplus(x), 0.0, 1.0),
    "swish": ActivationSpec(lambda x, alpha: torch.sigmoid(x) * x, 0.0,
                            math.sqrt(2)),
}


@functools.lru_cache(maxsize=None)
def _rounded(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``."""
    return float(torch.tensor(v, dtype=dtype))


def bias_act(x: torch.Tensor, b: torch.Tensor | None = None, dim: int = 1,
             act: str = "linear", alpha: float | None = None,
             gain: float | None = None,
             clamp: float | None = None) -> torch.Tensor:
    """Add bias along ``dim``, apply ``act``, scale by ``gain``, clamp.

    ``b`` is ``[C]``, or ``[N, C]`` with one bias per image: then ``dim``
    is not 0 and ``x`` is ``[N, ...]``."""
    spec = activation_funcs[act]
    alpha = _rounded(spec.def_alpha if alpha is None else alpha, x.dtype)
    gain = _rounded(spec.def_gain if gain is None else gain, x.dtype)

    if b is not None:
        assert 0 <= dim < x.ndim
        shape = [-1 if i == dim else 1 for i in range(x.ndim)]
        if b.ndim == 2:
            assert dim > 0 and tuple(b.shape) == (x.shape[0], x.shape[dim])
            shape[0] = x.shape[0]
        else:
            assert b.ndim == 1 and b.shape[0] == x.shape[dim]
        x = x + b.to(x.dtype).reshape(shape)
    x = spec.func(x, alpha)
    if gain != 1:
        x = x * gain
    if clamp is not None:
        assert clamp >= 0
        x = torch.clamp(x, -clamp, clamp)
    return x
