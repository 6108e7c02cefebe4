"""Fused multiply-add (twin of ``tgi/ops/fma.py``)."""


def fma(a, b, c):
    """a * b + c with broadcasting."""
    return a * b + c
