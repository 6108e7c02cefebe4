"""Symbolic shape assertions at module boundaries (twin of
``tgi/utils/shapes.py``)."""

from __future__ import annotations


def assert_shape(x, ref, name: str = "tensor"):
    """ref: sequence of ints or None (wildcard). Raises AssertionError
    with a readable message on mismatch."""
    shape = tuple(x.shape)
    if len(shape) != len(ref):
        raise AssertionError(
            f"{name}: wrong rank {len(shape)} (shape {shape}), "
            f"expected {len(ref)} ({tuple(ref)})")
    for i, (got, want) in enumerate(zip(shape, ref)):
        if want is not None and got != want:
            raise AssertionError(
                f"{name}: dim {i} is {got}, expected {want} "
                f"(shape {shape} vs {tuple(ref)})")
