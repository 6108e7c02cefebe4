"""Structural validation for converted checkpoints (twin of
``tgi/io/validate.py``).

Every weight converter (reference generator pickle, pose ResNet, VGG,
LPIPS heads, e4e, ArcFace) is a structural rename of a torch ``state_dict`` into the
port's params tree. A file with the wrong layout would otherwise mis-nest
silently and fail deep inside an apply, or behave like random weights.
``validate_tree`` compares a converted tree against the expected one
(keys and leaf shapes) and fails with the exact difference.

The expected tree comes from the module's own ``init`` run on the
``meta`` device (shapes only: no draws, no memory), where ``tgi`` uses
``jax.eval_shape``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def tree_spec(tree: Any, prefix: str = "") -> dict[str, tuple]:
    """Flatten a params tree to {'a.b.c': shape}."""
    out: dict[str, tuple] = {}
    if isinstance(tree, dict):
        for k in tree:
            out.update(tree_spec(tree[k], f"{prefix}{k}."))
        return out
    shape = tuple(tree.shape) if hasattr(tree, "shape") \
        else tuple(np.shape(tree))
    out[prefix[:-1]] = shape
    return out


def expected_spec(init_fn, *args, **kwargs) -> dict[str, tuple]:
    """Shapes of ``init_fn(*args, **kwargs)``'s tree, from a run on the
    meta device (``init_fn`` takes a ``device`` keyword, as every init of
    the port does)."""
    with torch.device("meta"):
        tree = init_fn(*args, **{**kwargs, "device": "meta"})
    return tree_spec(tree)


def e4e_spec(width_mult: float = 1.0) -> dict[str, tuple]:
    """The e4e encoder's tree (IR-SE50 trunk, 18 style blocks, two
    lateral layers), full width unless ``width_mult`` says otherwise."""
    from tgi_torch.models.e4e import e4e_init
    return expected_spec(e4e_init, None, width_mult=width_mult)


def arcface_spec(width_mult: float = 1.0) -> dict[str, tuple]:
    """The ArcFace IR-SE50 backbone's tree, full width unless
    ``width_mult`` says otherwise."""
    from tgi_torch.models.arcface import arcface_init
    return expected_spec(arcface_init, None, width_mult=width_mult)


def validate_tree(got: Any, expected: dict[str, tuple] | Any,
                  name: str) -> Any:
    """Check ``got`` has exactly the keys+shapes of ``expected``.

    expected: either a spec dict from ``tree_spec``/``expected_spec`` or
    a params tree (converted here). Returns ``got`` on success; raises
    ValueError listing missing / unexpected / shape-mismatched leaves.
    """
    if not isinstance(expected, dict) or any(
            isinstance(v, dict) for v in expected.values()):
        expected = tree_spec(expected)
    got_spec = tree_spec(got)
    missing = sorted(set(expected) - set(got_spec))
    extra = sorted(set(got_spec) - set(expected))
    bad = sorted(k for k in set(expected) & set(got_spec)
                 if tuple(expected[k]) != tuple(got_spec[k]))
    if not (missing or extra or bad):
        return got

    def head(items, fmt):
        lines = [fmt(k) for k in items[:8]]
        if len(items) > 8:
            lines.append(f"    ... and {len(items) - 8} more")
        return lines

    msg = [f"{name}: converted checkpoint does not match the expected "
           f"parameter layout ({len(expected)} leaves expected, "
           f"{len(got_spec)} converted):"]
    if missing:
        msg += [f"  missing {len(missing)} leaves:"] + head(
            missing, lambda k: f"    {k} {tuple(expected[k])}")
    if extra:
        msg += [f"  unexpected {len(extra)} leaves:"] + head(
            extra, lambda k: f"    {k} {tuple(got_spec[k])}")
    if bad:
        msg += [f"  shape mismatches ({len(bad)}):"] + head(
            bad, lambda k: f"    {k}: expected {tuple(expected[k])}, "
                           f"got {tuple(got_spec[k])}")
    msg.append("  (wrong weight file for this option?)")
    raise ValueError("\n".join(msg))
