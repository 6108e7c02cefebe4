"""Parameter-tree summary table (twin of ``tgi/utils/summary.py``).

Parity target: torch_utils/misc.py:212-265 (print_module_summary) — the
reference prints a per-module table of parameter/buffer counts and output
shapes after construction. The port's modules are dicts of tensors, so
the summary walks the tree instead of hooking a forward pass; any leaf
with a ``shape`` (a tensor or a numpy array) counts.
"""

from __future__ import annotations

import numpy as np


def _walk(tree, prefix, rows, max_depth):
    depth = prefix.count(".") + 1 if prefix else 0
    if not isinstance(tree, dict) or (max_depth is not None
                                      and depth >= max_depth):
        leaves = _leaves(tree)
        n = sum(int(np.prod(s)) for s, _ in leaves)
        rows.append((prefix or "<root>", n, _shape_str(leaves)))
        return
    leaf_items = {k: v for k, v in tree.items() if not isinstance(v, dict)}
    if leaf_items:
        leaves = _leaves(leaf_items)
        n = sum(int(np.prod(s)) for s, _ in leaves)
        rows.append((prefix or "<root>", n, _shape_str(leaves)))
    for k, v in tree.items():
        if isinstance(v, dict):
            _walk(v, f"{prefix}.{k}" if prefix else k, rows, max_depth)


def _leaves(tree):
    out = []

    def rec(node):
        if isinstance(node, dict):
            for v in node.values():
                rec(v)
        elif hasattr(node, "shape"):
            out.append((tuple(node.shape), getattr(node, "dtype", None)))

    rec(tree)
    return out


def _shape_str(leaves):
    if not leaves:
        return "-"
    if len(leaves) == 1:
        return str(list(leaves[0][0]))
    return f"{len(leaves)} tensors"


def module_summary(params: dict, max_depth: int | None = 2) -> str:
    """Render a summary table of a params pytree.

    Args:
        params: nested dict of tensors (a module's params).
        max_depth: collapse subtrees deeper than this many dots
            (None = full depth).

    Returns the formatted table (misc.py:248-264 layout: name, params,
    shape columns plus a total row).
    """
    rows: list = []
    _walk(params, "", rows, max_depth)
    total = sum(int(np.prod(s)) for s, _ in _leaves(params))
    name_w = max([len(r[0]) for r in rows] + [len("Total")])
    num_w = max([len(f"{r[1]:,}") for r in rows] + [len(f"{total:,}")])
    lines = [f"{'Name':<{name_w}}  {'Params':>{num_w}}  Shape"]
    lines.append("-" * (name_w + num_w + 10))
    for name, n, shape in rows:
        lines.append(f"{name:<{name_w}}  {n:>{num_w},}  {shape}")
    lines.append("-" * (name_w + num_w + 10))
    lines.append(f"{'Total':<{name_w}}  {total:>{num_w},}")
    return "\n".join(lines)


def print_module_summary(params: dict, max_depth: int | None = 2):
    out = module_summary(params, max_depth)
    print(out)
    return out
