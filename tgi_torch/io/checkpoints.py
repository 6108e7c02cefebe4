"""The port's generator checkpoints (twin of ``tgi/io/checkpoints.py``).

A params dict of tensors plus the model's config, written with
``torch.save`` and read with ``torch.load(weights_only=True)``: the file
holds data only, and the architecture lives in the config, carried as
JSON. ``tgi`` writes flax msgpack; that format has no twin here, so a
checkpoint crosses between the packages as arrays
(``io.from_jax.params_from_numpy``), not as a file.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu()


def save_checkpoint(path: str, params, config=None,
                    metadata: dict | None = None):
    """Write params (+ optional dataclass config and metadata) to ``path``
    atomically (a temporary file, then a rename)."""
    payload = {"params": _to_cpu(params)}
    if metadata:
        payload["metadata"] = metadata
    if config is not None:
        cfg = (dataclasses.asdict(config)
               if dataclasses.is_dataclass(config) else dict(config))
        payload["config_json"] = json.dumps(cfg)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, device="cpu"):
    """Returns {'params': ..., 'config': dict|None, 'metadata': dict|None},
    the params on ``device``."""
    payload = torch.load(path, map_location=device, weights_only=True)
    config = (json.loads(payload["config_json"])
              if "config_json" in payload else None)
    return {"params": payload["params"], "config": config,
            "metadata": payload.get("metadata")}
