"""Training statistics (twin of ``tgi/utils/stats.py``).

Behavioral parity target: torch_utils/training_stats.py:25-270 — per-name
[count, sum, sum-of-squares] moment triples, collected to mean/std, in
one process. Under a data-parallel mesh (``tgi_torch.parallel``) the
trainer's metrics are already means over the ranks, so rank 0's
collector sees the global batch's.
"""

from __future__ import annotations

import json
import re
import time

import numpy as np
import torch


def moment(value) -> np.ndarray:
    """[count, sum, sum_sq] of an arbitrary tensor (training_stats.py:58),
    float32 as ``tgi`` computes it."""
    if isinstance(value, torch.Tensor):
        value = value.detach().float().cpu().numpy()
    v = np.asarray(value, np.float32).reshape(-1)
    return np.stack([np.float32(v.size), v.sum(dtype=np.float32),
                     np.square(v).sum(dtype=np.float32)])


class Collector:
    """Accumulates named moments; regex-filtered reporting
    (training_stats.py Collector)."""

    def __init__(self, regex: str = ".*"):
        self.regex = re.compile(regex)
        self._moments: dict[str, np.ndarray] = {}

    def report(self, name: str, value):
        self._moments[name] = self._moments.get(name, 0) + moment(value)

    def update(self, metrics: dict):
        for k, v in metrics.items():
            self.report(k, v)

    def mean(self, name: str) -> float:
        m = self._moments.get(name)
        if m is None or m[0] == 0:
            return float("nan")
        return float(m[1] / m[0])

    def std(self, name: str) -> float:
        m = self._moments.get(name)
        if m is None or m[0] == 0:
            return float("nan")
        mean = m[1] / m[0]
        var = max(m[2] / m[0] - mean ** 2, 0)
        return float(np.sqrt(var))

    def as_dict(self) -> dict:
        return {k: {"mean": self.mean(k), "std": self.std(k),
                    "num": float(v[0])}
                for k, v in self._moments.items()
                if self.regex.fullmatch(k)}

    def reset(self):
        self._moments.clear()


class JsonlLogger:
    """stats.jsonl writer (training_loop.py:336-446 logging tier)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def write(self, record: dict):
        record = {"timestamp": time.time(), **record}
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
