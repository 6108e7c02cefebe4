"""Tracing / profiling utilities (twin of ``tgi/utils/profiling.py``).

Behavioral parity target: torch_utils/misc.py:102-111 (profiled_function /
record_function scopes) and the per-phase CUDA timing of
training_loop.py:219-225: named ``torch.profiler`` scopes, and phase
times on the host clock after a device synchronisation.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch


def profiled_function(fn):
    """Annotate a function in profiler traces (misc.profiled_function)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(fn.__name__):
            return fn(*args, **kwargs)
    return wrapper


@contextlib.contextmanager
def record_scope(name: str):
    """Named trace scope (torch.autograd.profiler.record_function)."""
    with torch.profiler.record_function(name):
        yield


class PhaseTimer:
    """Wall-clock phase timing that waits for ``device`` (a CUDA device:
    ``torch.cuda.synchronize``; the CPU: nothing to wait for) at each
    end. Accumulates {name: seconds}."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, device=None):
        def sync():
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
        sync()
        t0 = time.perf_counter()
        yield
        sync()
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def means_ms(self) -> dict[str, float]:
        return {k: self.totals[k] / self.counts[k] * 1e3 for k in self.totals}


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a host and device trace (a Chrome trace file under
    ``log_dir``, viewable in TensorBoard or Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)):
        yield


def check_numerics(tree, name="tree"):
    """Raise where a nested dict of tensors holds a NaN or Inf (the
    reference's nan_to_num guard, for explicit call sites)."""
    bad = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}[{k!r}]")
        elif not bool(torch.isfinite(node).all()):
            bad.append(path)
    walk(tree, "")
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:10]}")
