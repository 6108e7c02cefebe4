"""Managed training snapshots (counterpart of ``tgi/io/orbax_io.py``).

``tgi`` hands its periodic training snapshots to orbax's
``CheckpointManager``: versioned step directories with retention,
written asynchronously. The port keeps the module's name and its three
functions, and the manager's semantics, but imports no orbax (JAX's
library). It writes the port's own format: each finished step is a
directory ``<directory>/<step>/`` holding one ``io/checkpoints.py`` file,
``state.ckpt``, whose metadata carries the state's numbers (the
training loop's ``cur_nimg``). It cannot read a ``tgi`` orbax directory,
and ``tgi`` cannot read one of its.

* A step is written under a temporary name (``<step>.tmp-<n>``) and
  renamed when complete, as orbax finalises a step; a save cut by a kill
  leaves only a temporary directory, which no listing, restore or
  retention counts.
* After each finalise the oldest finished steps beyond ``max_to_keep``
  are deleted.
* ``save`` copies the state to host memory on the caller's thread (the
  optimiser then updates the state in place) and writes the file on one
  background thread; a new save first waits for the one before it. An
  error of the writer is raised again at the next ``save`` or at
  ``wait_until_finished``.
"""

from __future__ import annotations

import os
import shutil
import threading
import time

import torch

from tgi_torch.io.checkpoints import load_checkpoint, save_checkpoint

STATE_FILE = "state.ckpt"


def _host_copy(tree):
    """A CPU copy of every tensor of ``tree`` that shares no storage
    with it."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


def _number(v):
    return v.item() if torch.is_tensor(v) else v


def _placed(tree, template, path=()):
    """``tree`` with every tensor on its ``template`` leaf's device; the
    two must have the same keys and shapes."""
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            raise ValueError(f"snapshot tree at {'/'.join(path) or '/'} "
                             f"does not match the template")
        return {k: _placed(tree[k], template[k], path + (k,))
                for k in template}
    if tuple(tree.shape) != tuple(template.shape):
        raise ValueError(f"snapshot leaf {'/'.join(path)}: shape "
                         f"{tuple(tree.shape)}, template "
                         f"{tuple(template.shape)}")
    return tree.to(template.device)


class SnapshotManager:
    """Finished steps of ``directory`` and their saving; see the module's
    docstring."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._writer = None
        self._error = None

    def all_steps(self) -> list[int]:
        """The finished steps, oldest first."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.isfile(
                          os.path.join(self.directory, name, STATE_FILE)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict) -> bool:
        """Save ``state`` = {"params": a tree of tensors, and numbers such
        as "cur_nimg"} as step ``step``, in the background; True, as
        orbax's ``save`` returns when it saves."""
        self.wait_until_finished()
        step = int(step)
        if step in self.all_steps():
            raise ValueError(f"step {step} already exists in "
                             f"{self.directory}")
        params = _host_copy(state["params"])
        metadata = {k: _number(v) for k, v in state.items()
                    if k != "params"}
        self._writer = threading.Thread(
            target=self._write, args=(step, params, metadata),
            name=f"snapshot-{step}")
        self._writer.start()
        return True

    def _write(self, step, params, metadata):
        try:
            tmp = os.path.join(self.directory, f"{step}.tmp-{time.time_ns()}")
            os.makedirs(tmp)
            save_checkpoint(os.path.join(tmp, STATE_FILE), params,
                            metadata={**metadata, "step": step})
            os.rename(tmp, os.path.join(self.directory, str(step)))
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        except Exception as e:          # raised again on the caller's thread
            self._error = e

    def wait_until_finished(self):
        """Wait for the save in flight; raise its error, if it had one."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def restore(self, step: int, template=None) -> dict:
        """Step ``step`` as saved: {"params": ..., and its numbers}, the
        tensors on ``template["params"]``'s devices (which must have the
        same tree) or on the CPU."""
        data = load_checkpoint(os.path.join(self.directory, str(int(step)),
                                            STATE_FILE))
        params = data["params"]
        if template is not None:
            params = _placed(params, template["params"])
        metadata = dict(data["metadata"] or {})
        metadata.pop("step", None)
        return {"params": params, **metadata}


def make_manager(directory: str, max_to_keep: int = 5):
    return SnapshotManager(directory, max_to_keep=max_to_keep)


def save_step(manager, step: int, state) -> bool:
    return manager.save(step, state)


def restore_latest(manager, template=None):
    """Restore the newest finished step into the structure of
    ``template``. Returns (state, step), or (None, None) when the
    directory holds no finished step."""
    step = manager.latest_step()
    if step is None:
        return None, None
    return manager.restore(step, template), step
