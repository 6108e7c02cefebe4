"""What the inversion shows of itself while it runs (twin of
``tgi/utils/opt_viz.py``).

Parity targets:
  * w_projector.py:193-212 — ``visualize_opt_process`` (a PNG of the
    current reconstruction every 10 steps under ``<outdir>_pivot/<name>/``)
    and ``visualize_warp_process`` (the canonical view warped to the
    predicted camera);
  * utils/log_utils.py:9-21 — wandb scalar and image logging, with a
    tensorboard writer beside it.

The snapshots hook into ``Projector.project(snapshot_fn=,
snapshot_every=)``: each is one or two deterministic float32 renders of
the current state (two tri-plane gathers each on the card), outside the
step's gradient. ``tensorboard`` (through ``torch.utils.tensorboard``)
and ``wandb`` are imported inside the writers; where they are absent,
the writers do nothing, as ``tgi``'s do.
"""

from __future__ import annotations

import os
from functools import partial

import numpy as np
import torch


def _numpy(img):
    if isinstance(img, torch.Tensor):
        return img.detach().float().cpu().numpy()
    return np.asarray(img, np.float32)


class TBWriter:
    """Tensorboard mirror of scalar and image streams; a no-op where the
    tensorboard package is missing."""

    def __init__(self, logdir):
        self._w = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._w = SummaryWriter(logdir)

    @property
    def active(self):
        return self._w is not None

    def scalar(self, tag, value, step):
        if self._w is not None:
            self._w.add_scalar(tag, float(value), int(step))

    def scalars(self, values: dict, step, prefix=""):
        for k, v in values.items():
            try:
                self.scalar(prefix + k, float(_numpy(v)), step)
            except (TypeError, ValueError):
                pass               # entries that are not scalars

    def image(self, tag, img_chw, step, input_range=(-1, 1)):
        """img_chw: [3, H, W] in input_range."""
        if self._w is None:
            return
        lo, hi = input_range
        arr = (_numpy(img_chw) - lo) / (hi - lo)
        self._w.add_image(tag, np.clip(arr, 0, 1), int(step))

    def flush(self):
        if self._w is not None:
            self._w.flush()

    def close(self):
        if self._w is not None:
            self._w.close()


class WandbWriter:
    """wandb mirror of the reference's ``use_wandb`` hooks
    (base_coach.py:107-115, utils/log_utils.py:9-21), with
    :class:`TBWriter`'s methods. The run is offline (it syncs later with
    ``wandb sync``); a no-op where the wandb package is missing."""

    def __init__(self, project="tgi", run_name=None, config=None):
        self._run = None
        self._wandb = None
        try:
            import wandb
        except ImportError:
            return
        self._run = wandb.init(project=project, name=run_name,
                               config=dict(config or {}), mode="offline")
        self._wandb = wandb

    @property
    def active(self):
        return self._run is not None

    def scalar(self, tag, value, step):
        if self._run is not None:
            self._wandb.log({tag: float(value)}, step=int(step))

    def scalars(self, values: dict, step, prefix=""):
        if self._run is None:
            return
        out = {}
        for k, v in values.items():
            try:
                out[prefix + k] = float(_numpy(v))
            except (TypeError, ValueError):
                pass
        if out:
            self._wandb.log(out, step=int(step))

    def image(self, tag, img_chw, step, input_range=(-1, 1)):
        """img_chw: [3, H, W] in input_range (log_image_from_w)."""
        if self._run is None:
            return
        lo, hi = input_range
        arr = (_numpy(img_chw) - lo) / (hi - lo)
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)
        self._wandb.log({tag: self._wandb.Image(arr)}, step=int(step))

    def flush(self):
        pass

    def close(self):
        if self._run is not None:
            self._run.finish()


class FanoutWriter:
    """Several writers as one (tensorboard and wandb together, as
    reference runs that log to both)."""

    def __init__(self, writers):
        self.writers = [w for w in writers if w is not None]

    @property
    def active(self):
        return any(w.active for w in self.writers)

    def scalar(self, tag, value, step):
        for w in self.writers:
            w.scalar(tag, value, step)

    def scalars(self, values, step, prefix=""):
        for w in self.writers:
            w.scalars(values, step, prefix=prefix)

    def image(self, tag, img_chw, step, input_range=(-1, 1)):
        for w in self.writers:
            w.image(tag, img_chw, step, input_range=input_range)

    def flush(self):
        for w in self.writers:
            w.flush()

    def close(self):
        for w in self.writers:
            w.close()


def make_projection_snapshotter(proj, out_dir, name, *, save_warp=True,
                                tb=None):
    """A ``snapshot_fn(step, state, target_255)`` for
    ``Projector.project``.

    Renders the current (w, camera) state deterministically in float32
    and saves ``<out_dir>_pivot/<name>/<step>.png`` (w_projector.py:
    196-199) and, with ``save_warp``, the canonical view warped into the
    predicted camera as ``warp_<step>.png`` (w_projector.py:207-212, kept
    under the run's output directory; without it the canonical view is
    not rendered); ``tb`` gets the images saved.
    """
    from tgi_torch.invert.projector import merge_noise
    from tgi_torch.losses.warp import calc_warping_loss
    from tgi_torch.models.vgg import warping_features
    from tgi_torch.utils.image import save_image

    pivot_dir = f"{out_dir}_pivot/{name}"
    os.makedirs(pivot_dir, exist_ok=True)
    G = proj.G

    @torch.no_grad()
    def render(state, target_255):
        pred_ext, pred_cam = proj.camera(state["pose"], state["translation"],
                                         target_255)
        ws = state["w"].repeat(1, G.cfg.num_ws, 1)
        params = merge_noise(proj.base_params, state["noise"])
        pred = G.synthesis(params, ws, pred_cam, noise_mode="const",
                           det=True, force_fp32=True)
        if not save_warp:
            return pred["image"], None
        canon = G.synthesis(params, ws, proj.canonical_cam,
                            noise_mode="const", det=True, force_fp32=True)
        _, warped = calc_warping_loss(
            canon["image"], partial(warping_features, proj.vgg_params),
            pred_ext, proj.init_ext, proj.intrinsic[None],
            pred["image_depth"], target_255 / 127.5 - 1.0)
        return pred["image"], warped

    def snapshot(step, state, target_255):
        img, warped = render(state, target_255)
        save_image(os.path.join(pivot_dir, f"{int(step)}.png"), img[0])
        if tb is not None:
            tb.image(f"{name}/reconstruction", img[0], step)
        if warped is not None:
            save_image(os.path.join(pivot_dir, f"warp_{int(step)}.png"),
                       warped[0])
            if tb is not None:
                tb.image(f"{name}/warp", warped[0], step)

    return snapshot
