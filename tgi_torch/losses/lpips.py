"""LPIPS perceptual distance (twin of ``tgi/losses/lpips.py``, AlexNet
backbone).

The tuning stage's loss is the lpips package's ``LPIPS(net='alex')``
(base_coach.py:48, configs/hyperparameters.py:2), so the 0.06 early-stop
threshold keeps its calibration. The VGG form, which the projector uses,
comes with stage 1 (ROADMAP Queue A items 6-7).
"""

from __future__ import annotations

import torch

from tgi_torch.models.alexnet import (alex_head_init, alex_lpips_distance,
                                      alex_lpips_embed, alexnet_init)


class AlexLPIPSLoss:
    """``lpips.LPIPS(net='alex')``; native input range is [-1, 1].

    Without weights, the trunk and head are drawn from ``generator`` (a
    CPU torch.Generator, seed 0 when absent) on ``device``.
    """

    def __init__(self, alex_params=None, head_params=None, generator=None,
                 device="cuda"):
        if alex_params is None:
            generator = generator or torch.Generator().manual_seed(0)
            alex_params = alexnet_init(generator, device)
            head_params = alex_head_init(generator, device)
        self.alex_params = alex_params
        self.head_params = head_params

    def features(self, images_255):
        return alex_lpips_embed(self.alex_params, self.head_params,
                                images_255 / 127.5 - 1.0)

    def __call__(self, img_a_255, img_b_255):
        return self.from_unit(img_a_255 / 127.5 - 1.0,
                              img_b_255 / 127.5 - 1.0)

    def from_unit(self, a, b):
        return alex_lpips_distance(self.alex_params, self.head_params, a, b)


def make_lpips(lpips_type: str, *, alex_params=None, alex_head=None,
               generator=None, device="cuda"):
    """Factory mirroring ``LPIPS(net=hyperparameters.lpips_type)``."""
    if lpips_type == "alex":
        return AlexLPIPSLoss(alex_params, alex_head, generator=generator,
                             device=device)
    if lpips_type == "vgg":
        raise NotImplementedError(
            "VGG-LPIPS comes with stage 1 (ROADMAP Queue A item 6: "
            "models/vgg.py, LPIPSLoss)")
    raise ValueError(f"unknown lpips_type {lpips_type!r}")
