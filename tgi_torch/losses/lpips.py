"""LPIPS perceptual distance, VGG and AlexNet backbones (twin of
``tgi/losses/lpips.py``).

The projector uses the NVIDIA feature-vector form with VGG
(w_projector.py:215-218). The tuning stage's loss is the lpips package's
``LPIPS(net='alex')`` (base_coach.py:48, configs/hyperparameters.py:2),
so the 0.06 early-stop threshold keeps its calibration; ``lpips_type=
"vgg"`` tunes with the VGG form instead.
"""

from __future__ import annotations

import torch

from tgi_torch.models.alexnet import (alex_head_init, alex_lpips_distance,
                                      alex_lpips_embed, alexnet_init)
from tgi_torch.models.vgg import (lpips_distance, lpips_features,
                                  lpips_head_init, vgg16_init)


class LPIPSLoss:
    """VGG trunk and LPIPS head with the call forms of ``tgi``'s; native
    input range is [0, 255].

    Without weights, the trunk and head are drawn from ``generator`` (a
    CPU torch.Generator, seed 0 when absent) on ``device``.
    """

    def __init__(self, vgg_params=None, head_params=None, generator=None,
                 device="cuda"):
        if vgg_params is None:
            generator = generator or torch.Generator().manual_seed(0)
            vgg_params = vgg16_init(generator, device)
            head_params = lpips_head_init(generator, device)
        self.vgg_params = vgg_params
        self.head_params = head_params

    def features(self, images_255):
        return lpips_features(self.vgg_params, self.head_params, images_255)

    def __call__(self, img_a_255, img_b_255):
        return lpips_distance(self.vgg_params, self.head_params,
                              img_a_255, img_b_255)

    def from_unit(self, a, b):
        """Distance for images in [-1, 1] (the tuning-stage call form)."""
        return self((a + 1) * 127.5, (b + 1) * 127.5)


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


def make_lpips(lpips_type: str, *, vgg_params=None, vgg_head=None,
               alex_params=None, alex_head=None, generator=None,
               device="cuda"):
    """Factory mirroring ``LPIPS(net=hyperparameters.lpips_type)``."""
    if lpips_type == "alex":
        return AlexLPIPSLoss(alex_params, alex_head, generator=generator,
                             device=device)
    if lpips_type == "vgg":
        return LPIPSLoss(vgg_params, vgg_head, generator=generator,
                         device=device)
    raise ValueError(f"unknown lpips_type {lpips_type!r}")
