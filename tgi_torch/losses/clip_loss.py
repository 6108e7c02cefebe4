"""CLIP text-image loss (twin of ``tgi/losses/clip_loss.py``).

Behavioral parity target: the reference's criteria/clip_loss.py:6-18 —
``avg_pool(upsample(image))`` then ``1 - model(image, text)[0] / 100``:

- ``Upsample(scale_factor=7)`` is torch's default *nearest* mode;
- ``AvgPool2d(kernel_size=stylegan_size // 32)`` with stride = kernel,
  so for a 512-px image: 512 * 7 = 3584 -> / 16 = 224;
- the reference divides by the hard-coded 100 (not the checkpoint's
  ``exp(logit_scale)``) and does NOT apply CLIP's preprocessing
  normalisation to the [-1, 1] generator output. Both quirks are kept,
  as ``tgi`` keeps them.
"""

from __future__ import annotations

from tgi_torch.models.clip import ClipConfig, clip_apply


def clip_pool(image, stylegan_size: int | None = None):
    """Nearest-upsample x7, then average-pool (clip_loss.py:10-14)."""
    n, c, h, w = image.shape
    if stylegan_size is None:
        stylegan_size = h
    k = stylegan_size // 32
    x = image.repeat_interleave(7, dim=2).repeat_interleave(7, dim=3)
    hh, ww = x.shape[2] // k, x.shape[3] // k
    return x.reshape(n, c, hh, k, ww, k).mean(dim=(3, 5))


def clip_loss(clip_params, image, token_ids,
              cfg: ClipConfig = ClipConfig(),
              stylegan_size: int | None = None):
    """[N_img, N_txt] CLIP distance, ``1 - logits_per_image / 100``."""
    pooled = clip_pool(image, stylegan_size)
    logits_per_image, _ = clip_apply(clip_params, pooled, token_ids, cfg)
    return 1.0 - logits_per_image / 100.0
