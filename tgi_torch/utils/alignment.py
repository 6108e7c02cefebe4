"""FFHQ-style face alignment from 68 landmarks (twin of
``tgi/utils/alignment.py``; numpy and Pillow on the host, Pillow and
scipy imported where they are used).

Behavioral parity target: utils/alignment.py:9-114 (align_face) +
utils/align_data.py. The reference detects landmarks with dlib (not a
dependency here); the landmark source is pluggable —
``align_face(img, landmarks)`` takes any 68-point array (dlib layout),
and ``align_directory`` accepts a landmarks .json/.npy sidecar. The
quad/transform math reproduces the FFHQ recipe.
"""

from __future__ import annotations

import json
import os

import numpy as np


def compute_alignment_quad(lm: np.ndarray):
    """68-point landmarks -> (quad [4,2], qsize) per the FFHQ recipe
    (reference utils/alignment.py:29-68)."""
    lm_eye_left = lm[36:42]
    lm_eye_right = lm[42:48]
    lm_mouth_outer = lm[48:60]

    eye_left = np.mean(lm_eye_left, axis=0)
    eye_right = np.mean(lm_eye_right, axis=0)
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    mouth_left = lm_mouth_outer[0]
    mouth_right = lm_mouth_outer[6]
    mouth_avg = (mouth_left + mouth_right) * 0.5
    eye_to_mouth = mouth_avg - eye_avg

    x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
    x /= np.hypot(*x)
    x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
    y = np.flipud(x) * [-1, 1]
    c = eye_avg + eye_to_mouth * 0.1
    quad = np.stack([c - x - y, c - x + y, c + x + y, c + x - y])
    qsize = np.hypot(*x) * 2
    return quad, qsize


def align_face(img, landmarks: np.ndarray, output_size: int = 1024,
               transform_size: int = 4096, enable_padding: bool = True):
    """Warp a PIL image to the FFHQ-aligned crop
    (utils/alignment.py:70-114)."""
    from PIL import Image

    quad, qsize = compute_alignment_quad(np.asarray(landmarks, np.float64))

    # Shrink.
    shrink = int(np.floor(qsize / output_size * 0.5))
    if shrink > 1:
        rsize = (int(np.rint(img.size[0] / shrink)),
                 int(np.rint(img.size[1] / shrink)))
        img = img.resize(rsize, Image.LANCZOS)
        quad /= shrink
        qsize /= shrink

    # Crop.
    border = max(int(np.rint(qsize * 0.1)), 3)
    crop = (int(np.floor(min(quad[:, 0]))), int(np.floor(min(quad[:, 1]))),
            int(np.ceil(max(quad[:, 0]))), int(np.ceil(max(quad[:, 1]))))
    crop = (max(crop[0] - border, 0), max(crop[1] - border, 0),
            min(crop[2] + border, img.size[0]),
            min(crop[3] + border, img.size[1]))
    if crop[2] - crop[0] < img.size[0] or crop[3] - crop[1] < img.size[1]:
        img = img.crop(crop)
        quad -= crop[0:2]

    # Pad.
    pad = (int(np.floor(min(quad[:, 0]))), int(np.floor(min(quad[:, 1]))),
           int(np.ceil(max(quad[:, 0]))), int(np.ceil(max(quad[:, 1]))))
    pad = (max(-pad[0] + border, 0), max(-pad[1] + border, 0),
           max(pad[2] - img.size[0] + border, 0),
           max(pad[3] - img.size[1] + border, 0))
    if enable_padding and max(pad) > border - 4:
        pad = np.maximum(pad, int(np.rint(qsize * 0.3)))
        arr = np.pad(np.float32(img),
                     ((pad[1], pad[3]), (pad[0], pad[2]), (0, 0)), "reflect")
        h, w, _ = arr.shape
        y, x, _ = np.ogrid[:h, :w, :1]
        mask = np.maximum(
            1.0 - np.minimum(np.float32(x) / pad[0] if pad[0] else 1.0,
                             np.float32(w - 1 - x) / pad[2] if pad[2] else 1.0),
            1.0 - np.minimum(np.float32(y) / pad[1] if pad[1] else 1.0,
                             np.float32(h - 1 - y) / pad[3] if pad[3] else 1.0))
        import scipy.ndimage
        blur = qsize * 0.02
        arr += (scipy.ndimage.gaussian_filter(arr, [blur, blur, 0]) - arr) \
            * np.clip(mask * 3.0 + 1.0, 0.0, 1.0)
        arr += (np.median(arr, axis=(0, 1)) - arr) * np.clip(mask, 0.0, 1.0)
        img = Image.fromarray(np.uint8(np.clip(np.rint(arr), 0, 255)), "RGB")
        quad += pad[:2]

    # Transform.
    img = img.transform((transform_size, transform_size), Image.QUAD,
                        (quad + 0.5).flatten(), Image.BILINEAR)
    if output_size < transform_size:
        img = img.resize((output_size, output_size), Image.LANCZOS)
    return img


def align_directory(src_dir: str, dst_dir: str, landmarks_path: str,
                    output_size: int = 1024):
    """Align every image using a {filename: [[x, y] * 68]} sidecar
    (.json or .npy dict). The dlib-based reference pipeline produces the
    same structure (utils/align_data.py:9-31)."""
    from PIL import Image

    os.makedirs(dst_dir, exist_ok=True)
    if landmarks_path.endswith(".json"):
        with open(landmarks_path) as f:
            table = json.load(f)
    else:
        table = np.load(landmarks_path, allow_pickle=True).item()
    done = []
    for name, lm in table.items():
        src = os.path.join(src_dir, name)
        if not os.path.exists(src):
            continue
        img = Image.open(src).convert("RGB")
        aligned = align_face(img, np.asarray(lm, np.float64),
                             output_size=output_size)
        out = os.path.join(dst_dir, name)
        aligned.save(out)
        done.append(out)
    return done
