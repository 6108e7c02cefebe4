"""tgi_torch's FFHQ alignment (``utils/alignment.py``) and its command
line (``apps/align_data.py``) against tgi's, on the CPU.

Drawn images and landmarks (``chip_smoke.mean_face`` placed in the
image): the quad, and the aligned image through the shrink, crop, padded
blur and ``QUAD`` warp, equal tgi's bit for bit. The command line runs
with a sidecar of landmarks and with a drawn dlib predictor.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from tgi.utils import alignment as jal
from tgi_torch.utils import alignment as al
from tgi_torch.utils import landmarks as lm

import chip_smoke


def _face(box, rng, jitter=0.01):
    """68 landmarks: the mean face scaled into ``box`` (left, top, size),
    moved by a little noise."""
    left, top, size = box
    pts = chip_smoke.mean_face() + rng.randn(68, 2) * jitter
    return pts * size + [left, top]


def _image(rng, h, w):
    return Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8))


@pytest.mark.parametrize("box", [(30.0, 40.0, 90.0), (-10.0, 5.0, 70.0)])
def test_alignment_quad_equals_tgi(box):
    lms = _face(box, np.random.RandomState(0))
    q, qs = al.compute_alignment_quad(lms)
    jq, jqs = jal.compute_alignment_quad(lms)
    np.testing.assert_array_equal(q, jq)
    assert qs == jqs


# (image h, w, face box, output size, transform size): a face inside the
# image (crop, no pad), a face over the top-left corner (reflect pad with
# the blur), and a face large beside the output (the shrink, then crop).
CASES = {"crop": (160, 140, (35.0, 30.0, 70.0), 32, 64),
         "pad_blur": (120, 110, (-15.0, -20.0, 80.0), 32, 64),
         "shrink": (260, 240, (20.0, 20.0, 200.0), 16, 32)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_align_face_equals_tgi(case):
    h, w, box, out, tsize = CASES[case]
    rng = np.random.RandomState(1)
    img, lms = _image(rng, h, w), _face(box, rng)
    quad, qsize = al.compute_alignment_quad(lms)
    shrink = int(np.floor(qsize / out * 0.5))
    assert (shrink > 1) == (case == "shrink"), shrink
    got = al.align_face(img, lms, output_size=out, transform_size=tsize)
    want = jal.align_face(img, lms, output_size=out, transform_size=tsize)
    assert got.size == want.size == (out, out)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    if case == "pad_blur":
        nopad = al.align_face(img, lms, output_size=out,
                              transform_size=tsize, enable_padding=False)
        assert np.abs(np.asarray(nopad, np.int32)
                      - np.asarray(got, np.int32)).max() > 0


def _raw_dir(tmp_path, rng):
    src = tmp_path / "raw"
    src.mkdir()
    faces = {}
    for i, (h, w) in enumerate([(160, 140), (150, 170)]):
        _image(rng, h, w).save(src / f"img{i}.png")
        faces[f"img{i}.png"] = _face((30.0, 30.0, 80.0), rng).tolist()
    return src, faces


def test_align_data_cli_with_landmarks(tmp_path):
    """``--landmarks`` (a .json sidecar; an entry for a missing file is
    skipped): the crops equal tgi's ``align_directory``."""
    from tgi_torch.apps.align_data import main
    rng = np.random.RandomState(2)
    src, faces = _raw_dir(tmp_path, rng)
    side = tmp_path / "lm.json"
    side.write_text(json.dumps({**faces, "gone.png": faces["img0.png"]}))
    dst = tmp_path / "aligned"
    with pytest.raises(SystemExit) as e:
        main(["--src", str(src), "--dst", str(dst), "--landmarks",
              str(side), "--size", "32"])
    assert e.value.code == 0
    ref = tmp_path / "ref"
    jal.align_directory(str(src), str(ref), str(side), output_size=32)
    assert sorted(os.listdir(dst)) == sorted(os.listdir(ref)) == [
        "img0.png", "img1.png"]
    for name in os.listdir(ref):
        np.testing.assert_array_equal(np.asarray(Image.open(dst / name)),
                                      np.asarray(Image.open(ref / name)))


def test_align_data_cli_with_predictor(tmp_path):
    """``--predictor`` (a drawn predictor written with
    ``save_shape_predictor``): the landmarks sidecar it writes is tgi's
    ``landmarks_for_directory`` exactly, and its crops are 64²; without
    a landmark source the command line stops with a usage error."""
    from tgi.utils.landmarks import landmarks_for_directory
    from tgi_torch.apps.align_data import main
    rng = np.random.RandomState(3)
    src, _ = _raw_dir(tmp_path, rng)
    path = str(tmp_path / "sp.dat")
    lm.save_shape_predictor(chip_smoke.drawn_predictor(
        4, cascades=2, trees=10, depth=3, features=32), path)
    dst = tmp_path / "aligned"
    with pytest.raises(SystemExit) as e:
        main(["--src", str(src), "--dst", str(dst), "--predictor", path,
              "--size", "64"])
    assert e.value.code == 0
    with open(dst / "_landmarks.json") as f:
        table = json.load(f)
    assert table == landmarks_for_directory(str(src), path)
    assert np.asarray(table["img0.png"]).shape == (68, 2)
    assert Image.open(dst / "img1.png").size == (64, 64)
    with pytest.raises(SystemExit) as e:
        main(["--src", str(src), "--dst", str(dst)])
    assert e.value.code == 2
