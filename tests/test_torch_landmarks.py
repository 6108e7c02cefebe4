"""tgi_torch's dlib ``shape_predictor`` codec and ERT evaluator
(``tgi_torch/utils/landmarks.py``) against tgi's, on the CPU.

The predictors are drawn (``chip_smoke.drawn_predictor``, 68 points
about ``tests/test_landmarks.py``'s mean face): no dlib ``.dat`` is in
the tree. Both packages read and write the same files, and the port's
writer and float reader (numpy over a tree's leaves, and one loop over
local names) are held to tgi's one-value-at-a-time codec byte for byte.
Landmarks are float64 and compared for equality.
"""

import json
import os

import numpy as np
import pytest

from tgi.utils import landmarks as jlm
from tgi_torch.utils import landmarks as lm

import chip_smoke


def _tgi_predictor(sp):
    """The same predictor in tgi's classes."""
    return jlm.ShapePredictor(
        sp.initial_shape,
        [[jlm.RegressionTree(t.splits, t.thresh, t.leaf_values)
          for t in trees] for trees in sp.forests],
        list(sp.anchor_idx), list(sp.deltas))


@pytest.fixture(scope="module")
def predictor():
    return chip_smoke.drawn_predictor(0, cascades=3, trees=20, depth=3,
                                      features=32, scale=0.01)


def test_int_and_float_codecs_match_tgi():
    """Integers of every width and sign, and float32 / float64 values with
    zero, inf and nan (written as 0) and a subnormal, encode to tgi's
    bytes and decode to tgi's values."""
    ints = [0, 1, -1, 127, 128, 255, 256, -300, 2 ** 31, -2 ** 31,
            2 ** 53 + 7, -(2 ** 60), 2 ** 63 - 1]
    want = bytearray()
    got = bytearray()
    for v in ints:
        jlm._write_int(want, v)
        lm._write_int(got, v)
    assert bytes(got) == bytes(want) == lm._encode_ints(np.asarray(ints))
    r = lm._Reader(bytes(want))
    assert [r.int_() for _ in ints] == ints

    rng = np.random.RandomState(0)
    vals = np.r_[rng.randn(64).astype(np.float32), rng.randn(64) * 1e-3,
                 [0.0, 1.0, -1.0, 1e-20, -3e15, np.inf, -np.inf, np.nan,
                  5e-320]]
    want = bytearray()
    for v in vals:
        jlm._write_float(want, float(v))
    got = lm._encode_ints(lm._float_ints(vals))
    assert got == bytes(want)
    decoded = lm._Reader(got).floats(len(vals))
    jr = jlm._Reader(bytes(want))
    np.testing.assert_array_equal(decoded, [jr.float_() for _ in vals])
    with pytest.raises(ValueError, match="truncated"):
        lm._Reader(got[:-3]).floats(len(vals))


def test_predictor_files_match_tgi_bytewise(tmp_path, predictor):
    """The port's file is tgi's byte for byte; each package reads the
    other's (and its own ``.tgi.npz`` cache) to the same arrays."""
    ours, theirs = str(tmp_path / "a.dat"), str(tmp_path / "b.dat")
    lm.save_shape_predictor(predictor, ours)
    jlm.save_shape_predictor(_tgi_predictor(predictor), theirs)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for load in (lambda p: lm.load_shape_predictor(p, cache=False),
                 lm.load_shape_predictor, lm.load_shape_predictor,
                 jlm.load_shape_predictor):
        sp = load(ours)
        np.testing.assert_array_equal(sp.initial_shape,
                                      predictor.initial_shape)
        for ta, tb in zip(sp.forests, predictor.forests):
            for a, b in zip(ta, tb):
                np.testing.assert_array_equal(a.splits, b.splits)
                np.testing.assert_array_equal(a.thresh, b.thresh)
                np.testing.assert_array_equal(a.leaf_values, b.leaf_values)
        for a, b in zip(sp.anchor_idx, predictor.anchor_idx):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(sp.deltas, predictor.deltas):
            np.testing.assert_array_equal(a, b)
    assert os.path.exists(ours + ".tgi.npz")


@pytest.mark.parametrize("rect", [None, (40, 30, 139, 129), (-20, -10, 60,
                                                             50)])
def test_predict_landmarks_equals_tgi(predictor, rect):
    """The cascade on an RGB and a grayscale image, over the whole image,
    a face box, and a box partly outside the image (features read as 0
    there): tgi's float64 landmarks exactly."""
    rng = np.random.RandomState(1)
    rgb = rng.randint(0, 256, (150, 170, 3), dtype=np.uint8)
    for img in (rgb, rgb[..., 1]):
        got = lm.predict_landmarks(predictor, img, rect)
        want = jlm.predict_landmarks(_tgi_predictor(predictor), img, rect)
        assert got.dtype == np.float64 and got.shape == (68, 2)
        np.testing.assert_array_equal(got, want)
    assert np.abs(got - jlm.predict_landmarks(
        jlm.ShapePredictor(predictor.initial_shape, [], [], []), img,
        rect)).max() > 0


def test_similarity_transform_equals_tgi():
    rng = np.random.RandomState(3)
    pts = rng.randn(20, 2)
    th, c = 0.4, 1.7
    rot = np.asarray([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    for to in (pts @ (c * rot).T + [3.0, -2.0], pts * [1.0, -1.0]):
        np.testing.assert_array_equal(lm._similarity_2x2(pts, to),
                                      jlm._similarity_2x2(pts, to))
    np.testing.assert_allclose(
        lm._similarity_2x2(pts, pts @ (c * rot).T), c * rot, atol=1e-10)


@pytest.mark.parametrize("shape", [(100, 200, 3), (90, 60), (64, 64, 3)])
def test_detect_face_box_equals_tgi(shape):
    img = np.zeros(shape, np.uint8)
    box = lm.detect_face_box(img)
    assert box == jlm.detect_face_box(img)
    left, top, right, bottom = box
    assert abs((left + right + 1) / 2 - shape[1] / 2) < 1e-9
    assert abs((top + bottom + 1) / 2 - shape[0] / 2) < 1e-9


def test_landmarks_for_directory_equals_tgi(tmp_path, predictor):
    from PIL import Image
    rng = np.random.RandomState(5)
    for i, size in enumerate([(120, 100), (90, 130)]):
        Image.fromarray(rng.randint(0, 255, size + (3,), dtype=np.uint8)
                        ).save(tmp_path / f"img{i}.png")
    (tmp_path / "notes.txt").write_text("not an image")
    path = str(tmp_path / "sp.dat")
    lm.save_shape_predictor(predictor, path)
    got = lm.landmarks_for_directory(str(tmp_path), path)
    assert got == jlm.landmarks_for_directory(str(tmp_path), path)
    assert sorted(got) == ["img0.png", "img1.png"]
    assert json.loads(json.dumps(got)) == got
