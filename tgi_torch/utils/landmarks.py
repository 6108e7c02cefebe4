"""68-point face landmarks: native reader/evaluator for dlib
``shape_predictor`` models (ensemble-of-regression-trees, Kazemi &
Sullivan CVPR'14). Twin of ``tgi/utils/landmarks.py``: float64 numpy on
the host, with the same codec, cache and evaluator.

Behavioral parity target: utils/alignment.py:9-27 in the reference calls
``dlib.shape_predictor('shape_predictor_68_face_landmarks.dat')``. dlib
is not a dependency, so this module reimplements (a) the dlib binary
serialization format and (b) the ERT cascade evaluator in pure
numpy — the published ``shape_predictor_68_face_landmarks.dat`` loads
directly with ``load_shape_predictor`` and evaluates without dlib.

Format (dlib serialize.h / image_processing/shape_predictor.h):
- integers: control byte = ``n_magnitude_bytes | (0x80 if negative)``
  followed by the magnitude little-endian (zero -> control 0x00);
- floats: ``float_details`` pairs — ``value = mantissa * 2**exponent``
  with ``mantissa = int(frexp(v)[0] * 2**53)``, each as an integer;
- ``matrix<float,0,1>``: nr, nc, then elements; ``std::vector``: size
  then items; ``dlib::vector<float,2>``: x, y;
- ``shape_predictor``: version(=1), initial_shape, forests
  (vector<vector<regression_tree>>), anchor_idx, deltas. A
  regression_tree is splits (idx1, idx2, thresh) + leaf_values.

Evaluator semantics (shape_predictor.h): per cascade level, feature
pixels are anchored to the nearest landmark of the *current* shape with
offsets rotated/scaled by the similarity transform (Umeyama) between the
initial and current shape; trees split on differences of two such pixel
intensities; leaves add a full-shape update. Shapes live in normalized
[0, 1]^2 coordinates of the face rectangle and are mapped to the image
by the affine fitting the rect corners (dlib inclusive-corner
convention: tl=(left, top), br=(right, bottom)).

A writer (``save_shape_predictor``) is included so round-trip tests and
model surgery need no dlib either.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


# ---------------------------------------------------------------------------
# dlib serialization primitives


def _write_int(out: bytearray, v: int) -> None:
    neg = v < 0
    mag = -v if neg else v
    body = b""
    while mag:
        body += bytes([mag & 0xFF])
        mag >>= 8
    if len(body) > 0x7F:
        raise ValueError("integer too wide for dlib encoding")
    out.append(len(body) | (0x80 if neg else 0))
    out.extend(body)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError("truncated dlib stream")
        self.pos += n
        return b

    def int_(self) -> int:
        ctrl = self.take(1)[0]
        n = ctrl & 0x7F
        mag = int.from_bytes(self.take(n), "little")
        return -mag if ctrl & 0x80 else mag

    def float_(self) -> float:
        mantissa = self.int_()
        exponent = self.int_()
        return math.ldexp(mantissa, exponent)

    def floats(self, n: int) -> np.ndarray:
        """``float_`` n times, in one loop over local names (the hot
        path of a full-size model's ~11M leaf values)."""
        data, pos, end = self.data, self.pos, len(self.data)
        from_bytes, ldexp = int.from_bytes, math.ldexp
        out = [0.0] * n
        try:
            for i in range(n):
                c = data[pos]
                k = c & 0x7F
                m = from_bytes(data[pos + 1:pos + 1 + k], "little")
                if c & 0x80:
                    m = -m
                pos += 1 + k
                c = data[pos]
                k = c & 0x7F
                e = from_bytes(data[pos + 1:pos + 1 + k], "little")
                if c & 0x80:
                    e = -e
                pos += 1 + k
                out[i] = ldexp(m, e)
        except IndexError:
            pos = end + 1
        if pos > end:
            raise ValueError("truncated dlib stream")
        self.pos = pos
        return np.asarray(out, np.float64)

    def matrix(self) -> np.ndarray:
        nr = self.int_()
        nc = self.int_()
        return self.floats(nr * nc).reshape(nr, nc)


def _write_float(out: bytearray, v: float) -> None:
    v = float(v)
    if v == 0.0 or not math.isfinite(v):
        _write_int(out, 0)
        # dlib float_details maps inf/nan onto sentinel exponents; the
        # models never contain them — encode 0 and keep the stream valid.
        _write_int(out, 0)
        return
    fr, exp = math.frexp(v)
    _write_int(out, int(fr * 9007199254740992.0))  # 2**53
    _write_int(out, exp - 53)


def _encode_ints(ints: np.ndarray) -> bytes:
    """``_write_int`` over an int64 array at once: the same bytes."""
    ints = np.asarray(ints, np.int64).reshape(-1)
    mag = np.abs(ints).astype(np.uint64)
    nbytes = sum((mag >= np.uint64(1 << (8 * k))).astype(np.uint8)
                 for k in range(8))
    table = np.empty((ints.size, 9), np.uint8)
    table[:, 0] = nbytes | np.where(ints < 0, 0x80, 0).astype(np.uint8)
    for k in range(8):
        table[:, k + 1] = (mag >> np.uint64(8 * k)) & np.uint64(0xFF)
    keep = np.arange(9)[None, :] <= nbytes[:, None]
    return table[keep].tobytes()


def _float_ints(values: np.ndarray) -> np.ndarray:
    """``_write_float``'s (mantissa, exponent) pairs of float64 values,
    interleaved: [2 * n] int64."""
    v = np.asarray(values, np.float64).reshape(-1)
    fr, exp = np.frexp(v)
    # 0, inf and nan are written as (0, 0), as _write_float does.
    ok = (v != 0.0) & np.isfinite(v)
    pairs = np.stack([np.where(ok, fr, 0.0) * 9007199254740992.0,
                      np.where(ok, exp - 53, 0)], axis=1).astype(np.int64)
    return pairs.reshape(-1)


def _write_matrix(out: bytearray, m: np.ndarray) -> None:
    m = np.atleast_2d(np.asarray(m, np.float64))
    out.extend(_encode_ints(np.concatenate(
        [np.asarray(m.shape, np.int64), _float_ints(m)])))


def _write_matrices(out: bytearray, rows: np.ndarray) -> None:
    """``_write_matrix`` of each row of ``rows`` as a column vector, in
    one encode."""
    rows = np.asarray(rows, np.float64).reshape(len(rows), -1)
    header = np.broadcast_to(np.asarray([rows.shape[1], 1], np.int64),
                             (len(rows), 2))
    body = _float_ints(rows).reshape(len(rows), -1)
    out.extend(_encode_ints(np.concatenate([header, body], axis=1)))


# ---------------------------------------------------------------------------
# model containers


@dataclasses.dataclass
class RegressionTree:
    """splits: int64 [S, 2] (idx1, idx2); thresh: float64 [S];
    leaf_values: float64 [S + 1, 2L] (complete binary tree)."""
    splits: np.ndarray
    thresh: np.ndarray
    leaf_values: np.ndarray


@dataclasses.dataclass
class ShapePredictor:
    initial_shape: np.ndarray            # [2L] interleaved x, y
    forests: list                        # [cascade][tree] RegressionTree
    anchor_idx: list                     # [cascade] int64 [F]
    deltas: list                         # [cascade] float64 [F, 2]

    @property
    def num_parts(self) -> int:
        return self.initial_shape.size // 2

    def __call__(self, image: np.ndarray, rect=None) -> np.ndarray:
        return predict_landmarks(self, image, rect)


def load_shape_predictor(path: str, cache: bool = True) -> ShapePredictor:
    """Read a dlib-serialized shape_predictor (.dat).

    The variable-length float encoding makes the first parse of a
    full-size model (~11M floats) take ~40 s of sequential decoding;
    with ``cache=True`` the parsed arrays are stored next to the file as
    ``<path>.tgi.npz`` (the file ``tgi`` writes too) and subsequent
    loads are instant. Models with ragged tree shapes (never produced by
    dlib's trainer) skip the cache transparently.
    """
    import os
    npz_path = path + ".tgi.npz"
    if (cache and os.path.exists(npz_path)
            and os.path.getmtime(npz_path) >= os.path.getmtime(path)):
        return _predictor_from_npz(np.load(npz_path))
    sp = _parse_shape_predictor(path)
    if cache:
        try:
            _predictor_to_npz(sp, npz_path)
        except ValueError:
            pass
    return sp


def _predictor_to_npz(sp: ShapePredictor, path: str) -> None:
    splits = np.asarray([[t.splits for t in trees]
                         for trees in sp.forests])  # [C,T,S,2] or ragged
    if splits.dtype == object:
        raise ValueError("ragged forests: not cacheable")
    np.savez(path,
             initial_shape=sp.initial_shape,
             splits=splits,
             thresh=np.asarray([[t.thresh for t in trees]
                                for trees in sp.forests]),
             leaves=np.asarray([[t.leaf_values for t in trees]
                                for trees in sp.forests]),
             anchors=np.asarray(sp.anchor_idx),
             deltas=np.asarray(sp.deltas))


def _predictor_from_npz(z) -> ShapePredictor:
    forests = [[RegressionTree(z["splits"][c, t], z["thresh"][c, t],
                               z["leaves"][c, t])
                for t in range(z["splits"].shape[1])]
               for c in range(z["splits"].shape[0])]
    return ShapePredictor(z["initial_shape"], forests,
                          list(z["anchors"]), list(z["deltas"]))


def _parse_shape_predictor(path: str) -> ShapePredictor:
    with open(path, "rb") as f:
        r = _Reader(f.read())
    version = r.int_()
    if version != 1:
        raise ValueError(f"unsupported shape_predictor version {version}")
    initial_shape = r.matrix().reshape(-1)
    forests = []
    for _ in range(r.int_()):
        trees = []
        for _ in range(r.int_()):
            n_splits = r.int_()
            splits = np.empty((n_splits, 2), np.int64)
            thresh = np.empty((n_splits,), np.float64)
            for i in range(n_splits):
                splits[i, 0] = r.int_()
                splits[i, 1] = r.int_()
                thresh[i] = r.float_()
            n_leaves = r.int_()
            leaves = np.stack([r.matrix().reshape(-1)
                               for _ in range(n_leaves)]) \
                if n_leaves else np.zeros((0, initial_shape.size))
            trees.append(RegressionTree(splits, thresh, leaves))
        forests.append(trees)
    anchor_idx = []
    for _ in range(r.int_()):
        anchor_idx.append(np.asarray([r.int_() for _ in range(r.int_())],
                                     np.int64))
    deltas = []
    for _ in range(r.int_()):
        n = r.int_()
        d = np.empty((n, 2), np.float64)
        for i in range(n):
            d[i, 0] = r.float_()
            d[i, 1] = r.float_()
        deltas.append(d)
    return ShapePredictor(initial_shape, forests, anchor_idx, deltas)


def save_shape_predictor(sp: ShapePredictor, path: str) -> None:
    """Write a ShapePredictor in dlib's serialization format (the leaves
    encoded a tree at a time by numpy: the bytes of ``tgi``'s writer,
    which encodes one float at a time)."""
    out = bytearray()
    _write_int(out, 1)  # version
    _write_matrix(out, sp.initial_shape.reshape(-1, 1))
    _write_int(out, len(sp.forests))
    for trees in sp.forests:
        _write_int(out, len(trees))
        for t in trees:
            _write_int(out, len(t.splits))
            for (i1, i2), th in zip(t.splits, t.thresh):
                _write_int(out, int(i1))
                _write_int(out, int(i2))
                _write_float(out, th)
            _write_int(out, len(t.leaf_values))
            if len(t.leaf_values):
                _write_matrices(out, t.leaf_values)
    _write_int(out, len(sp.anchor_idx))
    for a in sp.anchor_idx:
        _write_int(out, len(a))
        for v in a:
            _write_int(out, int(v))
    _write_int(out, len(sp.deltas))
    for d in sp.deltas:
        _write_int(out, len(d))
        for x, y in d:
            _write_float(out, x)
            _write_float(out, y)
    with open(path, "wb") as f:
        f.write(bytes(out))


# ---------------------------------------------------------------------------
# evaluator


def _similarity_2x2(from_pts: np.ndarray, to_pts: np.ndarray) -> np.ndarray:
    """Linear part (c*R) of the Umeyama similarity transform mapping
    from_pts onto to_pts (dlib find_similarity_transform / Umeyama'91,
    used by find_tform_between_shapes)."""
    n = len(from_pts)
    mf = from_pts.mean(0)
    mt = to_pts.mean(0)
    f = from_pts - mf
    t = to_pts - mt
    sigma_from = (f ** 2).sum() / n
    cov = t.T @ f / n
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(2)
    if np.linalg.det(cov) < 0 or (np.linalg.det(cov) == 0
                                  and np.linalg.det(u)
                                  * np.linalg.det(vt) < 0):
        s[1, 1] = -1
    r = u @ s @ vt
    c = (d * np.diag(s)).sum() / sigma_from if sigma_from > 0 else 1.0
    return c * r


def _tree_update(tree: RegressionTree, feats: np.ndarray) -> np.ndarray:
    i = 0
    n = len(tree.splits)
    while i < n:
        i1, i2 = tree.splits[i]
        i = 2 * i + 1 if feats[i1] - feats[i2] > tree.thresh[i] else 2 * i + 2
    return tree.leaf_values[i - n]


def predict_landmarks(sp: ShapePredictor, image: np.ndarray,
                      rect=None) -> np.ndarray:
    """Landmarks [L, 2] (x, y image coords, float64).

    image: [H, W] grayscale or [H, W, 3] RGB uint8/float; rect: face box
    (left, top, right, bottom) in dlib's inclusive-corner convention,
    full image if None.
    """
    img = np.asarray(image)
    if img.ndim == 3:
        # dlib get_pixel_intensity on RGB averages the channels
        img = img.astype(np.float64).mean(-1)
    img = img.astype(np.float64)
    h, w = img.shape
    if rect is None:
        rect = (0, 0, w - 1, h - 1)
    left, top, right, bottom = (float(v) for v in rect)
    sx, sy = right - left, bottom - top

    shape = sp.initial_shape.astype(np.float64).copy()
    ref_pts = sp.initial_shape.reshape(-1, 2)
    for cascade in range(len(sp.forests)):
        cur_pts = shape.reshape(-1, 2)
        m = _similarity_2x2(ref_pts, cur_pts)
        anchors = cur_pts[sp.anchor_idx[cascade]]
        pts = sp.deltas[cascade] @ m.T + anchors
        # normalized -> image coords, lround (half away from zero)
        px = np.floor(left + pts[:, 0] * sx + 0.5).astype(np.int64)
        py = np.floor(top + pts[:, 1] * sy + 0.5).astype(np.int64)
        inside = (px >= 0) & (px < w) & (py >= 0) & (py < h)
        feats = np.where(inside, img[py.clip(0, h - 1), px.clip(0, w - 1)],
                         0.0)
        for tree in sp.forests[cascade]:
            shape = shape + _tree_update(tree, feats)
    out = shape.reshape(-1, 2)
    return np.stack([left + out[:, 0] * sx, top + out[:, 1] * sy], axis=1)


# ---------------------------------------------------------------------------
# detection front-end


def detect_face_box(image: np.ndarray, yunet_model: str | None = None):
    """Best face box (left, top, right, bottom) or None.

    With ``yunet_model`` (a YuNet .onnx path) uses OpenCV FaceDetectorYN;
    otherwise returns the centered square covering 70% of the shorter
    side — adequate for portrait photos that roughly center the face
    (the reference assumes dlib's HOG detector finds exactly one face,
    utils/alignment.py:14-18)."""
    img = np.asarray(image)
    h, w = img.shape[:2]
    if yunet_model:
        try:
            import cv2
        except ImportError as e:
            raise ImportError(
                "face detection with a YuNet model (--yunet) needs OpenCV "
                "(the cv2 module), which is not installed; leave out "
                "--yunet for the centered box") from e
        det = cv2.FaceDetectorYN.create(yunet_model, "", (w, h))
        _, faces = det.detect(
            img[..., ::-1] if img.ndim == 3 else
            np.repeat(img[..., None], 3, -1))
        if faces is not None and len(faces):
            x, y, bw, bh = faces[0][:4]
            return (float(x), float(y), float(x + bw - 1),
                    float(y + bh - 1))
        return None
    s = 0.7 * min(h, w)
    cx, cy = w / 2, h / 2
    return (cx - s / 2, cy - s / 2, cx + s / 2 - 1, cy + s / 2 - 1)


def landmarks_for_directory(src_dir: str, predictor_path: str,
                            yunet_model: str | None = None) -> dict:
    """Run the predictor over a directory -> {filename: [[x, y]*L]},
    the sidecar structure align_directory consumes."""
    import os

    from PIL import Image
    sp = load_shape_predictor(predictor_path)
    table = {}
    for name in sorted(os.listdir(src_dir)):
        if not name.lower().endswith((".png", ".jpg", ".jpeg", ".webp")):
            continue
        img = np.asarray(Image.open(os.path.join(src_dir, name))
                         .convert("RGB"))
        box = detect_face_box(img, yunet_model)
        if box is None:
            continue
        table[name] = predict_landmarks(sp, img, box).tolist()
    return table
