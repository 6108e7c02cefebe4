"""tgi_torch's marching tetrahedra and its exports against tgi's, on the
CPU: the numpy path and the native path (``native/marching_tet.cpp``,
built by ``g++``) give ``tgi``'s vertices and faces on a sphere, and
``save_ply`` / ``save_mrc`` write ``tgi``'s bytes. Unlike ``tgi``, a
failed native build raises rather than falling back to numpy."""

import shutil

import numpy as np
import pytest

from tgi.utils import marching as jmarching
from tgi.utils import native_build as jnative_build
from tgi_torch.utils import marching, native_build

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++: the native path cannot build")


def _sphere(n=20, radius=0.7):
    x = np.linspace(-1, 1, n).astype(np.float32)
    X, Y, Z = np.meshgrid(x, x, x + 0.05, indexing="ij")
    return (radius - np.sqrt(X ** 2 + Y ** 2 + Z ** 2)).astype(np.float32)


def test_numpy_path_is_tgis():
    grid = _sphere()
    got = marching.marching_tetrahedra(grid, 0.0, 0.1, origin=(-1, -1, -1),
                                       use_native=False)
    want = jmarching.marching_tetrahedra(grid, 0.0, 0.1,
                                         origin=(-1, -1, -1),
                                         use_native=False)
    assert len(got[1]) > 100
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@needs_gxx
def test_native_path_is_tgis(tmp_path, monkeypatch):
    # tgi builds into its own cache directory; keep it under tmp_path.
    monkeypatch.setattr(jnative_build, "CACHE_DIR", str(tmp_path))
    grid = _sphere(24)
    got = marching.marching_tetrahedra(grid, 0.1, 1 / 24, use_native=True)
    want = jmarching._marching_tetrahedra_native(grid, 0.1, 1 / 24,
                                                 (0.0, 0.0, 0.0))
    assert len(got[1]) > 100
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # The default is the native path wherever g++ is.
    default = marching.marching_tetrahedra(grid, 0.1, 1 / 24)
    for g, w in zip(default, want):
        np.testing.assert_array_equal(g, w)


def test_empty_surface():
    grid = np.zeros((5, 5, 5), np.float32)
    verts, faces = marching.marching_tetrahedra(grid, 1.0, use_native=False)
    assert verts.shape == (0, 3) and faces.shape == (0, 3)


@needs_gxx
def test_failed_native_build_raises(tmp_path, monkeypatch):
    """A failed build raises with the compiler's output; tgi would fall
    back to numpy here."""
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native_build, "_loaded", {})
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ exited") as e:
        native_build.get_plugin("bad", [str(bad)])
    assert "bad.cpp" in str(e.value)
    monkeypatch.setattr(native_build, "CFLAGS",
                        native_build.CFLAGS + ("-fno-such-option",))
    with pytest.raises(RuntimeError, match="tgi_marching"):
        marching.marching_tetrahedra(_sphere(6), 0.0, use_native=None)


def test_native_build_lands_in_the_package(monkeypatch):
    monkeypatch.setattr(native_build, "_loaded", {})
    if native_build.available():
        lib = native_build.get_plugin(
            "tgi_marching", [marching.__file__.replace(
                "utils/marching.py", "native/marching_tet.cpp")])
        assert lib._name.startswith(native_build.BUILD_DIR)
    assert native_build.BUILD_DIR.endswith("tgi_torch/_build")


def test_save_ply_and_mrc_bytes_are_tgis(tmp_path):
    grid = _sphere(10)
    verts, faces = jmarching.marching_tetrahedra(grid, 0.0, 0.2,
                                                 use_native=False)
    marching.save_ply(str(tmp_path / "a.ply"), verts, faces)
    jmarching.save_ply(str(tmp_path / "b.ply"), verts, faces)
    assert (tmp_path / "a.ply").read_bytes() == \
        (tmp_path / "b.ply").read_bytes()
    marching.save_mrc(str(tmp_path / "a.mrc"), grid, voxel_size=0.5)
    jmarching.save_mrc(str(tmp_path / "b.mrc"), grid, voxel_size=0.5)
    assert (tmp_path / "a.mrc").read_bytes() == \
        (tmp_path / "b.mrc").read_bytes()
    assert (tmp_path / "a.mrc").stat().st_size == 1024 + grid.size * 4
