"""Isosurface extraction and mesh / volume export (twin of
``tgi/utils/marching.py``).

Replaces the reference's shape export chain (single_id_coach.py:120-163:
a sigma grid -> marching cubes -> .mrc / .ply through mrcfile and
skimage) with marching **tetrahedra**: each voxel cell split into 6
tets, vectorised in numpy, or streamed by ``native/marching_tet.cpp``
(built by ``g++`` at first use, ``utils/native_build.py``). Exports: an
ASCII .ply and a minimal MRC2014 volume.

Unlike ``tgi``, which falls back to numpy when the native build or call
fails on a grid up to 128³, a failed native build or call raises here:
``use_native=None`` means native wherever ``g++`` is present, and
``use_native=False`` asks for the numpy path.
"""

from __future__ import annotations

import os
import struct

import numpy as np

# 6-tetrahedra decomposition of the unit cube (corner indices).
# Corner order: bit0=x, bit1=y, bit2=z  ->  corner i at (i&1, (i>>1)&1, i>>2).
TETS = np.asarray([
    [0, 5, 1, 3],
    [0, 5, 3, 7],
    [0, 5, 7, 4],
    [0, 7, 3, 2],
    [0, 7, 2, 6],
    [0, 7, 6, 4],
], np.int32)

CORNERS = np.asarray([[i & 1, (i >> 1) & 1, i >> 2] for i in range(8)],
                     np.float32)


def _interp(p0, p1, v0, v1, level):
    t = (level - v0) / np.where(np.abs(v1 - v0) < 1e-12, 1e-12, v1 - v0)
    return p0 + t[:, None] * (p1 - p0)


def marching_tetrahedra(grid: np.ndarray, level: float = 0.0,
                        spacing: float = 1.0, origin=(0.0, 0.0, 0.0),
                        use_native: bool | None = None):
    """Extract the ``grid == level`` isosurface.

    Args:
        grid: [X, Y, Z] scalar field.
        level: iso value.
        spacing: voxel edge length.
        origin: world position of voxel (0,0,0).
        use_native: True for the C++ implementation, False for numpy;
            None (default) for C++ wherever ``g++`` is present (a 512³
            grid needs it: the numpy path's intermediates are ~4 GB
            there). A failed build or call raises.

    Returns:
        (verts [V, 3] float32, faces [F, 3] int32).
    """
    if use_native is None:
        from tgi_torch.utils.native_build import available
        use_native = available()
    if use_native:
        return _marching_tetrahedra_native(grid, level, spacing, origin)
    return _marching_tetrahedra_numpy(grid, level, spacing, origin)


def _marching_tetrahedra_native(grid, level, spacing, origin):
    import ctypes

    from tgi_torch.utils.native_build import get_plugin
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native", "marching_tet.cpp")
    lib = get_plugin("tgi_marching", [src])
    fn = lib.tgi_marching_tetrahedra
    fn.restype = ctypes.c_int

    grid = np.ascontiguousarray(grid, np.float32)
    origin_arr = np.asarray(origin, np.float32)
    verts_p = ctypes.POINTER(ctypes.c_float)()
    faces_p = ctypes.POINTER(ctypes.c_int32)()
    nv = ctypes.c_int()
    nf = ctypes.c_int()
    ret = fn(grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
             *map(ctypes.c_int, grid.shape), ctypes.c_float(level),
             ctypes.c_float(spacing),
             origin_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
             ctypes.byref(verts_p), ctypes.byref(nv),
             ctypes.byref(faces_p), ctypes.byref(nf))
    if ret != 0:
        raise RuntimeError(f"native marching tetrahedra failed ({ret}) on "
                           f"a grid of {grid.shape}")
    verts = np.ctypeslib.as_array(verts_p, (nv.value, 3)).copy()
    faces = np.ctypeslib.as_array(faces_p, (nf.value, 3)).copy()
    lib.tgi_free(verts_p)
    lib.tgi_free(faces_p)
    return verts.astype(np.float32), faces.astype(np.int32)


def _marching_tetrahedra_numpy(grid, level=0.0, spacing=1.0,
                               origin=(0.0, 0.0, 0.0)):
    """Vectorized numpy reference implementation."""
    X, Y, Z = grid.shape
    # Cell corner values: [(X-1)(Y-1)(Z-1), 8]
    idx = np.stack(np.meshgrid(np.arange(X - 1), np.arange(Y - 1),
                               np.arange(Z - 1), indexing="ij"),
                   axis=-1).reshape(-1, 3)
    corner_vals = np.stack(
        [grid[idx[:, 0] + cx, idx[:, 1] + cy, idx[:, 2] + cz]
         for cx, cy, cz in CORNERS.astype(int)], axis=-1)   # [M, 8]

    # Quick reject cells fully inside/outside.
    keep = ~((corner_vals > level).all(-1) | (corner_vals < level).all(-1))
    idx = idx[keep]
    corner_vals = corner_vals[keep]
    if len(idx) == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))

    # Crack-free decomposition: odd-parity cells use the point-reflected
    # tets (corner i -> 7-i) so shared-face diagonals agree between
    # neighboring cells.
    parity = (idx.sum(axis=1) % 2).astype(bool)
    tris = []
    for cells, tets in ((~parity, TETS), (parity, 7 - TETS)):
        if not cells.any():
            continue
        tris += _polygonise_cells(idx[cells].astype(np.float32),
                                  corner_vals[cells], tets, level)

    if not tris:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    tri_verts = np.concatenate(tris, axis=0)            # [F, 3, 3]
    verts = tri_verts.reshape(-1, 3) * spacing + np.asarray(origin)
    faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    # Weld duplicate vertices. Shared edges are interpolated by different
    # tets with operands in different order, so keys must absorb fp noise:
    # quantize at 1e-4 of a voxel.
    uniq, inverse = np.unique(np.round(verts / spacing * 1e4).astype(
        np.int64), axis=0, return_inverse=True)
    welded = np.zeros((len(uniq), 3), np.float32)
    welded[inverse] = verts
    return welded.astype(np.float32), inverse[faces].astype(np.int32)


def _polygonise_cells(cell_pos, corner_vals, tets, level):
    tris = []
    for tet in tets:
        v = corner_vals[:, tet]                         # [M, 4]
        p = cell_pos[:, None, :] + CORNERS[tet][None]   # [M, 4, 3]
        inside = v > level                              # [M, 4]
        code = (inside[:, 0].astype(int) | (inside[:, 1].astype(int) << 1)
                | (inside[:, 2].astype(int) << 2)
                | (inside[:, 3].astype(int) << 3))

        # One-vertex-inside cases (and complements): single triangle.
        # Two-inside cases: quad -> two triangles.
        for case in range(1, 15):
            m = code == case
            if not m.any():
                continue
            bits = [bool(case >> i & 1) for i in range(4)]
            ins = [i for i in range(4) if bits[i]]
            outs = [i for i in range(4) if not bits[i]]
            vm, pm = v[m], p[m]
            if len(ins) == 1 or len(outs) == 1:
                a = ins[0] if len(ins) == 1 else outs[0]
                rest = outs if len(ins) == 1 else ins
                e = [_interp(pm[:, a], pm[:, b], vm[:, a], vm[:, b], level)
                     for b in rest]
                tris.append(np.stack(e, axis=1))
            else:  # 2 in / 2 out -> quad
                a0, a1 = ins
                b0, b1 = outs
                q = [_interp(pm[:, a0], pm[:, b0], vm[:, a0], vm[:, b0], level),
                     _interp(pm[:, a0], pm[:, b1], vm[:, a0], vm[:, b1], level),
                     _interp(pm[:, a1], pm[:, b1], vm[:, a1], vm[:, b1], level),
                     _interp(pm[:, a1], pm[:, b0], vm[:, a1], vm[:, b0], level)]
                tris.append(np.stack([q[0], q[1], q[2]], axis=1))
                tris.append(np.stack([q[0], q[2], q[3]], axis=1))
    return tris


def save_ply(path, verts, faces):
    """ASCII PLY writer (replacing the shape_utils/trimesh export)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in verts:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in faces:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def save_mrc(path, volume, voxel_size=1.0):
    """Minimal MRC2014 writer (mode 2 = float32), replacing mrcfile
    (single_id_coach.py:124-127 writes sigma volumes as .mrc)."""
    vol = np.asarray(volume, np.float32)
    nz, ny, nx = vol.shape
    header = bytearray(1024)
    struct.pack_into("<3i", header, 0, nx, ny, nz)
    struct.pack_into("<i", header, 12, 2)                    # mode 2
    struct.pack_into("<3i", header, 28, nx, ny, nz)          # mx my mz
    struct.pack_into("<3f", header, 40, nx * voxel_size,
                     ny * voxel_size, nz * voxel_size)       # cella
    struct.pack_into("<3f", header, 52, 90., 90., 90.)       # cellb
    struct.pack_into("<3i", header, 64, 1, 2, 3)             # axis order
    struct.pack_into("<3f", header, 76, float(vol.min()),
                     float(vol.max()), float(vol.mean()))
    struct.pack_into("<i", header, 92, 20140)                # nversion
    header[208:212] = b"MAP "
    header[212:216] = b"\x44\x44\x00\x00"                    # little endian
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(vol.tobytes())
