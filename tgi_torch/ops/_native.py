"""Build and load the port's CUDA kernels.

Each ``tgi_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded
with ``ctypes``. No source includes PyTorch's headers, so a build takes
seconds, not the minutes of ``torch.utils.cpp_extension``.

The build runs at first use, from the checkout's sources only, into
``tgi_torch/_build/`` (listed in ``.gitignore``). A library's name
carries a hash of its source and flags, so an edited source is rebuilt
and a stale library is never loaded. All sources are compiled at once,
one ``nvcc`` process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("triplane_gather.cu", "triplane_splat.cu",
           "triplane_splat_sorted.cu", "gather_rows.cu",
           "gather_tilewalk.cu", "splat_sched.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(src: str) -> str:
    h = hashlib.sha256()
    with open(os.path.join(CSRC, src), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(src)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:12]}.so")


def build_all() -> dict[str, str]:
    """Compile every source whose library is missing, all in parallel.

    Returns {source: library path}. Raises with nvcc's output if a
    build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    targets = {src: _target(src) for src in SOURCES}
    procs = {}
    for src, so in targets.items():
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, so)
    failed = []
    for src, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[src] = out
        if proc.returncode != 0:
            failed.append(f"{src}: nvcc exited {proc.returncode}\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _F = ctypes.c_longlong, ctypes.c_float
# Entry points of each source and their C signatures (all return an int
# error).
ENTRY_POINTS = {
    "triplane_gather.cu": {
        # planes, coords, out, N, H, W, C, M, scale, stream
        "tgi_triplane_gather_f32": [_P, _P, _P, _I, _I, _I, _I, _L, _F, _P],
    },
    "triplane_splat.cu": {
        # g, coords, planes, d_planes, d_coords, N, H, W, C, M, scale,
        # want_dplanes, stream
        "tgi_triplane_splat_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L,
                                   _F, _I, _P],
    },
    "triplane_splat_sorted.cu": {
        # coords, keys, N, H, W, M, scale, stream
        "tgi_splat_keys_f32": [_P, _P, _I, _I, _I, _L, _F, _P],
        # sorted_keys, order, coords, offsets, records, N, H, W, M, scale,
        # stream
        "tgi_splat_offsets_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _L, _F,
                                  _P],
        # g, records, offsets, d_planes, N, H, W, C, M, stream
        "tgi_splat_segments_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _P],
    },
    "gather_rows.cu": {
        # exp, cells, out, G, HW, P, row_bytes, stream
        "tgi_gather_rows": [_P, _P, _P, _I, _L, _L, _I, _P],
    },
    "gather_tilewalk.cu": {
        # exp, cells, out, passes, G, nrows, P, row_bytes, stream
        "tgi_gather_tilewalk": [_P, _P, _P, _P, _I, _I, _L, _I, _P],
    },
    "splat_sched.cu": {
        # wg, rows, acc, G, E, H, W, schedule, stream
        "tgi_splat_sched": [_P, _P, _P, _I, _L, _I, _I, _I, _P],
    },
}


def library(src: str) -> ctypes.CDLL:
    """The library built from ``csrc/<src>``, built on first use."""
    with _lock:
        if src not in _libs:
            lib = ctypes.CDLL(build_all()[src])
            for name, argtypes in ENTRY_POINTS[src].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.tgi_cuda_error_string.argtypes = [ctypes.c_int]
            lib.tgi_cuda_error_string.restype = ctypes.c_char_p
            _libs[src] = lib
        return _libs[src]


def error_string(err: int) -> str:
    return library(SOURCES[0]).tgi_cuda_error_string(err).decode()
