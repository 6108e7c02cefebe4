"""Build and load the port's host C++ libraries (twin of
``tgi/utils/native_build.py``; parity target
torch_utils/custom_ops.py:60-159, get_plugin).

A library is compiled by ``g++`` from the checkout's sources at first
use, into ``tgi_torch/_build/`` (listed in ``.gitignore``, beside the
CUDA kernels' libraries), and loaded with ``ctypes``. Its name carries a
hash of its sources and flags, so an edited source is rebuilt. A failed
build raises with the compiler's output. It serves host work, such as
mesh extraction over 256³ and 512³ grids, where numpy is too slow.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
CFLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_loaded: dict[str, ctypes.CDLL] = {}


def get_plugin(name: str, sources: list[str]) -> ctypes.CDLL:
    """Compile ``sources`` (absolute paths) into
    ``_build/lib{name}-{hash}.so`` unless it is there, and load it."""
    if name in _loaded:
        return _loaded[name]
    digest = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(CFLAGS).encode())
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR,
                            f"lib{name}-{digest.hexdigest()[:12]}.so")
    if not os.path.exists(lib_path):
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", *CFLAGS, *sources, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ exited {proc.returncode} building "
                               f"{name} from {sources}:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    _loaded[name] = lib
    return lib


def available() -> bool:
    """Whether ``g++`` is on the PATH."""
    return shutil.which("g++") is not None
