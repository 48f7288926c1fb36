"""Build and load the port's own copy of the permutohedral dense-CRF library
(``permutohedral.cc``, the C ABI ``permutohedral_filter`` and
``dense_crf_inference``), the counterpart of weclip_tpu/native/build.py.

g++ compiles it at first use with the JAX package's flags into
``weclip_tpu_torch/_build/``, named after a hash of the source and the
flags, as ``kernels.py`` names its CUDA libraries; nothing is written into
the source tree.  A failing compile raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parent / "permutohedral.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def lib_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libpermutohedral_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The library's path, compiled first if it is not there."""
    out = lib_path()
    with _lock:
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ permutohedral.cc failed ({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.permutohedral_filter.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int, f32p]
        lib.permutohedral_filter.restype = None
        lib.dense_crf_inference.argtypes = [
            f32p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float]
        lib.dense_crf_inference.restype = None
        _lib = lib
    return _lib
