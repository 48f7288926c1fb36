"""Build, load and count the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  The build
happens at first use (or up front through ``build()``, which starts one
``nvcc`` per source, all at once) into ``_build/`` beside this file; a
library is named after a hash of its source, the headers it includes and
the flags, so an edited source or header is rebuilt.  Every C entry point
returns ``cudaGetLastError()`` after its launches, and ``call`` raises on
anything but 0.

``count_launch`` counts kernel launches in the program's recorder
(``utils/spans.py``) by kernel and shape, and by the stage that launched
them; ``launches`` is the by-kernel view of those counts.  Only the
wrappers in ``ops/attention_kernels.py``, ``ops/block_epilogue.py``,
``refine/par_kernels.py`` and ``refine/crf_kernels.py`` count, at the point
where they launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Set, Tuple

from weclip_tpu_torch.utils import spans

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]
_INCLUDE = re.compile(r'\s*#\s*include\s+"([^"]+)"')

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: every function returns the cudaError_t of its launches
SIGNATURES = {
    "attention": {
        # fp32 q (unscaled), k, kbias (padded to 64 keys), stats (from
        # xattn_fwd), map, B, H, L, Dh, scale, stream
        "attn_map_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
        # the same in bf16, Dh > 128 (stats from xattn_fwd_bf16)
        "attn_map_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    },
    "flash_attention": {
        # bf16 q, k, v, kbias (padded to 64 keys), out, stats (or None), B,
        # H, L, Dh, scale, stream
        "flash_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
        # bf16 q, k, kbias (padded), stats, map, B, H, L, Dh, scale, stream
        "attn_map": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
        # q, k, v, do (bf16), kbias (padded), dq, dk, dv, stats, B, H, Lq,
        # Lk, Dh, scale, stream
        "flash_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                      _I, _F, _P],
    },
    "hopper_attention": {
        # bf16 q (pre-scaled), k, v, kbias (padded), fp32 out, B, H, Lq, Lk,
        # Dh, stream
        "xattn_fwd_wgmma": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "cross_attention": {
        # fp32 q (unscaled), k, v, kbias (padded), out, stats (or None), B,
        # H, Lq, Lk, Dh, scale, stream
        "xattn_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
        # the same in bf16, Dh > 128, out bf16 or (out_f32) fp32
        "xattn_fwd_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                           _P],
        # fp32 q (unscaled), k, v, do, kbias (padded), dq, dk, dv, stats, B,
        # H, Lq, Lk, Dh, scale, stream
        "xattn_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                      _I, _F, _P],
        # the same in bf16, Dh > 128
        "xattn_bwd_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _I, _I, _F, _P],
    },
    "par": {
        # img, aff, posw (device: the 8 * n_dil positional weights), B, H,
        # W, dilations (device), n_dil, w1, stream
        "par_affinity": [_P, _P, _P, _I, _I, _I, _P, _I, _F, _P],
        # src, dst, tmp, aff, B, C, H, W, dilations (host), n_dil,
        # num_iter, stream
        "par_propagate": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P],
        # the far form: the same, dilations in device memory
        "par_propagate_far": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P],
    },
    "block_epilogue": {
        # bf16 g (B * L, 3D), in_b, q, k, v (B, H, L, Dh), B, L, H, Dh,
        # stream
        "qkv_bias_split": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        # bf16 x (or None), g, bias (or None), bool rowmask (or None), fp32
        # gamma, beta, bf16 y (or None), ln (or None), rows, D, eps, stream
        "residual_ln": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P],
        # bf16 g, bias, out (may be g), rows, F, stream
        "bias_quick_gelu": [_P, _P, _P, _I, _I, _P],
    },
    "crf": {
        # fp32 q (or None when C == 0), img, acc, norm, B, C, hs, ws, r,
        # sigma^2, stream
        "crf_window": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
        # C, hs, ws, r, out (6 ints, host): the launch's n-tiles, halo
        # columns, columns a unit, row stride, units a row, shared bytes
        "crf_window_geometry": [_I, _I, _I, _I, _P],
    },
}

# kernel name -> launches; see module docstring
launches = spans.CounterView(spans.RECORDER, spans.LAUNCHES, (
    "attention_fwd_export",   # K1
    "attention_fwd",          # K2
    "attention_bwd",          # K3
    "cross_attention",        # K6
    "attention_bwd_rect",     # K3-rect
    "par_affinity",           # K4
    "par_propagate",          # K5
    "crf_window",             # K7
    "qkv_bias_split",         # the frozen block's passes (csrc/block_epilogue.cu)
    "residual_ln",
    "bias_quick_gelu",
))

_libs: Dict[str, ctypes.CDLL] = {}


def count_launch(name: str, shape: Tuple[int, ...], n: int = 1) -> None:
    """Count ``n`` launches of kernel ``name`` at ``shape``."""
    if name not in launches:
        raise KeyError(f"no kernel {name!r} is counted")
    spans.count(spans.LAUNCHES, n, key=(name, tuple(shape)))


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _headers(path: Path, seen: Set[Path]) -> None:
    """Add to ``seen`` every header under csrc/ that ``path`` includes, at
    any depth (``#include "..."``)."""
    for line in path.read_text().splitlines():
        m = _INCLUDE.match(line)
        if m:
            hdr = _CSRC / m.group(1)
            if hdr.exists() and hdr not in seen:
                seen.add(hdr)
                _headers(hdr, seen)


def _lib_path(name: str) -> Path:
    """The library's path, named after a hash of the source, every header
    it includes, and the flags."""
    src = _CSRC / f"{name}.cu"
    headers: Set[Path] = set()
    _headers(src, headers)
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(headers):
        h.update(hdr.name.encode() + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) in parallel, one nvcc each.

    Returns seconds per source (0.0 for a library already built).  Raises
    with the compiler's output if any build fails."""
    names = list(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, t0, took = {}, time.perf_counter(), {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            took[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
               str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return took


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    if name not in _libs:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        so = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(so, fn).argtypes = argtypes
            getattr(so, fn).restype = ctypes.c_int
        _libs[name] = so
    return _libs[name]


def call(name: str, fn: str, *args) -> int:
    """Call ``fn`` of library ``name``; raise if it reports a CUDA error."""
    rc = getattr(lib(name), fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}.{fn}: CUDA error {rc}")
    return rc
