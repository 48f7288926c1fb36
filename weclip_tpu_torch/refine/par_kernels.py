"""PAR kernels K4 and K5 (port of weclip_tpu/refine/pallas_par.py).

``par_affinity`` (K4) builds the (B, 48, H, W) mixing weights and
``par_propagate`` (K5) runs the Jacobi iterations; both work on 2-D pixel
tiles staged in shared memory with their replicated halo (csrc/par.cu).
K5's C entry point issues all ``cfg.num_iter`` launches itself, one per
iteration, alternating between two output buffers.  Given CPU tensors
they run the plain versions in refine/par.py; given CUDA tensors they
launch or raise.  The positional term is computed once per config on the
host in fp32 (refine.par.pos_weights) and passed to K4 as kernel
arguments.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from weclip_tpu_torch import kernels
from weclip_tpu_torch.core.config import ParConfig
from weclip_tpu_torch.refine import par as par_plain

_MAX_DIL = 6        # csrc/par.cu: kMaxDil
_MAX_DILATION = 24  # csrc/par.cu: kHalo, the halo the tiles stage


def _dilations(cfg: ParConfig):
    if not 1 <= len(cfg.dilations) <= _MAX_DIL or not all(
            1 <= d <= _MAX_DILATION for d in cfg.dilations):
        raise ValueError(f"PAR kernels take 1..{_MAX_DIL} dilations in "
                         f"1..{_MAX_DILATION}, got {cfg.dilations}")
    return (ctypes.c_int * len(cfg.dilations))(*cfg.dilations)


@functools.lru_cache(maxsize=None)
def _pos_weights(dilations, w1: float, w2: float):
    """``pos_weights`` of the config as a host float array, computed once;
    K4 takes it as kernel arguments, so nothing is copied to the card."""
    w = par_plain.pos_weights(ParConfig(dilations=dilations, w1=w1, w2=w2))
    return (ctypes.c_float * len(w))(*w.tolist())


def _check(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous fp32 CUDA tensors, "
                             f"got {t.dtype} on {t.device}")


def par_affinity(imgs: torch.Tensor, cfg: ParConfig) -> torch.Tensor:
    """K4: (B, 3, H, W) fp32 -> (B, 8*len(dilations), H, W) fp32."""
    if not imgs.is_cuda:
        return par_plain.par_affinity(imgs, cfg)
    _check("par_affinity", imgs)
    b, c, h, w = imgs.shape
    if c != 3:
        raise ValueError(f"par_affinity: expected 3 channels, got {c}")
    dil = _dilations(cfg)
    posw = _pos_weights(tuple(cfg.dilations), cfg.w1, cfg.w2)
    aff = torch.empty((b, 8 * len(cfg.dilations), h, w), device=imgs.device,
                      dtype=torch.float32)
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.call("par", "par_affinity", imgs.data_ptr(), aff.data_ptr(),
                     ctypes.cast(posw, ctypes.c_void_p), b, h, w,
                     ctypes.cast(dil, ctypes.c_void_p),
                     len(cfg.dilations), ctypes.c_float(cfg.w1), stream)
    kernels.launches["par_affinity"] += 1
    return aff


def par_propagate(masks: torch.Tensor, aff: torch.Tensor, cfg: ParConfig) -> torch.Tensor:
    """K5: ``cfg.num_iter`` Jacobi iterations on (B, C, H, W) fp32 masks,
    any C >= 1 (the kernel walks the channels in chunks of at most 6, each
    chunk re-reading the affinities).

    The first iteration reads ``masks`` and writes a new buffer, so the
    caller's masks are never written and need no copy."""
    if not masks.is_cuda:
        return par_plain.par_propagate(masks, aff, cfg)
    _check("par_propagate", masks, aff)
    b, c, h, w = masks.shape
    n = 8 * len(cfg.dilations)
    if tuple(aff.shape) != (b, n, h, w):
        raise ValueError(f"par_propagate: aff {tuple(aff.shape)} != {(b, n, h, w)}")
    dil = _dilations(cfg)
    if cfg.num_iter == 0:
        return masks
    out = torch.empty_like(masks)
    tmp = torch.empty_like(masks) if cfg.num_iter > 1 else None
    with torch.cuda.device(masks.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.call("par", "par_propagate", masks.data_ptr(), out.data_ptr(),
                     None if tmp is None else tmp.data_ptr(), aff.data_ptr(),
                     b, c, h, w, ctypes.cast(dil, ctypes.c_void_p),
                     len(cfg.dilations), cfg.num_iter, stream)
    kernels.launches["par_propagate"] += cfg.num_iter
    return out
