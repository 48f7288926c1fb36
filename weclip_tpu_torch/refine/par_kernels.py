"""PAR kernels K4 and K5 (port of weclip_tpu/refine/pallas_par.py).

``par_affinity`` (K4) builds the (B, 48, H, W) mixing weights, one thread
per pixel; ``par_propagate`` (K5) runs the Jacobi iterations, one launch
per iteration between two ping-pong buffers (csrc/par.cu).  Given CPU
tensors they run the plain versions in refine/par.py; given CUDA tensors
they launch or raise.  The positional term is computed once on the host in
fp32 (refine.par.pos_weights) and added inside K4.
"""

from __future__ import annotations

import ctypes

import torch

from weclip_tpu_torch import kernels
from weclip_tpu_torch.core.config import ParConfig
from weclip_tpu_torch.refine import par as par_plain

_MAX_DIL = 6        # csrc/par.cu: kMaxDil
_MAX_CHANNELS = 32  # csrc/par.cu: largest channel template


def _dilations(cfg: ParConfig):
    if not 1 <= len(cfg.dilations) <= _MAX_DIL:
        raise ValueError(f"PAR kernels take 1..{_MAX_DIL} dilations, "
                         f"got {cfg.dilations}")
    return (ctypes.c_int * len(cfg.dilations))(*cfg.dilations)


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
    posw = par_plain.pos_weights(cfg).to(imgs.device)
    aff = torch.empty((b, 8 * len(cfg.dilations), h, w), device=imgs.device,
                      dtype=torch.float32)
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.call("par", "par_affinity", imgs.data_ptr(), aff.data_ptr(),
                     posw.data_ptr(), b, h, w, ctypes.cast(dil, ctypes.c_void_p),
                     len(cfg.dilations), ctypes.c_float(cfg.w1), stream)
    kernels.launches["par_affinity"] += 1
    return aff


def par_propagate(masks: torch.Tensor, aff: torch.Tensor, cfg: ParConfig) -> torch.Tensor:
    """K5: ``cfg.num_iter`` Jacobi iterations on (B, C, H, W) fp32 masks."""
    if not masks.is_cuda:
        return par_plain.par_propagate(masks, aff, cfg)
    _check("par_propagate", masks, aff)
    b, c, h, w = masks.shape
    n = 8 * len(cfg.dilations)
    if tuple(aff.shape) != (b, n, h, w):
        raise ValueError(f"par_propagate: aff {tuple(aff.shape)} != {(b, n, h, w)}")
    if c > _MAX_CHANNELS:
        raise ValueError(f"par_propagate: {c} channels > {_MAX_CHANNELS}")
    dil = _dilations(cfg)
    src, dst = masks.clone(), torch.empty_like(masks)
    with torch.cuda.device(masks.device):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(cfg.num_iter):
            kernels.call("par", "par_propagate", src.data_ptr(), dst.data_ptr(),
                         aff.data_ptr(), b, c, h, w,
                         ctypes.cast(dil, ctypes.c_void_p), len(cfg.dilations),
                         stream)
            kernels.launches["par_propagate"] += 1
            src, dst = dst, src
    return src
