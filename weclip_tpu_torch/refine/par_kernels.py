"""PAR kernels K4 and K5 (port of weclip_tpu/refine/pallas_par.py).

``par_affinity`` (K4) builds the (B, 8n, H, W) mixing weights and
``par_propagate`` (K5) runs the Jacobi iterations; both work on 2-D pixel
tiles staged in shared memory with their replicated halo (csrc/par.cu).
K5's C entry point issues all ``cfg.num_iter`` launches itself, one per
iteration, alternating between two output buffers.  Given CPU tensors
they run the plain versions in refine/par.py; given CUDA tensors they
launch or raise.  The positional term is computed once per config on the
host in fp32 (refine.par.pos_weights).

Any set of dilations runs: each dilation is handed over as min(d,
max(H, W) - 1) (at least 1), which reads the same clamped neighbours, and
the neighbours past the staged halo of 24 are read through L2.  K4 reads
the dilations and positional weights from device copies cached here per
(set, device).  K5 runs up to 6 dilations of at most 24 in its packed form
(the dilations passed by value) and any other set in its far form, which
reads them from the device copy (``far=True`` asks for it on any set).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from weclip_tpu_torch import kernels
from weclip_tpu_torch.core.config import ParConfig
from weclip_tpu_torch.refine import par as par_plain


def effective_dilations(dilations, h: int, w: int):
    """Each dilation as the kernels take it: min(d, max(h, w) - 1), at least
    1.  A larger dilation reads the clamped edge in every direction, as that
    one does, so the neighbours are the same."""
    if not dilations or not all(int(d) >= 1 for d in dilations):
        raise ValueError(f"PAR kernels take one or more dilations >= 1, got {dilations}")
    return tuple(max(1, min(int(d), max(h, w) - 1)) for d in dilations)


def packed(dilations) -> bool:
    """Whether K5's packed form takes these (effective) dilations: at most
    6, each at most 24 (csrc/par.cu: kMaxDil, kHalo)."""
    return len(dilations) <= 6 and max(dilations) <= 24


@functools.lru_cache(maxsize=None)
def _pos_weights(dilations, w1: float, w2: float):
    """``pos_weights`` of the config as a host float array, computed once
    (its device copy: ``_on_device``)."""
    w = par_plain.pos_weights(ParConfig(dilations=dilations, w1=w1, w2=w2))
    return (ctypes.c_float * len(w))(*w.tolist())


@functools.lru_cache(maxsize=None)
def _on_device(values, dtype, device):
    """A device copy of a tuple, made once (the dilations and positional
    weights the kernels read)."""
    return torch.tensor(values, dtype=dtype, device=device)


def _check(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous fp32 CUDA tensors, "
                             f"got {t.dtype} on {t.device}")


def par_affinity(imgs: torch.Tensor, cfg: ParConfig) -> torch.Tensor:
    """K4: (B, 3, H, W) fp32 -> (B, 8*len(dilations), H, W) fp32, any
    dilation set."""
    if not imgs.is_cuda:
        return par_plain.par_affinity(imgs, cfg)
    _check("par_affinity", imgs)
    b, c, h, w = imgs.shape
    if c != 3:
        raise ValueError(f"par_affinity: expected 3 channels, got {c}")
    dil = effective_dilations(cfg.dilations, h, w)
    posw = _pos_weights(tuple(cfg.dilations), cfg.w1, cfg.w2)
    aff = torch.empty((b, 8 * len(dil), h, w), device=imgs.device, dtype=torch.float32)
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.call("par", "par_affinity", imgs.data_ptr(), aff.data_ptr(),
                     _on_device(tuple(posw), torch.float32, imgs.device).data_ptr(), b, h, w,
                     _on_device(dil, torch.int32, imgs.device).data_ptr(), len(dil),
                     ctypes.c_float(cfg.w1), stream)
    kernels.count_launch("par_affinity", (b, h, w))
    return aff


def par_propagate(masks: torch.Tensor, aff: torch.Tensor, cfg: ParConfig,
                  far: Optional[bool] = None) -> torch.Tensor:
    """K5: ``cfg.num_iter`` Jacobi iterations on (B, C, H, W) fp32 masks,
    any C >= 1 (the kernel walks the channels in chunks of at most 6, each
    chunk re-reading the affinities).  ``far``: None picks the form by the
    dilations, True runs the far form.

    The first iteration reads ``masks`` and writes a new buffer, so the
    caller's masks are never written and need no copy."""
    if not masks.is_cuda:
        return par_plain.par_propagate(masks, aff, cfg)
    _check("par_propagate", masks, aff)
    b, c, h, w = masks.shape
    n = 8 * len(cfg.dilations)
    if tuple(aff.shape) != (b, n, h, w):
        raise ValueError(f"par_propagate: aff {tuple(aff.shape)} != {(b, n, h, w)}")
    dil = effective_dilations(cfg.dilations, h, w)
    if cfg.num_iter == 0:
        return masks
    out = torch.empty_like(masks)
    tmp = torch.empty_like(masks) if cfg.num_iter > 1 else None
    with torch.cuda.device(masks.device):
        stream = torch.cuda.current_stream().cuda_stream
        if far or (far is None and not packed(dil)):
            name, dils = "par_propagate_far", _on_device(dil, torch.int32,
                                                         masks.device).data_ptr()
        else:
            name = "par_propagate"
            dils = ctypes.cast((ctypes.c_int * len(dil))(*dil), ctypes.c_void_p)
        kernels.call("par", name, masks.data_ptr(), out.data_ptr(),
                     None if tmp is None else tmp.data_ptr(), aff.data_ptr(),
                     b, c, h, w, dils, len(dil), cfg.num_iter, stream)
    kernels.count_launch("par_propagate", (b, c, h, w), cfg.num_iter)
    return out
