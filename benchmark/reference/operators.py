"""Per-image resize operators for shape-static evaluation
(a frozen copy of the plain math of
weclip_tpu_torch/evalx/operators.py).

Each variable-size bilinear resize is a pair of per-image interpolation
matrices on fixed canvases; rows past an image's true extent clamp to its
last row, so canvas padding is edge-replicated (which makes PAR's replicate
padding exact on the padded canvas).  The evaluation path builds them on
the device from the sizes, batched over images (``device_*``); the host
versions (numpy, cached) give the same matrices for one size at a time,
and ``resize_by_scale`` resizes one image on the host with torch's
``scale_factor`` coordinates."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _src_coords(dst: np.ndarray, in_size: int, out_size: int,
                align_corners: bool) -> np.ndarray:
    if align_corners and out_size > 1:
        src = dst * (in_size - 1) / (out_size - 1)
    elif align_corners:
        src = np.zeros_like(dst)
    else:
        src = (dst + 0.5) * (in_size / out_size) - 0.5
    return np.clip(src, 0.0, in_size - 1)


def _hat_rows(src: np.ndarray, in_size: int, n_cols: int) -> np.ndarray:
    """(len(src), n_cols) float32 bilinear rows at source coordinates
    ``src``, already clamped to the ``in_size`` source cells."""
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = src - lo
    m = np.zeros((len(src), n_cols), dtype=np.float32)
    rows = np.arange(len(src))
    # lo == hi only at the clamp boundary, where w_hi == 0
    m[rows, hi] = w_hi
    m[rows, lo] += 1.0 - w_hi
    return m


@lru_cache(maxsize=4096)
def clamp_resize_matrix(in_size: int, out_size: int, canvas: int, src_pad: int,
                        align_corners: bool = False) -> np.ndarray:
    """(canvas, src_pad) bilinear matrix: rows below ``out_size``
    interpolate the first ``in_size`` source cells, later rows repeat row
    ``out_size - 1`` (edge replication into the canvas padding).  Cached:
    the result is shared, do not write to it."""
    dst = np.minimum(np.arange(canvas, dtype=np.float64), out_size - 1)
    return _hat_rows(_src_coords(dst, in_size, out_size, align_corners), in_size,
                     src_pad)


@lru_cache(maxsize=4096)
def scale_factor_matrix(in_size: int, out_size: int, scale: float) -> np.ndarray:
    """(out_size, in_size) bilinear matrix with torch's ``scale_factor``
    coordinates, src = (dst + 0.5) / scale - 0.5 (not out / in: the two
    differ where in * scale is fractional).  Cached like
    ``clamp_resize_matrix``."""
    dst = np.arange(out_size, dtype=np.float64)
    src = np.clip((dst + 0.5) / scale - 0.5, 0.0, in_size - 1)
    return _hat_rows(src, in_size, in_size)


def resize_by_scale(img_chw: np.ndarray, out_hw, scale: float) -> np.ndarray:
    """Host bilinear resize of (C, H, W) to ``out_hw`` with
    ``scale_factor_matrix``'s coordinates."""
    oh, ow = out_hw
    mh = scale_factor_matrix(img_chw.shape[1], oh, scale)
    mw = scale_factor_matrix(img_chw.shape[2], ow, scale)
    out = np.tensordot(mh, img_chw, axes=(1, 1))          # (oh, C, W)
    return np.tensordot(out, mw, axes=(2, 1)).transpose(1, 0, 2)


def device_resize_matrix(in_size: torch.Tensor, out_size: torch.Tensor,
                         canvas: int, src_pad: int,
                         align_corners: bool = False) -> torch.Tensor:
    """(B,) sizes -> (B, canvas, src_pad) clamp-resize matrices: bilinear
    weights as the hat function max(0, 1 - |src(r) - c|)."""
    in_f = in_size.float()[:, None]
    out_f = out_size.float()[:, None]
    r = torch.arange(canvas, device=in_size.device, dtype=torch.float32)[None]
    dst = torch.minimum(r, out_f - 1.0)
    if align_corners:
        src = dst * (in_f - 1.0) / torch.clamp_min(out_f - 1.0, 1.0)
    else:
        src = (dst + 0.5) * (in_f / out_f) - 0.5
    src = torch.minimum(torch.clamp_min(src, 0.0), in_f - 1.0)
    c = torch.arange(src_pad, device=in_size.device, dtype=torch.float32)
    return torch.clamp_min(1.0 - (src[..., None] - c).abs(), 0.0)


def device_scale_matrix(in_size: torch.Tensor, out_size: torch.Tensor,
                        scale: float, canvas: int, src_pad: int) -> torch.Tensor:
    """Clamp-resize matrices with torch's scale_factor coordinate mapping
    (src = (dst + 0.5) / s - 0.5): the 0.75-scale TTA input is derived from
    the scale-1 tensor through the original scale."""
    in_f = in_size.float()[:, None]
    out_f = out_size.float()[:, None]
    r = torch.arange(canvas, device=in_size.device, dtype=torch.float32)[None]
    dst = torch.minimum(r, out_f - 1.0)
    src = (dst + 0.5) / torch.tensor(scale, dtype=torch.float32) - 0.5
    src = torch.minimum(torch.clamp_min(src, 0.0), in_f - 1.0)
    c = torch.arange(src_pad, device=in_size.device, dtype=torch.float32)
    return torch.clamp_min(1.0 - (src[..., None] - c).abs(), 0.0)
