"""Torch-parity resampling (a frozen copy of the plain math of
weclip_tpu_torch/ops/resize.py): bilinear as
two 1-D interpolation matrices, nearest as two index gathers.

``align_corners=False`` serves the positional-embedding and CAM/logit
upsampling; ``align_corners=True`` the PAR image resampling.  The products
run in full fp32 (TF32 off, see core.precision.strict_matmul).  Nearest is
torch's ``F.interpolate(mode="nearest")`` (source floor(dst * in / out))."""

from __future__ import annotations

import numpy as np
import torch
from benchmark.reference import precision


def _linear_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """(out_size, in_size) row-stochastic bilinear interpolation matrix."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners and out_size > 1:
        src = dst * (in_size - 1) / (out_size - 1)
    elif align_corners:
        src = np.zeros_like(dst)
    else:
        scale = in_size / out_size
        src = (dst + 0.5) * scale - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = src - lo
    w_lo = 1.0 - w_hi
    m = np.zeros((out_size, in_size), dtype=np.float64)
    m[np.arange(out_size), lo] += w_lo
    m[np.arange(out_size), hi] += w_hi
    return m.astype(np.float32)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize over the last two axes (torch F.interpolate
    semantics; cv2.resize INTER_LINEAR when align_corners=False)."""
    in_h, in_w = x.shape[-2], x.shape[-1]
    mh = torch.from_numpy(_linear_matrix(in_h, out_h, align_corners)).to(x.device)
    mw = torch.from_numpy(_linear_matrix(in_w, out_w, align_corners)).to(x.device)
    dt = x.dtype if x.is_floating_point() else torch.float32
    y = precision.matmul(mh, x.float())                       # (..., out_h, in_w)
    y = precision.matmul(y, mw.t())                           # (..., out_h, out_w)
    return y.to(dt)


def upsample_pos_emb(pos_emb: torch.Tensor, grid_h: int, grid_w: int) -> torch.Tensor:
    """Resample a (1 + g*g, D) CLIP positional embedding to (1 + gh*gw, D)
    (bilinear, align_corners=False, CLS kept)."""
    n = pos_emb.shape[0] - 1
    g = int(round(n ** 0.5))
    if g * g != n:
        raise ValueError(f"pos emb is not square: {n}")
    cls_tok, grid = pos_emb[:1], pos_emb[1:]
    d = grid.shape[-1]
    grid = grid.reshape(g, g, d).permute(2, 0, 1)         # (D, g, g)
    grid = resize_bilinear(grid, grid_h, grid_w, align_corners=False)
    grid = grid.permute(1, 2, 0).reshape(grid_h * grid_w, d)
    return torch.cat([cls_tok, grid], dim=0)
