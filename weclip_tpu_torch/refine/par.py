"""PAR — pixel-adaptive refinement (port of weclip_tpu/refine/par.py).

8 neighbours at each dilation (48 at (1,2,4,8,12,24)), replicate padding,
an appearance softmax over the neighbours of -(|I_k - I| / (std + 1e-8) /
w1)^2 averaged over RGB, a positional softmax weighted by w2, then
``num_iter`` Jacobi iterations masks <- sum_k aff_k * neighbour_k(masks).

``par_refine`` is the plain version; ``par_refine_auto`` runs the same
steps through the kernel wrappers of refine/par_kernels.py (K4, K5), which
launch on CUDA tensors and take the plain steps on CPU ones.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from weclip_tpu_torch.core.config import ParConfig
from weclip_tpu_torch.ops.resize import resize_bilinear

# 8-neighbour offsets in the reference's kernel order
_OFFSETS: Tuple[Tuple[int, int], ...] = (
    (-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1),
)
# diagonal neighbours carry sqrt(2) positional distance
_POS_DIST = (math.sqrt(2), 1.0, math.sqrt(2), 1.0, 1.0,
             math.sqrt(2), 1.0, math.sqrt(2))


def shifts(dilations: Sequence[int]):
    """(dy, dx) of every neighbour, dilation-major over _OFFSETS."""
    return [(dy * d, dx * d) for d in dilations for (dy, dx) in _OFFSETS]


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-replicated shift: out[..., y, x] = x[..., clamp(y+dy), clamp(x+dx)]."""
    h, w = x.shape[-2:]
    d = max(abs(dy), abs(dx))
    lead = x.shape[:-2]
    xp = F.pad(x.reshape(-1, 1, h, w), (d, d, d, d), mode="replicate")
    return xp[:, :, d + dy:d + dy + h, d + dx:d + dx + w].reshape(*lead, h, w)


def _pos_kernel(dilations: Sequence[int]) -> np.ndarray:
    return np.asarray([p * d for d in dilations for p in _POS_DIST], np.float32)


def pos_weights(cfg: ParConfig) -> torch.Tensor:
    """w2 * softmax of the positional logits over the neighbours, in fp32
    (a per-config constant)."""
    pos = _pos_kernel(cfg.dilations)
    pos_std = float(np.std(pos, ddof=1))
    pos_aff = torch.from_numpy(-((pos / (pos_std + 1e-8) / cfg.w1) ** 2))
    return (cfg.w2 * torch.softmax(pos_aff.float(), dim=0)).float()


def par_affinity(imgs: torch.Tensor, cfg: ParConfig) -> torch.Tensor:
    """(B, 3, H, W) fp32 -> (B, 48, H, W) mixing weights, one-pass moments
    with the unbiased std."""
    sh = [_shift(imgs, dy, dx) for dy, dx in shifts(cfg.dilations)]
    n = len(sh)
    s1 = sum(sh)
    s2 = sum(t * t for t in sh)
    mean = s1 / n
    var = torch.clamp_min((s2 - n * mean * mean) / (n - 1), 0.0)
    inv = 1.0 / ((torch.sqrt(var) + 1e-8) * cfg.w1)
    aff = torch.stack([(-((t - imgs).abs() * inv) ** 2).mean(dim=1) for t in sh], dim=1)
    aff = torch.softmax(aff, dim=1)
    return aff + pos_weights(cfg).to(imgs.device)[None, :, None, None]


def par_propagate(masks: torch.Tensor, aff: torch.Tensor, cfg: ParConfig) -> torch.Tensor:
    """``cfg.num_iter`` Jacobi iterations of masks <- sum_k aff_k * shift_k."""
    m = masks.float()
    for _ in range(cfg.num_iter):
        acc = torch.zeros_like(m)
        for k, (dy, dx) in enumerate(shifts(cfg.dilations)):
            acc = acc + _shift(m, dy, dx) * aff[:, None, k]
        m = acc
    return m


def _to_mask_size(imgs: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    hm, wm = masks.shape[-2:]
    imgs = imgs.float()
    if imgs.shape[-2:] != (hm, wm):
        imgs = resize_bilinear(imgs, hm, wm, align_corners=True)
    return imgs


def par_refine(imgs: torch.Tensor, masks: torch.Tensor, cfg: ParConfig) -> torch.Tensor:
    """Refine (B, C, Hm, Wm) mask scores guided by (B, 3, H, W) images,
    resized to the mask size with align_corners=True first."""
    imgs = _to_mask_size(imgs, masks)
    return par_propagate(masks, par_affinity(imgs, cfg), cfg)


@torch.no_grad()
def par_refine_auto(imgs: torch.Tensor, masks: torch.Tensor, cfg: ParConfig) -> torch.Tensor:
    """``par_refine`` through the kernel wrappers (K4 + K5 on CUDA)."""
    from weclip_tpu_torch.refine import par_kernels
    imgs = _to_mask_size(imgs, masks)
    aff = par_kernels.par_affinity(imgs.contiguous(), cfg)
    return par_kernels.par_propagate(masks.float().contiguous(), aff, cfg)
