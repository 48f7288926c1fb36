"""Attention fusion, Sinkhorn transition matrix and the affinity random walk
(a frozen copy of the plain math of
weclip_tpu_torch/refine/affinity.py), batched over images.

All products run in full fp32 (the JAX package's Precision.HIGHEST); TF32
is off (core.precision.strict_matmul)."""

from __future__ import annotations

from typing import Optional

import torch

from benchmark.reference.bbox import scoremap_box_mask
from benchmark.reference import precision


def fuse_attention_plain(layer_attn: torch.Tensor, attn_last: torch.Tensor,
                         n_fuse: int, num_patches: Optional[int] = None) -> torch.Tensor:
    """Mean of the last ``n_fuse`` of [frozen layers ; last], CLS dropped.
    layer_attn (K, B, L, L); attn_last (B, L, L).  Returns (B, P, P)."""
    pe = 1 + (num_patches if num_patches is not None else layer_attn.shape[-1] - 1)
    stack = torch.cat([layer_attn, attn_last[None]], dim=0)
    return stack[-n_fuse:, :, 1:pe, 1:pe].mean(dim=0)


def fuse_attention_gated(layer_attn: torch.Tensor, attn_last: torch.Tensor,
                         seg_attn: torch.Tensor, n_window: int,
                         valid_p: torch.Tensor) -> torch.Tensor:
    """Learned-affinity-gated fusion.  seg_attn (B, P, P) sigmoid Gram
    affinity; valid_p (B, P) so padded cells don't skew the layer
    selection."""
    pe = 1 + seg_attn.shape[1]
    stack = torch.cat([layer_attn, attn_last[None]], dim=0)
    tail = stack[-n_window:, :, 1:pe, 1:pe]                    # (W, B, P, P)
    vp = valid_p.float()
    vm = (vp[:, :, None] * vp[:, None, :])[None]
    diff = ((seg_attn[None] - tail) * vm).sum(dim=(2, 3))     # (W, B)
    thr = diff.mean(dim=0, keepdim=True)
    sel = (diff <= thr).float()
    num = precision.einsum("wb,wbpq->bpq", sel, tail)
    den = sel.sum(dim=0)[:, None, None] + 1e-5
    return num / den * seg_attn


def sinkhorn_transition(aff: torch.Tensor, valid_p: torch.Tensor,
                        rounds: int = 3) -> torch.Tensor:
    """Column/row normalization rounds + symmetrize + one self-product,
    masked to valid cells.  aff (..., P, P) nonnegative; valid_p (..., P)
    bool."""
    vm2 = valid_p[..., :, None] & valid_p[..., None, :]
    a = torch.where(vm2, aff.float(), torch.zeros((), device=aff.device))
    for _ in range(rounds):
        col = a.sum(dim=-2, keepdim=True)
        a = a / torch.where(col > 0, col, torch.ones_like(col))
        row = a.sum(dim=-1, keepdim=True)
        a = a / torch.where(row > 0, row, torch.ones_like(row))
    a = (a + a.transpose(-1, -2)) / 2.0
    a = precision.matmul(a, a)
    return torch.where(vm2, a, torch.zeros((), device=aff.device))


def random_walk_cams(cams: torch.Tensor, trans_mat: torch.Tensor,
                     valid_grid: torch.Tensor, gh: torch.Tensor,
                     gw: torch.Tensor, bbox_threshold: float) -> torch.Tensor:
    """Per-class box-masked random walk ``(trans * box) @ cam``.

    cams (B, C, P); trans_mat (B, P, P); valid_grid (B, G0, G1) bool;
    gh, gw (B,).  Returns (B, C, P)."""
    b, c, p = cams.shape
    g0, g1 = valid_grid.shape[-2:]
    box = scoremap_box_mask(
        cams.reshape(b * c, g0, g1),
        valid_grid[:, None].expand(b, c, g0, g1).reshape(b * c, g0, g1),
        gh.repeat_interleave(c), gw.repeat_interleave(c),
        bbox_threshold).reshape(b, c, p)
    # box is {0,1}, so (trans * box) @ cam == trans @ (box * cam) exactly
    return precision.einsum("bpq,bcq->bcp", trans_mat, box * cams)


def gram_affinity(fts: torch.Tensor, valid_p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Learned affinity head: sigmoid(F F^T).  fts (B, P, C) -> (B, P, P)."""
    f = fts.float()
    g = torch.sigmoid(precision.matmul(f, f.transpose(1, 2)))
    if valid_p is not None:
        vp = valid_p.float()
        g = g * (vp[:, :, None] * vp[:, None, :])
    return g
