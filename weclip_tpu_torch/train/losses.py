"""Training losses and affinity-label construction (port of
weclip_tpu/train/losses.py).

- ``seg_loss``: cross-entropy taken twice, once over background pixels and
  once over foreground pixels, averaged 50/50, both honouring the ignore
  index;
- ``aff_loss``: balanced positive/negative loss of the sigmoid Gram
  affinity against a {0, 1, 255} affinity label;
- ``cams_to_affinity_label``: pseudo labels sampled every ``patch`` pixels,
  pairwise equality, the radius neighbourhood and the ignore rows/columns.

The losses normalize by counts over the whole batch.  Under data
parallelism each data rank holds a slice of it: ``reduce`` (parallel/mesh.py::
psum over the mesh's data group) sums those counts over the data ranks, so
each rank's loss is its share of the global-batch loss and the shares sum
to it, as the JAX package's GSPMD computes it.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Optional, Tuple

import numpy as np
import torch


@lru_cache(maxsize=8)
def radius_mask(h: int, w: int, radius: int = 8) -> np.ndarray:
    """(hw, hw) 0/1 neighbourhood mask of a (h, w) grid."""
    ys, xs = np.mgrid[0:h, 0:w]
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    dy = np.abs(ys[:, None] - ys[None, :])
    dx = np.abs(xs[:, None] - xs[None, :])
    return ((dy <= radius) & (dx <= radius)).astype(np.float32)


def cams_to_affinity_label(cam_label: torch.Tensor, mask: torch.Tensor,
                           ignore_index: int = 255, patch: int = 16) -> torch.Tensor:
    """(B, H, W) pseudo labels -> (B, hw, hw) int64 affinity labels in
    {0, 1, ignore_index}."""
    flat = cam_label[:, ::patch, ::patch].reshape(cam_label.shape[0], -1)
    eq = (flat[:, :, None] == flat[:, None, :]).long()
    eq = eq.masked_fill(mask[None] == 0, ignore_index)
    is_ign = flat == ignore_index
    eq = eq.masked_fill(is_ign[:, None, :], ignore_index)     # ignore columns
    return eq.masked_fill(is_ign[:, :, None], ignore_index)   # ignore rows


Reduce = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _total(x: torch.Tensor, reduce: Reduce) -> torch.Tensor:
    return x if reduce is None else reduce(x)


def aff_loss(attn_pred: torch.Tensor, aff_label: torch.Tensor, reduce: Reduce = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Balanced affinity loss; returns (loss, pos_count, neg_count), the
    counts summed by ``reduce`` where given."""
    pos = (aff_label == 1).float()
    neg = (aff_label == 0).float()
    pos_count = _total(pos.sum(), reduce) + 1.0
    neg_count = _total(neg.sum(), reduce) + 1.0
    pos_loss = torch.sum(pos * (1.0 - attn_pred)) / pos_count
    neg_loss = torch.sum(neg * attn_pred) / neg_count
    return 0.5 * pos_loss + 0.5 * neg_loss, pos_count, neg_count


def _masked_ce(logits: torch.Tensor, label: torch.Tensor,
               valid: torch.Tensor, reduce: Reduce = None) -> torch.Tensor:
    """Mean cross-entropy over the pixels where ``valid`` (0 when none is),
    the count of those pixels summed by ``reduce`` where given."""
    logp = torch.log_softmax(logits.float(), dim=1)               # (B, K, H, W)
    lab = label.long().clamp(0, logits.shape[1] - 1)
    nll = -torch.gather(logp, 1, lab[:, None])[:, 0]
    v = valid.float()
    return torch.sum(nll * v) / _total(v.sum(), reduce).clamp_min(1.0)


def seg_loss(logits: torch.Tensor, label: torch.Tensor,
             ignore_index: int = 255, reduce: Reduce = None) -> torch.Tensor:
    """fg/bg-split cross-entropy.  logits (B, K, H, W); label (B, H, W)."""
    not_ign = label != ignore_index
    bg = _masked_ce(logits, label, not_ign & (label == 0), reduce)
    fg = _masked_ce(logits, label, not_ign & (label != 0), reduce)
    return 0.5 * (bg + fg)
