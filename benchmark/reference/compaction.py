"""Class-set compaction: static buckets of *present* classes
(a frozen copy of the plain math of
weclip_tpu_torch/core/compaction.py, host-side numpy).

GradCAM pullbacks, walk products and PAR channels run on a small bucket of
the classes present in each image instead of all foreground classes."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def pick_bucket(presents: np.ndarray, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits every image's present-class count."""
    count = int(presents.sum(axis=1).max()) if len(presents) else 1
    for b in buckets:
        if b >= max(count, 1):
            return b
    return buckets[-1]


def compact_classes(presents: np.ndarray, mc: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(B, C_fg) bool -> (cls_idx (B, mc) int64, active (B, mc) bool)."""
    b = presents.shape[0]
    cls_idx = np.zeros((b, mc), np.int64)
    active = np.zeros((b, mc), bool)
    for i in range(b):
        ids = np.where(presents[i])[0][:mc]
        cls_idx[i, :len(ids)] = ids
        active[i, :len(ids)] = True
    return cls_idx, active
