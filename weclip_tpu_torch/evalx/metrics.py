"""Streaming segmentation metrics (port of weclip_tpu/evalx/metrics.py).

The confusion histograms live on the device as int64 and grow by one
``bincount`` per batch, so every count is exact: the JAX package keeps them
in float32, which stops counting a cell past 2^24 pixels (VOC val's
background cell is past it).  ``scores`` reads a finished histogram on the
host, as the JAX package does.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def confusion_update(hist: torch.Tensor, gt: torch.Tensor, pred: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """hist + counts of (gt, pred) pairs over the pixels with
    0 <= gt < num_classes; predictions outside [0, num_classes) are clamped
    into it, as the JAX one-hot product does."""
    g = gt.reshape(-1).long()
    p = pred.reshape(-1).long().clamp(0, num_classes - 1)
    keep = (g >= 0) & (g < num_classes)
    counts = torch.bincount(num_classes * g[keep] + p[keep],
                            minlength=num_classes * num_classes)
    return hist + counts.reshape(num_classes, num_classes).to(hist.dtype)


def scores(hist: np.ndarray) -> Dict[str, object]:
    """pAcc, mAcc, mIoU over the classes with ground truth, and per-class IoU."""
    hist = np.asarray(hist, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = np.diag(hist).sum() / hist.sum()
        acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
        iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist))
    valid = hist.sum(axis=1) > 0
    mean_iu = np.nanmean(iu[valid])
    return {"pAcc": acc, "mAcc": acc_cls, "miou": mean_iu,
            "iou": dict(zip(range(hist.shape[0]), iu))}


def zero_hist(num_classes: int, device="cpu") -> torch.Tensor:
    return torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)


def pseudo_scores(label_trues, label_preds, num_classes: int = 21):
    """Pseudo-label scores that leave out the pixels predicted 255: their
    ground truth becomes 255 (ignored) and their prediction 0."""
    hist = np.zeros((num_classes, num_classes), np.float64)
    for lt, lp in zip(label_trues, label_preds):
        lt = np.array(lt).flatten()
        lp = np.array(lp).flatten()
        lt[lp == 255] = 255
        lp = np.where(lp == 255, 0, lp)
        m = (lt >= 0) & (lt < num_classes)
        hist += np.bincount(num_classes * lt[m].astype(np.int64) + lp[m],
                            minlength=num_classes ** 2
                            ).reshape(num_classes, num_classes)
    return scores(hist)
