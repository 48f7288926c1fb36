"""The port's metrics (weclip_tpu_torch/evalx/metrics.py) against the JAX
package's on the same numpy-seeded labels: confusion histograms equal
exactly, scores to 1e-12, the pseudo-label scores with their predicted-255
rule; and the port's int64 histograms count past 2^24 exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from weclip_tpu.evalx import metrics as jmetrics
from weclip_tpu_torch.evalx import metrics as tmetrics

K = 6


def _labels(seed):
    rng = np.random.default_rng(seed)
    gt = rng.integers(0, K, (3, 17, 23)).astype(np.int32)
    gt[0, :4] = 255                                   # ignored
    gt[1, 5, :] = -1                                  # outside [0, K)
    pred = rng.integers(0, K, (3, 17, 23)).astype(np.int32)
    pred[2, :, :3] = K + 4                            # clamped into [0, K)
    return gt, pred


def _assert_scores_equal(got, ref):
    for key in ("pAcc", "mAcc", "miou"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-12, err_msg=key)
    np.testing.assert_allclose(np.array(list(got["iou"].values())),
                               np.array(list(ref["iou"].values())), rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_confusion_update_and_scores_match_jax(seed):
    gt, pred = _labels(seed)
    ref = jmetrics.zero_hist(K)
    got = tmetrics.zero_hist(K)
    assert got.dtype == torch.int64
    for _ in range(2):      # accumulates across calls
        ref = jmetrics.confusion_update(ref, jnp.asarray(gt), jnp.asarray(pred), num_classes=K)
        got = tmetrics.confusion_update(got, torch.from_numpy(gt), torch.from_numpy(pred), K)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(np.int64))
    assert int(got.sum()) == 2 * int(((gt >= 0) & (gt < K)).sum())
    _assert_scores_equal(tmetrics.scores(got.numpy()), jmetrics.scores(np.asarray(ref)))


def test_pseudo_scores_match_jax():
    """Pixels predicted 255 are left out: ground truth becomes 255, the
    prediction 0."""
    gt, pred = _labels(2)
    gt[gt < 0] = 255
    pred = pred.clip(0, K - 1)
    pred[:, ::3, ::2] = 255
    got = tmetrics.pseudo_scores(list(gt), list(pred), num_classes=K)
    _assert_scores_equal(got, jmetrics.pseudo_scores(list(gt), list(pred), num_classes=K))
    kept = pred != 255
    want = jmetrics.pseudo_scores(list(np.where(kept, gt, 255)), list(np.where(kept, pred, 0)),
                                  num_classes=K)
    _assert_scores_equal(got, want)


def test_histogram_counts_past_float32():
    """A cell at 2^24 that gains one pixel reads 2^24 + 1 (float32 would
    stay at 2^24)."""
    hist = tmetrics.zero_hist(K)
    hist[0, 0] = 2 ** 24
    one = torch.zeros((1, 1), dtype=torch.int64)
    hist = tmetrics.confusion_update(hist, one, one, K)
    assert int(hist[0, 0]) == 2 ** 24 + 1
    assert np.float32(2 ** 24) + np.float32(1) == np.float32(2 ** 24)
