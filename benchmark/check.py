"""The numbers that decide ``correct``, each against its limit.

Training (the first three steps of the window's own step object, against
the reference's three):

- ``inputs``: the largest difference between the batches the program
  trained on and the reference's own derivation of them (images and class
  sets), exact;
- ``seg``: the step-1 segmentation logits' widest gap over their largest;
- ``cam``: the largest, over the three steps, of the norm of the gap
  between GradCAM's CAMs (K3's backward over the class rows) over the norm
  of the reference's; a norm, not the widest gap, because each class's CAM
  is min-max normalized, which blows a weak class's rounding up to whole
  units;
- ``attn_map``: the widest gap of block 11's head-mean attention map (K1's
  map) over its largest, in the three steps;
- ``par``: the widest gap of the program's PAR scores (K4 and K5's output
  on the chain's stack) from those the reference's chain tail makes from
  the program's walk output (PAR's stage alone, past the walk's
  thresholds), over their largest, in the three steps;
- ``par_label``: the widest gap by which the reference's PAR score (as in
  ``par``) of the program's pseudo label lies below the reference's best,
  over the largest score, in the three steps: a label that differs at a
  tie reads the tie's rounding, a wrong one a whole gap;
- ``loss``: the widest relative gap of a step's loss;
- ``grad``: the worst leaf's gap between the norms of the first gradient,
  program against reference, over the larger of the reference's norm of
  that leaf and of the median leaf;
- ``update``: the same for each leaf's change over the three steps.

Leaves whose reference gradient is under a thousandth of the median leaf's
(a key's bias under the softmax) move by rounding alone and are left out of
``grad`` and ``update``.

Evaluation (a seeded sample of the window's batches, and its histograms):

- ``logits``: the widest gap of the scale-1 (single and flip-averaged) and
  scale-0.75 logits over each image's valid grid, over its largest |logit|;
- ``msc_gap``: the widest gap by which the reference's msc logit of the
  program's predicted class lies below the reference's best, over the
  image's largest |logit|, at every pixel of the image;
- with the CAM chain, ``cam`` (over each sampled batch) and ``attn_map``
  (over each image's valid tokens) as in training, and ``par`` and
  ``par_label`` over each image's output canvas;
- ``hists``: how far the histograms' totals lie from the labelled pixels
  of every image evaluated, exact.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence, Tuple

import math

import numpy as np


def _gap(p: float, r: float, scale: float) -> float:
    return abs(p - r) / scale


def leaf_gaps(prog: Sequence[float], ref: Sequence[float], ref_grad: Sequence[float]
              ) -> List[float]:
    """Each counted leaf's gap of norms, over the larger of its reference
    norm and the median leaf's."""
    med_g = statistics.median(ref_grad)
    kept = [(p, r) for p, r, g in zip(prog, ref, ref_grad) if g >= 1e-3 * med_g]
    med = statistics.median([r for _, r in kept])
    return [_gap(p, r, max(r, med)) for p, r in kept]


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = a.float(), b.float().to(a.device)
    return float((a - b).abs().max()) / (float(b.abs().max()) or 1.0)


def _label_gap(labels, scores, lut) -> float:
    """The widest gap by which the score of each pixel's label lies below
    the pixel's best score, over the largest |score|: ``labels`` (B, H, W)
    class ids, ``scores`` (B, K, H, W), ``lut`` (B, K) the class id of each
    score row.  A label that no row carries reads inf."""
    import torch

    s = scores.float()
    hit = labels.to(s.device).long()[:, None] == lut.to(s.device).long()[:, :, None, None]
    chosen = torch.where(hit, s, torch.full_like(s, -math.inf)).amax(1)
    return float((s.amax(1) - chosen).max()) / (float(s.abs().max()) or 1.0)


def _rel_l2(a, b) -> float:
    """||a - b|| over ||b||, over the whole tensors."""
    a, b = a.float(), b.float().to(a.device)
    return float((a - b).norm()) / (float(b.norm()) or 1.0)


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog``: the program's readings (or the control's); ``ref``: the
    reference's, which followed them past the chain."""
    diff = 0.0
    for a, b in zip(prog["images"], ref["images"]):
        diff = max(diff, float(np.abs(np.asarray(a) - np.asarray(b)).max()))
    for a, b in zip(prog["present"], ref["present"]):
        diff = max(diff, float(np.sum(np.asarray(a) != np.asarray(b))))
    steps = len(ref["images"])
    if any(len(prog[k]) != steps for k in ("images", "labels", "par", "cams", "attn_last")) \
            or len(ref["tail_par"]) != steps:
        diff = float("inf")
    losses = [_gap(p, r, abs(r)) for p, r in zip(prog["loss"], ref["loss"])]
    return {"inputs": diff,
            "seg": _rel(prog["seg"][0], ref["seg"][0]),
            "cam": max(_rel_l2(p, r) for p, r in zip(prog["cams"], ref["cams"])),
            "attn_map": max(_rel(p, r) for p, r in zip(prog["attn_last"], ref["attn_last"])),
            "par": max(_rel(p, r) for p, r in zip(prog["par"], ref["tail_par"])),
            "par_label": max(_label_gap(p, r, lut) for p, r, lut
                             in zip(prog["labels"], ref["tail_par"], ref["lut"])),
            "loss": max(losses),
            "grad": max(leaf_gaps(prog["grad"], ref["grad"], ref["grad"])),
            "update": max(leaf_gaps(prog["change"], ref["change"], ref["grad"]))}


def eval_numbers(prog: List[Dict], ref: List[Dict], patch: int,
                 with_cam: bool) -> Dict[str, float]:
    """``prog``/``ref``: per sampled batch, the program's captured outputs
    and the reference's (see ``reference/drive.py::eval_outputs``)."""
    out = {"logits": 0.0, "msc_gap": 0.0}
    if with_cam:
        out.update(cam=0.0, attn_map=0.0, par=0.0, par_label=0.0)
    for p, r in zip(prog, ref):
        sz = [t.cpu().numpy() for t in r["sizes"]]
        for j in range(len(sz[0])):
            oh, ow, h1, w1, h2, w2 = (int(s[j]) for s in sz)
            g1 = (h1 // patch, w1 // patch)
            g2 = (max(h2 // patch, 1), max(w2 // patch, 1))
            for key, (gh, gw) in (("seg_single", g1), ("seg_avg1", g1), ("seg_avg2", g2)):
                out["logits"] = max(out["logits"],
                                    _rel(p[key][j, :, :gh, :gw], r[key][j, :, :gh, :gw]))
            m = r["msc"][j, :, :oh, :ow].float()
            pred = p["pred_msc"][j, :oh, :ow].long().to(m.device)
            chosen = m.gather(0, pred.clamp(0, m.shape[0] - 1)[None])[0]
            gap = float((m.amax(0) - chosen).max()) / (float(m.abs().max()) or 1.0)
            out["msc_gap"] = max(out["msc_gap"], gap)
            if with_cam:
                v = r["valid"][j].bool()
                amap = p["attn_last"][j].to(v.device)
                out["attn_map"] = max(out["attn_map"],
                                      _rel(amap[v][:, v], r["attn_last"][j][v][:, v]))
                sc = r["tail_par"][j:j + 1, :, :oh, :ow]
                out["par"] = max(out["par"], _rel(p["par"][j:j + 1, :, :oh, :ow], sc))
                out["par_label"] = max(out["par_label"], _label_gap(
                    p["cam_labels"][j:j + 1, :oh, :ow], sc, r["lut"][j:j + 1]))
        if with_cam:
            out["cam"] = max(out["cam"], _rel_l2(p["cams"], r["cams"]))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Tuple[float, float]]]:
    """(every limited number within its limit, {name: (number, limit)});
    numbers without a limit are not compared."""
    checks = {k: (float(v), float(limits[k])) for k, v in numbers.items() if k in limits}
    ok = all(np.isfinite(v) and v <= lim for v, lim in checks.values())
    return ok, checks
