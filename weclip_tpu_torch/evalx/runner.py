"""Batch assembly and the msc-flip programs for one evaluation configuration
(port of weclip_tpu/evalx/runner.py, inference side).

Host work per image is O(canvas^2): pad the uint8 original onto a fixed
canvas and look up the positional embedding of its grid (cached on the
device per grid size).  Normalization and resizing happen on the device
(evalx/engine.py).  Host tensors are pinned and copied without blocking.
The dataset loop (``run``), its metrics and the multi-device mesh are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from weclip_tpu_torch.core import precision
from weclip_tpu_torch.core.compaction import compact_classes, pick_bucket
from weclip_tpu_torch.core.config import Config
from weclip_tpu_torch.evalx.engine import (EvalSizes, ScaleBatch,
                                           make_eval_scale1, make_eval_scale2,
                                           make_msc_logits)
from weclip_tpu_torch.models.clip.vit import grid_valid_mask, pos_emb_host


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class EvalPrep:
    """Static shapes for one evaluation configuration."""
    canvas_in1: int       # scale-1 input canvas (pixels)
    canvas_in2: int       # scale-2 input canvas (pixels)
    canvas_out: int       # original-resolution output canvas
    grid1: int
    grid2: int
    resize_long: Optional[int]


def make_prep(cfg: Config, max_ori: int, resize_long: Optional[int]) -> EvalPrep:
    patch = cfg.clip.patch_size
    base = resize_long if resize_long else max_ori
    c1 = _round_up(base, patch)
    s2 = cfg.eval.scales[1] if len(cfg.eval.scales) > 1 else 0.75
    c2 = _round_up(int(base * s2) + patch, patch)
    return EvalPrep(c1, c2, _round_up(max_ori, 8), c1 // patch, c2 // patch,
                    resize_long)


def _pe_valid_for(target_hw: Tuple[int, int], canvas: int, patch: int,
                  pe_table: np.ndarray, pe_cache: dict, device: torch.device):
    """(pe, valid, gh, gw) for a valid (h, w) region on ``canvas``; the
    positional embedding and validity mask are cached on the device per
    grid size."""
    h, w = target_hw
    gh, gw = h // patch, w // patch
    g = canvas // patch
    key = (gh, gw, g)
    cached = pe_cache.get(key)
    if cached is None:
        pe = pos_emb_host(pe_table, gh, gw, g, g)
        valid = grid_valid_mask(gh, gw, g, g)
        cached = (torch.from_numpy(pe).to(device), torch.from_numpy(valid).to(device))
        pe_cache[key] = cached
    pe, valid = cached
    return pe, valid, gh, gw


class Evaluator:
    """The msc-flip programs of one canvas configuration on one device."""

    def __init__(self, cfg: Config, prep: EvalPrep, pe_table: np.ndarray,
                 policy: precision.Policy = precision.DEFAULT,
                 with_cam: bool = True, msc: bool = True,
                 class_buckets: Tuple[int, ...] = (4, 8),
                 device: str = "cuda"):
        self.cfg = cfg
        self.prep = prep
        self.device = torch.device(device)
        if self.device.type == "cuda":
            precision.strict_matmul()
        self.pe_table = np.asarray(pe_table, np.float32)
        self.with_cam = with_cam
        self.msc = msc
        self.policy = policy
        num_fg = cfg.dataset.num_classes - 1
        self.class_buckets = tuple(b for b in class_buckets if b < num_fg) + (num_fg,)
        self._scale1_cache: dict = {}
        self.scale2 = make_eval_scale2(cfg, policy, prep=prep) if msc else None
        self.msc_logits = make_msc_logits(cfg, msc=msc, prep=prep)
        self._pe_cache: dict = {}

    def scale1_for(self, mc: int):
        if mc not in self._scale1_cache:
            self._scale1_cache[mc] = make_eval_scale1(
                self.cfg, self.policy, with_cam=self.with_cam, max_classes=mc,
                prep=self.prep)
        return self._scale1_cache[mc]

    def class_compaction(self, presents: np.ndarray):
        """(B, C_fg) present mask -> bucketed (cls_idx (B,MC), active (B,MC))."""
        mc = pick_bucket(presents, self.class_buckets)
        return compact_classes(presents, mc)

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda":
            # the caching host allocator keeps a pinned block alive until
            # its copy has completed, so a fresh block per call is safe
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def build_batch(self, examples: Sequence[dict]):
        """Examples (dicts with ``img_raw`` (H, W, 3) uint8, ``label``
        (H, W) and ``present_mask`` (C_fg,) bool) -> device tensors
        (sb1, sb2, sizes, labels, presents, cls_idx, cls_active)."""
        cfg, prep = self.cfg, self.prep
        patch = cfg.clip.patch_size
        rl = prep.resize_long
        s2 = cfg.eval.scales[1] if len(cfg.eval.scales) > 1 else 0.75
        b, co = len(examples), prep.canvas_out
        img_buf = np.zeros((b, co, co, 3), np.uint8)
        lab_buf = np.full((b, co, co), 255, np.uint8)

        cols1, cols2, size_rows, presents = [], [], [], []
        for j, ex in enumerate(examples):
            raw = ex["img_raw"]                     # (H, W, 3) uint8 RGB
            oh, ow = raw.shape[:2]
            if rl:
                ratio = rl / max(oh, ow)
                h1, w1 = int(oh * ratio), int(ow * ratio)
            else:
                h1, w1 = oh, ow
            cols1.append(_pe_valid_for((h1, w1), prep.canvas_in1, patch,
                                       self.pe_table, self._pe_cache, self.device))
            if self.msc:
                # the 0.75-scale input derives from the scale-1 size
                h2, w2 = int(h1 * s2), int(w1 * s2)
                cols2.append(_pe_valid_for((h2, w2), prep.canvas_in2, patch,
                                           self.pe_table, self._pe_cache,
                                           self.device))
            else:
                h2 = w2 = patch
            size_rows.append((oh, ow, h1, w1, h2, w2))
            img_buf[j, :oh, :ow] = raw
            lab_buf[j, :oh, :ow] = np.asarray(ex["label"], np.uint8)
            presents.append(ex["present_mask"])

        # one uint8 original-resolution tensor shared by both scales
        img_dev = self._to_device(img_buf)

        def stack_scale(cols, w_px):
            pe, valid, gh, gw = zip(*cols)
            as_dev = lambda v: self._to_device(np.asarray(v, np.int64))
            return ScaleBatch(img_dev, torch.stack(pe), torch.stack(valid),
                              as_dev(gh), as_dev(gw), as_dev(w_px))

        sb1 = stack_scale(cols1, [r[3] for r in size_rows])
        sb2 = stack_scale(cols2, [r[5] for r in size_rows]) if self.msc else sb1
        sizes = EvalSizes(*self._to_device(np.asarray(size_rows, np.int64).T).unbind(0))
        presents = np.stack(presents)
        cls_idx, cls_active = self.class_compaction(presents)
        return (sb1, sb2, sizes, self._to_device(lab_buf),
                self._to_device(presents), self._to_device(cls_idx),
                self._to_device(cls_active))
