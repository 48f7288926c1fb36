"""Dataset-level evaluation loop (port of weclip_tpu/evalx/runner.py).

Covers msc-flip inference (scales 1.0 and 0.75, each with its flip) and
training-time validation (original size, single scale), with streaming
confusion histograms for the single-scale, msc and CAM predictions.

Host work per image is O(canvas^2): pad the uint8 original onto a fixed
canvas and look up the positional embedding of its grid (cached on the
device per grid size).  Normalization and resizing happen on the device
(evalx/engine.py).  Host tensors are pinned and copied without blocking.
``run`` prepares the next batch on one host thread while the device works
on the current one, and pads a ragged last batch with all-ignore labels, so
the histograms are unaffected.  Dense-CRF post-processing runs either the
exact lattice on the host or the on-device mean field (refine/crf.py).  In
a ``torch.distributed`` run each data rank evaluates a strided shard and
the histograms are summed over the data group (parallel/mesh.py); the ranks
of a model group run the same batches, which keeps the collectives of the
split MLPs in step.
"""

from __future__ import annotations

import dataclasses
import concurrent.futures as cf
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from weclip_tpu_torch.core import precision
from weclip_tpu_torch.core.compaction import compact_classes, pick_bucket
from weclip_tpu_torch.core.config import Config
from weclip_tpu_torch.evalx import metrics
from weclip_tpu_torch.evalx.engine import (EvalSizes, ScaleBatch, make_eval_combine,
                                           make_eval_scale1, make_eval_scale2,
                                           make_msc_logits)
from weclip_tpu_torch.models.clip.vit import grid_valid_mask, pos_emb_host
from weclip_tpu_torch.parallel import mesh as meshlib


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
        self.combine = make_eval_combine(cfg, msc=msc, prep=prep)
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

    def run(self, params, frozen, dataset, max_images: Optional[int] = None,
            progress: bool = False, crf: bool = False, crf_impl: str = "native",
            crf_stride: int = 4, save_dir: Optional[str] = None,
            logits_dir: Optional[str] = None, return_hists: bool = False,
            process_index: Optional[int] = None,
            process_count: Optional[int] = None) -> Dict[str, Dict]:
        """Scores of the dataset's first ``max_images`` examples (each a
        dict as ``build_batch`` reads it, plus ``name`` where predictions or
        logits are saved): ``{"seg", "msc_seg"}``, with the CAM chain
        ``"cam"``, and with ``crf`` ``"crf_seg"``, each ``metrics.scores`` of
        its histogram.

        ``crf``: the msc logits' softmax refined by a dense CRF, then argmax.
        ``crf_impl`` ``"native"`` runs the exact permutohedral lattice on the
        host per image (float64 softmax of the cropped logits);
        ``"jax"`` (the JAX package's name) runs ``refine/crf.py::
        mean_field_crf`` on the device over the edge-padded output canvas,
        its bilateral kernel on the stride-``crf_stride`` grid of n_sub
        points: up to 4096 points the dense kernel, batched; up to 16384 the
        dense kernel one image at a time (one 1 GiB matrix live); above, the
        window sum of K7, batched.

        ``save_dir``: the msc prediction of each image as a PNG of class ids
        under ``prediction/`` and in the VOC palette under
        ``prediction_cmap/``.  ``logits_dir``: ``logit/<name>.npy`` per image,
        a dict of the scale-1 grid logits cropped to the image's own grid
        (``segs``, (1, K, h1 / patch, w1 / patch)) and the msc logits at the
        original size (``msc_segs``, (1, K, H, W)).  ``return_hists`` adds
        the int64 histograms under ``"hists"``.

        ``process_index``/``process_count``, given together, evaluate the
        strided shard ``range(n)[process_index::process_count]`` and return
        that shard's scores and histograms (the caller sums them).  Without
        them, in a ``torch.distributed`` world of more than one rank, each
        data rank evaluates ``range(n)[data_rank::data]`` of the mesh that
        ``frozen`` is sharded over (``shard_model``; without one, the world
        is the data axis) and the histograms are summed over the data group
        by one all-reduce, so every rank returns the global scores; every
        rank must make this call."""
        if crf and crf_impl not in ("native", "jax"):
            raise ValueError(f"crf_impl {crf_impl!r}: expected 'native' or 'jax'")
        if (process_index is None) != (process_count is None):
            raise ValueError("pass both process_index and process_count or neither")
        auto_reduce = process_index is None
        group = None
        if auto_reduce:
            pi, pc, group = meshlib.data_shard(frozen)
        else:
            pi, pc = process_index, process_count
        if not 0 <= pi < pc:
            raise ValueError(f"process_index {pi} outside [0, {pc})")
        k = self.cfg.dataset.num_classes
        patch = self.cfg.clip.patch_size
        hists = tuple(metrics.zero_hist(k, self.device) for _ in range(3))
        h_crf = np.zeros((k, k), np.int64)
        bsz = self.cfg.eval.batch_images
        n = len(dataset) if max_images is None else min(len(dataset), max_images)
        my_idx = list(range(n))[pi::pc]
        starts = list(range(0, len(my_idx), bsz))

        def prepare(s):
            examples = [dataset[i] for i in my_idx[s:s + bsz]]
            n_real = len(examples)
            while len(examples) < bsz:                    # ragged tail: pad
                pad = dict(examples[-1])
                pad["label"] = np.full_like(pad["label"], 255)
                examples.append(pad)
            return examples, n_real, self.build_batch(examples)

        if save_dir is not None:
            for sub in ("prediction", "prediction_cmap"):
                os.makedirs(os.path.join(save_dir, sub), exist_ok=True)
        if logits_dir is not None:
            os.makedirs(os.path.join(logits_dir, "logit"), exist_ok=True)
        it = range(len(starts))
        if progress:
            it = _progress(it)
        # one host thread builds batch i + 1 while the device runs batch i
        with cf.ThreadPoolExecutor(max_workers=1) as pool:
            pending = pool.submit(prepare, starts[0]) if starts else None
            for i in it:
                examples, n_real, built = pending.result()
                if i + 1 < len(starts):
                    pending = pool.submit(prepare, starts[i + 1])
                sb1, sb2, sizes, labels, presents, cls_idx, cls_active = built
                seg_single, seg_avg1, cam_labels = self.scale1_for(cls_idx.shape[1])(
                    params, frozen, sb1, presents, sizes, cls_idx, cls_active)
                seg_avg2 = (self.scale2(params, frozen, sb2, presents, sizes)
                            if self.msc else seg_avg1)
                _, pred_msc, hists = self.combine(seg_single, seg_avg1, seg_avg2,
                                                  cam_labels, labels, sizes, hists)
                if save_dir is not None:
                    _save_predictions(save_dir, examples[:n_real], pred_msc)
                if logits_dir is not None or crf:
                    msc_logits = self.msc_logits(seg_avg1, seg_avg2, sizes)
                if logits_dir is not None:
                    _save_logits(logits_dir, examples[:n_real], seg_single, msc_logits,
                                 sizes, patch)
                if crf:
                    crf_fn = self._crf_jax if crf_impl == "jax" else self._crf_native
                    preds = crf_fn(msc_logits[:n_real], examples[:n_real], crf_stride)
                    for ex, pred in zip(examples, preds):
                        h_crf += _bincount_hist(ex["label"], pred, k)
        h_single, h_msc, h_cam = (h.cpu() for h in hists)
        if auto_reduce and pc > 1:
            # the global histograms on every rank, in one collective
            summed = meshlib.psum(torch.stack([h_single, h_msc, h_cam,
                                               torch.from_numpy(h_crf)]), group)
            h_single, h_msc, h_cam, h_crf = summed.unbind(0)
        h_single, h_msc, h_cam, h_crf = (np.asarray(h) for h in
                                         (h_single, h_msc, h_cam, h_crf))
        out = {"seg": metrics.scores(h_single), "msc_seg": metrics.scores(h_msc)}
        if self.with_cam:
            # without the CAM chain the cam histogram counts all-zero labels
            out["cam"] = metrics.scores(h_cam)
        if crf:
            out["crf_seg"] = metrics.scores(h_crf)
        if return_hists:
            out["hists"] = {"seg": h_single, "msc_seg": h_msc}
            if self.with_cam:
                out["hists"]["cam"] = h_cam
            if crf:
                out["hists"]["crf_seg"] = h_crf
        return out

    def _crf_jax(self, logits: torch.Tensor, examples, stride: int) -> List[np.ndarray]:
        """Per image the (H, W) argmax of ``mean_field_crf`` over the
        softmax of its canvas logits (B, K, Co, Co), the image edge-padded
        onto the canvas."""
        from weclip_tpu_torch.refine.crf import mean_field_crf
        co = self.prep.canvas_out
        imgs = np.stack([np.pad(_img_raw(ex), [(0, co - ex["img_raw"].shape[0]),
                                               (0, co - ex["img_raw"].shape[1]), (0, 0)],
                                mode="edge").transpose(2, 0, 1) for ex in examples])
        imgs = self._to_device(imgs.astype(np.float32))
        probs = torch.softmax(logits, dim=1)
        crf_cfg = self.cfg.eval.crf
        n_sub = (co // stride) ** 2
        if 4096 < n_sub <= 16384:
            # the dense kernel one image at a time: one (N, N) matrix live
            ref = torch.stack([mean_field_crf(p, im, crf_cfg, bi_stride=stride,
                                              dense_max_points=16384)
                               for p, im in zip(probs, imgs)])
        else:        # small grids: the dense kernel; large: the window sum
            ref = mean_field_crf(probs, imgs, crf_cfg, bi_stride=stride)
        pred = ref.argmax(dim=1).cpu().numpy()
        return [pred[j, :ex["label"].shape[0], :ex["label"].shape[1]]
                for j, ex in enumerate(examples)]

    def _crf_native(self, logits: torch.Tensor, examples, stride: int) -> List[np.ndarray]:
        """Per image the (H, W) argmax of ``DenseCRF`` (the exact lattice,
        on the host) over the float64 softmax of its cropped logits;
        ``stride`` is not read."""
        from weclip_tpu_torch.refine.crf import DenseCRF
        post = DenseCRF.from_config(self.cfg.eval.crf)
        logits = logits.cpu().numpy()
        preds = []
        for lg, ex in zip(logits, examples):
            oh, ow = ex["label"].shape
            lg = lg[:, :oh, :ow].astype(np.float64)
            lg -= lg.max(axis=0, keepdims=True)
            prob = np.exp(lg)
            prob /= prob.sum(axis=0, keepdims=True)
            preds.append(post(_img_raw(ex), prob.astype(np.float32)).argmax(0))
        return preds


def _img_raw(ex) -> np.ndarray:
    raw = ex.get("img_raw")
    if raw is None:
        raise ValueError("CRF needs 'img_raw' (HWC uint8) in dataset examples")
    return raw


def _bincount_hist(label: np.ndarray, pred: np.ndarray, k: int) -> np.ndarray:
    """(k, k) int64 counts of (label, pred) over the pixels with
    0 <= label < k."""
    m = (label >= 0) & (label < k)
    return np.bincount(k * label[m].astype(np.int64) + pred[m],
                       minlength=k * k).reshape(k, k)


def _progress(it):
    """A tqdm bar over ``it`` where tqdm imports, else one log line a batch."""
    try:
        from tqdm import tqdm
    except ImportError:
        log = logging.getLogger("weclip_tpu_torch")

        def logged():
            for i in it:
                yield i
                log.info("evaluated batch %d / %d", i + 1, len(it))

        return logged()
    return tqdm(it, ncols=100)


def _save_predictions(save_dir: str, examples, pred: torch.Tensor) -> None:
    from weclip_tpu_torch.utils.imutils import save_prediction
    pm = pred.cpu().numpy()
    for j, ex in enumerate(examples):
        oh, ow = ex["label"].shape
        name = str(ex["name"]) + ".png"
        save_prediction(os.path.join(save_dir, "prediction", name), pm[j, :oh, :ow])
        save_prediction(os.path.join(save_dir, "prediction_cmap", name),
                        pm[j, :oh, :ow], cmap=True)


def _save_logits(logits_dir: str, examples, seg_single: torch.Tensor,
                 msc_logits: torch.Tensor, sizes: EvalSizes, patch: int) -> None:
    sg, lg = seg_single.cpu().numpy(), msc_logits.cpu().numpy()
    h1s, w1s = sizes.h1.cpu().numpy(), sizes.w1.cpu().numpy()
    for j, ex in enumerate(examples):
        oh, ow = ex["label"].shape
        gh1, gw1 = int(h1s[j]) // patch, int(w1s[j]) // patch
        np.save(os.path.join(logits_dir, "logit", str(ex["name"]) + ".npy"),
                {"segs": sg[j, :, :gh1, :gw1][None], "msc_segs": lg[j, :, :oh, :ow][None]})
