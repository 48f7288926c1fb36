"""High-level user API (port of weclip_tpu/api.py): load once, then segment
images, make pseudo-labels or per-class CAM heatmaps, one image or a batch
at a time.

The pipeline runs on ``device`` ("cuda" unless the caller asks for the
CPU).  Without ``weights`` the frozen CLIP and the class text embeddings
come from ``train/trainer.py::build_frozen``: the checkpoint at
``cfg.clip.pretrained_path`` with the prompts encoded by its text tower, or,
where there is none, random weights from ``seed`` and random unit text
embeddings (a development setup, with a warning).  ``weights`` hands in the
port's trees (e.g. from ``convert.py``), and ``model_path`` the trained
parameters of a checkpoint (train/checkpoint.py: the port's own or the JAX
package's Orbax ones).  ``segment(crf=True)`` refines with the exact dense
CRF of refine/crf.py on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from weclip_tpu_torch.core import precision as prec
from weclip_tpu_torch.core.config import Config
from weclip_tpu_torch.models import weclip
from weclip_tpu_torch.utils.imutils import promote_rgb


class WeCLIPPipeline:
    """Load-once, call-many inference pipeline.

    Example:
        pipe = WeCLIPPipeline(cfg)                     # on the card
        out = pipe.segment(rgb_uint8)                  # (H, W) int32 labels
        out = pipe.pseudo_label(rgb_uint8, class_ids=[11, 14])
        outs = pipe.segment_batch([rgb1, rgb2])        # one pass for both
    """

    def __init__(self, cfg: Optional[Config] = None,
                 model_path: Optional[str] = None,
                 precision_name: str = "bfloat16",
                 device: str = "cuda",
                 seed: int = 0,
                 weights: Optional[Dict] = None):
        """``weights``: ``{"params": ..., "frozen": ...}`` in the port's
        layout; default: ``build_frozen`` (the CLIP checkpoint of the
        config, else random from ``seed``) and heads initialized from
        ``seed``.
        ``model_path``: a checkpoint directory (its latest step) or one
        ``step_N`` directory, whose parameters replace the trainable ones."""
        self.cfg = cfg or Config()
        self.device = torch.device(device)
        if self.device.type == "cuda":
            prec.strict_matmul()
        self.policy = prec.make_policy(precision_name)
        if weights is None:
            from weclip_tpu_torch.train.trainer import build_frozen
            self.frozen, _, self.cfg = build_frozen(self.cfg, seed, device=self.device)
            gen = torch.Generator().manual_seed(seed)
            self.params = weclip.init_trainable_params(gen, self.cfg, self.device)
        else:
            move = lambda t: weclip.tree_to(t, self.device)
            self.params = move(weights["params"])
            self.frozen = move(weights["frozen"])
        if model_path:
            from weclip_tpu_torch.train import checkpoint
            self.params = checkpoint.restore(model_path, device=self.device)[0]
        self._evaluators: Dict = {}
        self._cam_programs: Dict = {}

    def _evaluator(self, max_ori: int, with_cam: bool, msc: bool):
        from weclip_tpu_torch.evalx.runner import Evaluator, make_prep
        # make_prep rounds the output canvas up to a multiple of 8 anyway;
        # keying on the rounded value shares one Evaluator between sizes
        max_ori = -(-max_ori // 8) * 8
        key = (max_ori, with_cam, msc)
        if key not in self._evaluators:
            prep = make_prep(self.cfg, max_ori=max_ori,
                             resize_long=self.cfg.eval.resize_long)
            pe = self.frozen["visual"]["positional_embedding"].float().cpu().numpy()
            self._evaluators[key] = Evaluator(self.cfg, prep, pe,
                                              policy=self.policy,
                                              with_cam=with_cam, msc=msc,
                                              device=str(self.device))
        return self._evaluators[key]

    def _example(self, image_rgb: np.ndarray,
                 class_ids: Optional[Sequence[int]] = None) -> Dict:
        image_rgb = promote_rgb(image_rgb)
        num_fg = self.cfg.dataset.num_classes - 1
        present = np.zeros(num_fg, bool)
        if class_ids is None:
            present[:] = True
        else:
            for c in class_ids:
                c = int(c)
                if not 0 <= c < num_fg:
                    raise ValueError(
                        f"class id {c} out of range [0, {num_fg}) — ids are "
                        f"0-based foreground classes (background is implicit)")
                present[c] = True
        oh, ow = image_rgb.shape[:2]
        return {"img_raw": image_rgb.astype(np.uint8),
                "label": np.zeros((oh, ow), np.int32),
                "present_mask": present}

    def _run(self, images: Sequence[np.ndarray], with_cam: bool, msc: bool,
             class_ids: Optional[Sequence] = None):
        if len(images) == 0:
            raise ValueError("no images")
        ids = class_ids if class_ids is not None else [None] * len(images)
        if len(ids) != len(images):
            raise ValueError(f"{len(ids)} class-id lists for {len(images)} images")
        ev = self._evaluator(max(max(im.shape[:2]) for im in images), with_cam, msc)
        built = ev.build_batch([self._example(im, c) for im, c in zip(images, ids)])
        sb1, sb2, sizes, _, presents, cls_idx, cls_active = built
        seg_single, seg_avg1, cam_labels = ev.scale1_for(cls_idx.shape[1])(
            self.params, self.frozen, sb1, presents, sizes, cls_idx, cls_active)
        seg_avg2 = (ev.scale2(self.params, self.frozen, sb2, presents, sizes)
                    if msc else seg_avg1)
        return ev, sizes, seg_avg1, seg_avg2, cam_labels

    def segment_batch(self, images: Sequence[np.ndarray],
                      msc: bool = True) -> List[np.ndarray]:
        """Predicted (H, W) int32 segmentations at the original resolution."""
        ev, sizes, seg_avg1, seg_avg2, _ = self._run(images, with_cam=False, msc=msc)
        pred = ev.msc_logits(seg_avg1, seg_avg2, sizes).argmax(dim=1)
        pred = pred.to(torch.int32).cpu().numpy()
        return [pred[i, :im.shape[0], :im.shape[1]] for i, im in enumerate(images)]

    def segment(self, image_rgb: np.ndarray, msc: bool = True,
                crf: bool = False) -> np.ndarray:
        """Predicted (H, W) int32 segmentation at the original resolution;
        ``crf`` refines the softmax of the msc logits with the exact dense
        CRF (``DenseCRF`` of ``eval.crf``, on the host) before the argmax."""
        if not crf:
            return self.segment_batch([image_rgb], msc=msc)[0]
        from weclip_tpu_torch.refine.crf import DenseCRF
        ev, sizes, seg_avg1, seg_avg2, _ = self._run([image_rgb], with_cam=False, msc=msc)
        oh, ow = image_rgb.shape[:2]
        logits = ev.msc_logits(seg_avg1, seg_avg2, sizes)[0, :, :oh, :ow].cpu().numpy()
        prob = np.exp(logits - logits.max(axis=0, keepdims=True))
        prob /= prob.sum(axis=0, keepdims=True)
        refined = DenseCRF.from_config(self.cfg.eval.crf)(image_rgb.astype(np.uint8),
                                                         prob.astype(np.float32))
        return refined.argmax(0).astype(np.int32)

    def pseudo_label_batch(self, images: Sequence[np.ndarray],
                           class_ids: Optional[Sequence] = None
                           ) -> List[np.ndarray]:
        """CAM + affinity walk + PAR pseudo labels (single scale), one
        (H, W) int32 map per image; ``class_ids`` holds one list per image
        (default: every foreground class)."""
        _, _, _, _, cam_labels = self._run(images, with_cam=True, msc=False,
                                           class_ids=class_ids)
        lab = cam_labels.to(torch.int32).cpu().numpy()
        return [lab[i, :im.shape[0], :im.shape[1]] for i, im in enumerate(images)]

    def pseudo_label(self, image_rgb: np.ndarray,
                     class_ids: Optional[Sequence[int]] = None) -> np.ndarray:
        """CAM + affinity walk + PAR pseudo label (single scale)."""
        ids = None if class_ids is None else [class_ids]
        return self.pseudo_label_batch([image_rgb], class_ids=ids)[0]

    def cam(self, image_rgb: np.ndarray, class_ids: Optional[Sequence[int]] = None,
            method: str = "grad_cam") -> np.ndarray:
        """Refined per-class CAM heatmaps: min-max normalized and refined by
        the attention random walk (cam/highres.py).  Returns
        ``(len(class_ids) or num_fg, H, W) float32`` in [0, 1], in the order
        of ``class_ids`` (every foreground class when None); ``method`` is
        one of ``cam/variants.py::METHODS``."""
        ev = self._evaluator(max(image_rgb.shape[:2]), with_cam=True, msc=False)
        key = (ev.prep.canvas_out, method)
        if key not in self._cam_programs:
            from weclip_tpu_torch.cam.highres import make_cam_program
            self._cam_programs[key] = make_cam_program(self.cfg, ev.prep, self.policy,
                                                       method=method)
        sb1, _, sizes, _, presents, _, _ = ev.build_batch([self._example(image_rgb,
                                                                         class_ids)])
        highres = self._cam_programs[key](self.frozen, sb1, presents, sizes)
        oh, ow = image_rgb.shape[:2]
        ids = (list(range(self.cfg.dataset.num_classes - 1))
               if class_ids is None else [int(c) for c in class_ids])
        return highres[0, ids, :oh, :ow].float().cpu().numpy()
