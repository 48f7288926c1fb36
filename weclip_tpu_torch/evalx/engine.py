"""Batched msc-flip evaluation programs (port of weclip_tpu/evalx/engine.py).

- scale 1.0: flip-concatenated backbone + heads, and the CAM -> walk -> PAR
  pseudo-label chain on the unflipped half, with original-resolution CAM
  labels on a fixed canvas;
- scale 0.75: seg-only flip-averaged forward;
- combine: the scales fused, argmax at the original resolution and the
  three confusion histograms (single scale, msc, CAM) updated on the device;
- msc logits: the scales combined and upsampled to original resolution.

Every image size runs the same shapes: validity masks handle the token
grid and per-image interpolation matrices the resolution changes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from weclip_tpu_torch.core import precision
from weclip_tpu_torch.core.config import Config
from weclip_tpu_torch.evalx.operators import device_resize_matrix as drm
from weclip_tpu_torch.evalx.operators import device_scale_matrix as dsm
from weclip_tpu_torch.models import weclip
from weclip_tpu_torch.models.clip import vit
from weclip_tpu_torch.refine import affinity as aff


class ScaleBatch(NamedTuple):
    """Inputs for one TTA scale.  ``img`` is the original uint8 image on the
    output canvas, HWC, shared by both scales."""
    img: torch.Tensor          # (B, Co, Co, 3) uint8
    pos_emb: torch.Tensor      # (B, L, D)
    valid: torch.Tensor        # (B, L) bool
    gh: torch.Tensor           # (B,)
    gw: torch.Tensor           # (B,)
    w_px: torch.Tensor         # (B,) valid width in pixels at this scale:
    # the flip covers w_px columns (the reference flips the resized image
    # before patch extraction), not gw*patch


class EvalSizes(NamedTuple):
    """Per-image true sizes; the resize operators are built from these."""
    oh: torch.Tensor
    ow: torch.Tensor
    h1: torch.Tensor           # scale-1 input pixels
    w1: torch.Tensor
    h2: torch.Tensor           # scale-2 input pixels
    w2: torch.Tensor


def _dev_ops_cam(sizes: EvalSizes, canvas_out: int, grid1: int, patch: int):
    return (drm(sizes.h1 // patch, sizes.oh, canvas_out, grid1),
            drm(sizes.w1 // patch, sizes.ow, canvas_out, grid1))


def _dev_ops_img(sizes: EvalSizes, canvas_out: int, canvas_in1: int):
    return (drm(sizes.h1, sizes.oh, canvas_out, canvas_in1, align_corners=True),
            drm(sizes.w1, sizes.ow, canvas_out, canvas_in1, align_corners=True))


def _dev_ops_s2(sizes: EvalSizes, grid1: int, grid2: int, patch: int):
    return (drm(torch.clamp_min(sizes.h2 // patch, 1), sizes.h1 // patch, grid1, grid2),
            drm(torch.clamp_min(sizes.w2 // patch, 1), sizes.w1 // patch, grid1, grid2))


def _resize_pair(grid: torch.Tensor, mh: torch.Tensor, mw: torch.Tensor) -> torch.Tensor:
    """(B, C, Gh, Gw) x (B, Oh, Gh) x (B, Ow, Gw) -> (B, C, Oh, Ow), fp32."""
    y = torch.matmul(mh[:, None], grid)                  # (B, C, Oh, Gw)
    return torch.matmul(y, mw[:, None].transpose(-1, -2))


def prepare_scale1_images(img_u8: torch.Tensor, sizes: EvalSizes, cfg: Config,
                          canvas_in1: int) -> torch.Tensor:
    """uint8 originals -> normalized fp32 scale-1 canvases: dataset
    normalization, then bilinear resize to the resize-long target."""
    dev = img_u8.device
    mean = torch.tensor(cfg.dataset.mean, dtype=torch.float32, device=dev)[None, :, None, None]
    std = torch.tensor(cfg.dataset.std, dtype=torch.float32, device=dev)[None, :, None, None]
    canvas_out = img_u8.shape[1]
    x = (img_u8.permute(0, 3, 1, 2).float() - mean) / std
    mh = drm(sizes.oh, sizes.h1, canvas_in1, canvas_out)
    mw = drm(sizes.ow, sizes.w1, canvas_in1, canvas_out)
    return _resize_pair(x, mh, mw)


def prepare_scale2_images(imgs1: torch.Tensor, sizes: EvalSizes, scale: float,
                          canvas_in2: int) -> torch.Tensor:
    """Scale-1 canvases -> 0.75-scale canvases (scale_factor mapping)."""
    canvas_in1 = imgs1.shape[-1]
    mh = dsm(sizes.h1, sizes.h2, scale, canvas_in2, canvas_in1)
    mw = dsm(sizes.w1, sizes.w2, scale, canvas_in2, canvas_in1)
    return _resize_pair(imgs1, mh, mw)


def _flip_valid(x: torch.Tensor, w_valid: torch.Tensor, axis: int) -> torch.Tensor:
    """Horizontal flip *within* the valid region of a padded axis, per image
    (flip, then roll by w_valid - size): out[i] = x[(w - 1 - i) mod size]."""
    size = x.shape[axis]
    i = torch.arange(size, device=x.device)
    idx = torch.remainder(w_valid.long()[:, None] - 1 - i[None], size)   # (B, size)
    shape = [1] * x.dim()
    shape[0], shape[axis] = x.shape[0], size
    return torch.gather(x, axis, idx.reshape(shape).expand_as(x))


def _flip_concat(sb: ScaleBatch, imgs: torch.Tensor, present_mask: torch.Tensor):
    img_f = _flip_valid(imgs, sb.w_px, 3)
    two = lambda t: torch.cat([t, t])
    return weclip.Batch(img=torch.cat([imgs, img_f]), pos_emb=two(sb.pos_emb),
                        valid=two(sb.valid), gh=two(sb.gh), gw=two(sb.gw),
                        present_mask=two(present_mask))


def make_eval_scale1(cfg: Config, policy: precision.Policy = precision.DEFAULT,
                     with_cam: bool = True, max_classes: int = None, prep=None):
    """Returns fn: (params, frozen, sb, present, sizes, cls_idx, cls_active)
    -> (seg_single (B,K,G,G), seg_flipavg (B,K,G,G), cam_labels (B,Hc,Wc)).
    ``cls_idx`` (B, MC) holds the bucket of present class ids."""
    canvas_out, grid1 = prep.canvas_out, prep.grid1
    patch = cfg.clip.patch_size

    @torch.no_grad()
    def run(params, frozen, sb: ScaleBatch, present_mask, sizes: EvalSizes,
            cls_idx, cls_active):
        b = sb.img.shape[0]
        g = prep.canvas_in1 // patch
        imgs1 = prepare_scale1_images(sb.img, sizes, cfg, prep.canvas_in1)
        batch2 = _flip_concat(sb, imgs1, present_mask)
        feats, head_out, attn_pred, _ = weclip.backbone_and_heads(
            params, frozen, batch2, cfg, policy,
            with_attn=with_cam,       # seg-only mode skips the map export
            attn_rows=b,              # the flipped half's maps are never used
            decoder_kernel=True)
        k = cfg.dataset.num_classes
        seg = head_out.seg.reshape(2 * b, g, g, k).permute(0, 3, 1, 2)
        seg_u = seg[:b]
        seg_fl = _flip_valid(seg[b:], sb.gw, 3)
        seg_avg = (seg_u + seg_fl) / 2.0
        if not with_cam:
            cam_labels = torch.zeros((b, canvas_out, canvas_out), dtype=torch.int64,
                                     device=seg.device)
            return seg_u, seg_avg, cam_labels

        feats_u = vit.VisionFeatures(feats.layer_tokens[:, :b],
                                     feats.layer_attn[:, :b], feats.valid[:b])
        valid_p = sb.valid[:, 1:].float()

        def fuse(attn_last):
            # evaluation always gates by the learned affinity
            return aff.fuse_attention_gated(feats_u.layer_attn, attn_last,
                                            attn_pred[:b], cfg.cam.seg_trans_layers,
                                            valid_p)

        mh_cam, mw_cam = _dev_ops_cam(sizes, canvas_out, grid1, patch)
        mh_img, mw_img = _dev_ops_img(sizes, canvas_out, prep.canvas_in1)
        img_ori = _resize_pair(imgs1, mh_img, mw_img)
        cam_labels, _ = weclip.pseudo_label_chain(
            frozen, feats_u, sb.valid, present_mask, sb.gh, sb.gw, (g, g), cfg,
            policy, cls_idx, cls_active, fuse,
            lambda grid: _resize_pair(grid, mh_cam, mw_cam), img_ori)
        return seg_u, seg_avg, cam_labels

    return run


def make_eval_scale2(cfg: Config, policy: precision.Policy = precision.DEFAULT,
                     prep=None):
    """Seg-only flip-averaged forward for the second TTA scale."""
    s2 = cfg.eval.scales[1] if len(cfg.eval.scales) > 1 else 0.75

    @torch.no_grad()
    def run(params, frozen, sb: ScaleBatch, present_mask, sizes: EvalSizes):
        b = sb.img.shape[0]
        g = prep.canvas_in2 // cfg.clip.patch_size
        imgs1 = prepare_scale1_images(sb.img, sizes, cfg, prep.canvas_in1)
        imgs2 = prepare_scale2_images(imgs1, sizes, s2, prep.canvas_in2)
        batch2 = _flip_concat(sb, imgs2, present_mask)
        _, head_out, _, _ = weclip.backbone_and_heads(
            params, frozen, batch2, cfg, policy, with_attn=False,
            decoder_kernel=True)
        k = cfg.dataset.num_classes
        seg = head_out.seg.reshape(2 * b, g, g, k).permute(0, 3, 1, 2)
        return (seg[:b] + _flip_valid(seg[b:], sb.gw, 3)) / 2.0

    return run


def make_eval_combine(cfg: Config, msc: bool = True, prep=None):
    """Returns fn: (seg_single, seg_avg1, seg_avg2, cam_labels, label, sizes,
    hists) -> (pred_single, pred_msc, hists): scale fusion, the argmax of the
    single-scale and msc logits upsampled to the output canvas, and the
    (single, msc, cam) histograms updated against ``label``."""
    from weclip_tpu_torch.evalx.metrics import confusion_update
    k = cfg.dataset.num_classes
    patch = cfg.clip.patch_size

    @torch.no_grad()
    def run(seg_single, seg_avg1, seg_avg2, cam_labels, label, sizes: EvalSizes,
            hists):
        if msc:
            mh_s2, mw_s2 = _dev_ops_s2(sizes, prep.grid1, prep.grid2, patch)
            msc_seg = (seg_avg1 + _resize_pair(seg_avg2, mh_s2, mw_s2)) / 2.0
        else:
            msc_seg = seg_avg1
        mh_cam, mw_cam = _dev_ops_cam(sizes, prep.canvas_out, prep.grid1, patch)
        pred_single = _resize_pair(seg_single, mh_cam, mw_cam).argmax(dim=1)
        pred_msc = _resize_pair(msc_seg, mh_cam, mw_cam).argmax(dim=1)
        h_single, h_msc, h_cam = hists
        return pred_single, pred_msc, (
            confusion_update(h_single, label, pred_single, k),
            confusion_update(h_msc, label, pred_msc, k),
            confusion_update(h_cam, label, cam_labels, k))

    return run


def make_msc_logits(cfg: Config, msc: bool = True, prep=None):
    """Original-resolution msc logits (B, K, Co, Co)."""
    patch = cfg.clip.patch_size

    @torch.no_grad()
    def run(seg_avg1, seg_avg2, sizes: EvalSizes):
        if msc:
            mh_s2, mw_s2 = _dev_ops_s2(sizes, prep.grid1, prep.grid2, patch)
            msc_seg = (seg_avg1 + _resize_pair(seg_avg2, mh_s2, mw_s2)) / 2.0
        else:
            msc_seg = seg_avg1
        mh_cam, mw_cam = _dev_ops_cam(sizes, prep.canvas_out, prep.grid1, patch)
        return _resize_pair(msc_seg, mh_cam, mw_cam)

    return run
