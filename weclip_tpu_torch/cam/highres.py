"""High-resolution per-class CAMs (port of weclip_tpu/cam/highres.py).

The frozen CLIP forward at scale 1 -> a CAM method (GradCAM by default,
any of cam/variants.py) -> attention fusion, Sinkhorn and the box-masked
random walk -> min-max -> resize to the original size.  The offline
generator (cli/generate_cams.py) and ``WeCLIPPipeline.cam`` share it.
"""

from __future__ import annotations

import torch

from weclip_tpu_torch.cam import variants
from weclip_tpu_torch.cam.gradcam import _minmax_valid, gradcam_batch
from weclip_tpu_torch.evalx.engine import (_dev_ops_cam, _resize_pair,
                                           prepare_scale1_images)
from weclip_tpu_torch.models.clip import vit
from weclip_tpu_torch.refine import affinity as aff


def make_cam_program(cfg, prep, policy, method: str = "grad_cam"):
    """Returns ``fn(frozen, sb, presents, sizes) -> (B, num_fg, Co, Co)``
    refined, min-max normalized CAMs of every foreground class on the
    output canvas (slice ``[:, :, :oh, :ow]`` for each original).  ``sb``,
    ``presents`` and ``sizes`` come from ``Evaluator.build_batch`` (scale
    1); ``method`` is one of ``variants.METHODS``."""
    if method not in variants.METHODS:
        raise ValueError(f"unknown CAM method {method!r}; one of {variants.METHODS}")
    num_fg = cfg.dataset.num_classes - 1
    patch = cfg.clip.patch_size

    @torch.no_grad()
    def cams_for_batch(fz, sb, presents, sizes):
        b = sb.img.shape[0]
        g = prep.canvas_in1 // patch
        imgs1 = prepare_scale1_images(sb.img, sizes, cfg, prep.canvas_in1)
        feats = vit.vision_forward_frozen(fz["visual"], imgs1, sb.pos_emb, sb.valid,
                                          cfg.clip, policy=policy)
        text = torch.cat([fz["fg_text"], fz["bg_text"]], dim=0)
        tmask = torch.cat([presents.bool(),
                           torch.ones((b, fz["bg_text"].shape[0]), dtype=torch.bool,
                                      device=presents.device)], dim=1)
        x11 = feats.layer_tokens[-1]
        cam_out = gradcam_batch(fz["visual"], fz["logit_scale"], x11, text, tmask,
                                sb.valid, num_fg, cfg.clip, policy)
        if method == "grad_cam":
            cams = cam_out.cams
        else:
            ci = torch.arange(num_fg, device=x11.device)
            cams = torch.stack([variants.cam_single(
                method, fz["visual"], fz["logit_scale"], x11[i], text, tmask[i],
                sb.valid[i], ci, cfg.clip, policy) for i in range(b)])
        fused = aff.fuse_attention_plain(feats.layer_attn, cam_out.attn_last,
                                         cfg.cam.attn_fuse_layers)
        valid_p = sb.valid[:, 1:].bool()
        trans = aff.sinkhorn_transition(fused, valid_p, rounds=cfg.cam.sinkhorn_iters)
        refined = aff.random_walk_cams(cams, trans, valid_p.reshape(b, g, g),
                                       sb.gh, sb.gw, cfg.cam.bbox_threshold)
        normed = _minmax_valid(refined, valid_p[:, None, :])
        mh, mw = _dev_ops_cam(sizes, prep.canvas_out, prep.grid1, patch)
        return _resize_pair(normed.reshape(b, num_fg, g, g), mh, mw)

    return cams_for_batch
