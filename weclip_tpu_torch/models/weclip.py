"""WeCLIP model assembly, inference side (port of weclip_tpu/models/weclip.py):
frozen CLIP -> heads -> the CAM -> walk -> PAR pseudo-label chain, batched
over images and the class bucket.  Training (losses, the gated train
fusion, dropout) is not ported yet."""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from weclip_tpu_torch.cam.gradcam import _minmax_valid, gradcam_batch
from weclip_tpu_torch.core import precision
from weclip_tpu_torch.core.config import Config
from weclip_tpu_torch.models import heads
from weclip_tpu_torch.models.clip import vit
from weclip_tpu_torch.refine import affinity as aff
from weclip_tpu_torch.refine.par import par_refine_auto


class Batch(NamedTuple):
    """One step's inputs (device tensors)."""
    img: torch.Tensor            # (B, 3, H, W) normalized image, padded
    pos_emb: torch.Tensor        # (B or 1, L, D) per-image positional embedding
    valid: torch.Tensor          # (B, L) token validity (CLS first)
    gh: torch.Tensor             # (B,) valid grid heights
    gw: torch.Tensor             # (B,) valid grid widths
    present_mask: torch.Tensor   # (B, C_fg) bool image-level class set


def _lut_select(lut: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """lut[b, idx[b, ...]]: (B, K) table, (B, ...) indices."""
    flat = idx.reshape(idx.shape[0], -1).long()
    return torch.gather(lut, 1, flat).reshape(idx.shape)


def head_policy(cfg: Config) -> precision.Policy:
    """The trainable heads run at their own (default fp32) precision."""
    return precision.make_policy(cfg.precision.head_dtype,
                                 cfg.precision.param_dtype,
                                 cfg.precision.softmax_dtype)


@torch.no_grad()
def backbone_and_heads(params: Dict[str, Any], frozen: Dict[str, Any],
                       batch: Batch, cfg: Config, policy: precision.Policy,
                       with_attn: bool = True, attn_rows: int = None):
    """Frozen CLIP forward + fuse/decoder/affinity heads.
    Returns (feats, head_out, attn_pred, valid_p)."""
    feats = vit.vision_forward_frozen(
        frozen["visual"], batch.img, batch.pos_emb, batch.valid, cfg.clip,
        policy=policy, with_attn=with_attn, attn_rows=attn_rows)
    layer_tokens = feats.layer_tokens[:, :, 1:batch.valid.shape[1], :]
    valid_p = batch.valid[:, 1:].float()
    head_out = heads.head_forward(params["head"], layer_tokens,
                                  valid_p=batch.valid[:, 1:],
                                  policy=head_policy(cfg))
    attn_pred = aff.gram_affinity(head_out.fused, valid_p)
    return feats, head_out, attn_pred, valid_p


def pseudo_label_chain(
    frozen: Dict[str, Any],
    feats: vit.VisionFeatures,
    batch_valid: torch.Tensor,         # (B, L) token validity (CLS first)
    present_mask: torch.Tensor,        # (B, C_fg)
    gh: torch.Tensor, gw: torch.Tensor,  # (B,) true grid extents
    grid_hw: Tuple[int, int],          # padded grid (g0, g1)
    cfg: Config,
    policy: precision.Policy,
    cls_idx: torch.Tensor,             # (B, MC) compacted class ids
    cls_active: torch.Tensor,          # (B, MC) validity
    fuse,                              # fn(attn_last) -> fused (B, P, P)
    upsample,                          # fn((B, MC, g0, g1)) -> (B, MC, H, W)
    imgs: torch.Tensor,                # (B, 3, H, W) PAR guidance pixels
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GradCAM -> attention fusion -> Sinkhorn + box-masked walk ->
    normalize, upsample, background -> PAR -> argmax/LUT.
    Returns (cam_labels (B, H, W) int64, cams_refined (B, MC, P))."""
    b = batch_valid.shape[0]
    g0, g1 = grid_hw
    num_fg = cfg.dataset.num_classes - 1
    num_bg = frozen["bg_text"].shape[0]
    mc = cls_idx.shape[1]

    text_features = torch.cat([frozen["fg_text"], frozen["bg_text"]], dim=0)
    text_mask = torch.cat([present_mask.bool(),
                           torch.ones((b, num_bg), dtype=torch.bool,
                                      device=present_mask.device)], dim=1)
    cam_out = gradcam_batch(frozen["visual"], frozen["logit_scale"],
                            feats.layer_tokens[-1], text_features, text_mask,
                            feats.valid, num_fg, cfg.clip, policy,
                            class_idx=cls_idx,
                            num_patches=batch_valid.shape[1] - 1)
    with torch.no_grad():
        fused_attn = fuse(cam_out.attn_last)
        valid_pb = batch_valid[:, 1:].bool()
        trans = aff.sinkhorn_transition(fused_attn, valid_pb,
                                        rounds=cfg.cam.sinkhorn_iters)
        refined = aff.random_walk_cams(cam_out.cams, trans,
                                       valid_pb.reshape(b, g0, g1), gh, gw,
                                       cfg.cam.bbox_threshold)
        normed = _minmax_valid(refined, valid_pb[:, None, :])
        cam_hw = upsample(normed.reshape(b, mc, g0, g1))

        active = cls_active.bool()[:, :, None, None]
        fg_scores = torch.where(active, cam_hw, torch.full_like(cam_hw, -1.0))
        max_present = torch.where(active, cam_hw, torch.zeros_like(cam_hw)).amax(
            dim=1, keepdim=True)
        bg_score = torch.pow(1.0 - max_present, cfg.cam.bg_exponent)
        stack = torch.cat([bg_score, fg_scores], dim=1)       # (B, 1+MC, H, W)

        par_out = par_refine_auto(imgs, stack, cfg.par)
        idx = torch.argmax(par_out, dim=1)
        lut = torch.cat([torch.zeros((b, 1), dtype=torch.int64, device=idx.device),
                         cls_idx.long() + 1], dim=1)
        return _lut_select(lut, idx), refined


def tree_to(tree, device) -> Any:
    """A nested dict of tensors moved to ``device``."""
    return vit.tree_map(lambda t: t.to(device), tree)


def init_trainable_params(gen: torch.Generator, cfg: Config,
                          device="cpu") -> Dict[str, Any]:
    """Fuse + decoder heads (the trainable part)."""
    head = heads.init_head_params(
        gen, n_layers=cfg.clip.vision_layers - 1, in_dim=cfg.clip.vision_width,
        embed=cfg.clip.embedding_dim, dec_layers=3,
        num_classes=cfg.dataset.num_classes)
    return {"head": tree_to(head, device)}


def build_frozen_state(visual: Dict[str, Any], logit_scale, fg_text, bg_text,
                       device="cpu") -> Dict[str, Any]:
    """Frozen constants: CLIP vision weights + class text embeddings."""
    t = lambda x: torch.as_tensor(x, dtype=torch.float32).to(device)
    return {"visual": tree_to(visual, device),
            "logit_scale": t(logit_scale), "fg_text": t(fg_text),
            "bg_text": t(bg_text)}


# background prompt-table sizes (weclip_tpu/models/clip/prompts.py)
NUM_BG = {"voc": 25, "coco": 23}


def random_frozen_state(cfg: Config, seed: int = 0, device="cpu"):
    """Randomly initialized frozen state at the configured width: CLIP
    vision weights and unit-norm random class text embeddings (the JAX
    package's dev branch without a checkpoint).  Made on the CPU from a
    seeded generator, then moved."""
    gen = torch.Generator().manual_seed(seed)
    visual = vit.init_vision_params(gen, cfg.clip)
    num_fg = cfg.dataset.num_classes - 1
    fg = torch.randn((num_fg, cfg.clip.embed_dim), generator=gen)
    bg = torch.randn((NUM_BG[cfg.dataset.name], cfg.clip.embed_dim), generator=gen)
    fg = fg / fg.norm(dim=-1, keepdim=True)
    bg = bg / bg.norm(dim=-1, keepdim=True)
    return build_frozen_state(visual, math.log(1.0 / 0.07), fg, bg, device)
