"""WeCLIP model assembly (a frozen copy of the plain math of
weclip_tpu_torch/models/weclip.py): frozen CLIP
-> heads (with the ViT-CoMer branch where the config enables it) -> the
CAM -> walk -> PAR pseudo-label chain, batched over images and the class
bucket, for evaluation and for the training forward."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from benchmark.reference.gradcam import _minmax_valid, gradcam_batch
from benchmark.reference import precision
from benchmark.reference.config import Config
from benchmark.reference import heads
from benchmark.reference import vit
from benchmark.reference.comer import comer_forward, init_comer_params
from benchmark.reference.resize import resize_bilinear
from benchmark.reference import affinity as aff
from benchmark.reference.par import par_refine_auto


class Batch(NamedTuple):
    """One step's inputs (device tensors)."""
    img: torch.Tensor            # (B, 3, H, W) normalized image, padded
    pos_emb: torch.Tensor        # (B or 1, L, D) per-image positional embedding
    valid: torch.Tensor          # (B, L) token validity (CLS first)
    gh: torch.Tensor             # (B,) valid grid heights
    gw: torch.Tensor             # (B,) valid grid widths
    present_mask: torch.Tensor   # (B, C_fg) bool image-level class set


class ForwardOutputs(NamedTuple):
    seg: torch.Tensor            # (B, P, num_classes) decoder logits (grid res)
    cam_labels: torch.Tensor     # (B, H, W) int64 pseudo labels
    attn_pred: torch.Tensor      # (B, P, P) learned Gram affinity
    cams_refined: torch.Tensor   # (B, MC, P) refined CAMs (pre-PAR)


def _lut_select(lut: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """lut[b, idx[b, ...]]: (B, K) table, (B, ...) indices."""
    flat = idx.reshape(idx.shape[0], -1).long()
    return torch.gather(lut, 1, flat).reshape(idx.shape)


def head_policy(cfg: Config) -> precision.Policy:
    """The trainable heads run at their own (default fp32) precision."""
    return precision.make_policy(cfg.precision.head_dtype,
                                 cfg.precision.param_dtype,
                                 cfg.precision.softmax_dtype)


def backbone_and_heads(params: Dict[str, Any], frozen: Dict[str, Any],
                       batch: Batch, cfg: Config, policy: precision.Policy,
                       with_attn: bool = True, attn_rows: Optional[int] = None,
                       gen: Optional[torch.Generator] = None,
                       decoder_kernel: bool = False,
                       batch_rows: Optional[Tuple[int, int]] = None):
    """Frozen CLIP forward + fuse/decoder/affinity heads, plus the CoMer
    branch when ``params`` has it and the config enables it.

    The frozen ViT forward runs without gradient; the fuse head, CoMer and
    the decoder carry it wherever the caller has it enabled.  ``gen`` draws
    the fuse head's channel dropout (None: off), for ``batch_rows`` of a
    larger batch where given (heads.fuse_forward).  ``decoder_kernel`` sends
    the decoder attention to K2 on CUDA: only gradient-free callers (the
    evaluation engine) may set it.  The heads run at their own (fp32)
    policy, the CoMer branch at the backbone policy.
    Returns (feats, head_out, attn_pred, valid_p)."""
    feats = vit.vision_forward_frozen(
        frozen["visual"], batch.img, batch.pos_emb, batch.valid, cfg.clip,
        policy=policy, with_attn=with_attn, attn_rows=attn_rows)
    layer_tokens = feats.layer_tokens[:, :, 1:batch.valid.shape[1], :]
    valid_p = batch.valid[:, 1:].float()
    hp = head_policy(cfg)
    fused = heads.fuse_forward(params["head"]["fuse"], layer_tokens, gen, policy=hp,
                               batch_rows=batch_rows)
    if "comer" in params and cfg.comer.enabled:
        fused = fused + comer_forward(params["comer"], batch.img, layer_tokens,
                                      batch.valid[:, 1:], cfg.comer, policy)
    seg, dec_attn = heads.decoder_forward(params["head"]["decoder"], fused,
                                          valid_p=batch.valid[:, 1:], policy=hp,
                                          allow_kernel=decoder_kernel)
    head_out = heads.HeadOutputs(seg, fused, dec_attn)
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
    keep: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GradCAM -> attention fusion -> Sinkhorn + box-masked walk ->
    normalize, upsample, background -> PAR -> argmax/LUT.
    Returns (cam_labels (B, H, W) int64, cams_refined (B, MC, P)).
    ``keep`` (a dict, where given) receives GradCAM's ``cams``, block 11's
    head-mean map ``attn_last`` with the token validity ``valid``, the PAR
    scores ``par``, the label table ``lut`` and ``refined``; where it holds
    ``follow`` (another walk output of the same shape), also ``tail_par``:
    the PAR scores that the chain's tail makes from it."""
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
                            num_patches=batch_valid.shape[1] - 1, grid=grid_hw)
    with torch.no_grad():
        fused_attn = fuse(cam_out.attn_last)
        valid_pb = batch_valid[:, 1:].bool()
        trans = aff.sinkhorn_transition(fused_attn, valid_pb,
                                        rounds=cfg.cam.sinkhorn_iters)
        refined = aff.random_walk_cams(cam_out.cams, trans,
                                       valid_pb.reshape(b, g0, g1), gh, gw,
                                       cfg.cam.bbox_threshold)
        def tail(refined):
            """normalize, upsample, background, PAR, argmax and the bucket's
            label table: (labels, PAR scores, table)."""
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
            return _lut_select(lut, idx), par_out, lut

        labels, par_out, lut = tail(refined)
        if keep is not None:
            keep["par"], keep["lut"], keep["refined"] = par_out, lut, refined
            keep["cams"], keep["attn_last"] = cam_out.cams, cam_out.attn_last
            keep["valid"] = feats.valid
            if keep.get("follow") is not None:
                # the tail on the program's own walk output: PAR's stage alone
                keep["tail_par"] = tail(keep["follow"].to(refined.device))[1]
        return labels, refined


def pseudo_labels(frozen: Dict[str, Any], feats: vit.VisionFeatures,
                  attn_pred: torch.Tensor, batch: Batch, cfg: Config,
                  require_seg_trans: bool, out_hw: Tuple[int, int],
                  policy: precision.Policy,
                  cls_idx: Optional[torch.Tensor] = None,
                  cls_active: Optional[torch.Tensor] = None,
                  keep: Optional[dict] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pseudo-label chain at training-crop shapes.  The attention
    fusion is gated by the learned affinity once ``require_seg_trans``
    holds (past the seg-trans iteration), plain before.  Without
    ``cls_idx`` every foreground class is a bucket entry.
    Returns (cam_labels (B, H, W), cams_refined (B, MC, P))."""
    b = batch.img.shape[0]
    h, w = out_hw
    g0, g1 = h // cfg.clip.patch_size, w // cfg.clip.patch_size
    if cls_idx is None:
        num_fg = cfg.dataset.num_classes - 1
        cls_idx = torch.arange(num_fg, device=batch.img.device).expand(b, num_fg)
        cls_active = batch.present_mask.bool()
    valid_p = batch.valid[:, 1:].float()
    seg_attn = attn_pred.detach()

    def fuse(attn_last):
        if bool(require_seg_trans):
            return aff.fuse_attention_gated(feats.layer_attn, attn_last, seg_attn,
                                            cfg.cam.seg_trans_layers, valid_p)
        return aff.fuse_attention_plain(feats.layer_attn, attn_last,
                                        cfg.cam.attn_fuse_layers,
                                        num_patches=batch.valid.shape[1] - 1)

    return pseudo_label_chain(
        frozen, feats, batch.valid, batch.present_mask, batch.gh, batch.gw,
        (g0, g1), cfg, policy, cls_idx, cls_active, fuse,
        lambda grid: resize_bilinear(grid, h, w), batch.img, keep)


def forward_train(params: Dict[str, Any], frozen: Dict[str, Any], batch: Batch,
                  cfg: Config, require_seg_trans: bool,
                  gen: Optional[torch.Generator] = None,
                  policy: precision.Policy = precision.DEFAULT,
                  cls_idx: Optional[torch.Tensor] = None,
                  cls_active: Optional[torch.Tensor] = None,
                  with_pseudo: bool = True,
                  batch_rows: Optional[Tuple[int, int]] = None,
                  keep: Optional[dict] = None) -> ForwardOutputs:
    """Training forward on fixed square crops (valid all true): heads with
    gradient, pseudo labels without.  ``with_pseudo=False`` (the fully
    supervised variant) skips the attention export and the pseudo-label
    chain: the labels and refined CAMs are zeros.  ``batch_rows``: see
    ``backbone_and_heads``."""
    feats, head_out, attn_pred, _ = backbone_and_heads(
        params, frozen, batch, cfg, policy, with_attn=with_pseudo, gen=gen,
        batch_rows=batch_rows)
    h, w = batch.img.shape[-2:]
    if with_pseudo:
        cam_labels, refined = pseudo_labels(frozen, feats, attn_pred, batch, cfg,
                                            require_seg_trans, (h, w), policy,
                                            cls_idx=cls_idx, cls_active=cls_active,
                                            keep=keep)
    else:
        b, dev = batch.img.shape[0], batch.img.device
        cam_labels = torch.zeros((b, h, w), dtype=torch.int64, device=dev)
        refined = torch.zeros((b, cfg.dataset.num_classes - 1, batch.valid.shape[1] - 1),
                              dtype=torch.float32, device=dev)
    return ForwardOutputs(head_out.seg, cam_labels, attn_pred, refined)


def tree_to(tree, device) -> Any:
    """A nested dict of tensors moved to ``device``."""
    return vit.tree_map(lambda t: t.to(device), tree)


def init_trainable_params(gen: torch.Generator, cfg: Config,
                          device="cpu") -> Dict[str, Any]:
    """Fuse + decoder heads, and the CoMer branch where the config enables
    it (the trainable part; CLIP stays frozen)."""
    params = {"head": heads.init_head_params(
        gen, n_layers=cfg.clip.vision_layers - 1, in_dim=cfg.clip.vision_width,
        embed=cfg.clip.embedding_dim, dec_layers=3,
        num_classes=cfg.dataset.num_classes)}
    if cfg.comer.enabled:
        params["comer"] = init_comer_params(gen, cfg.comer,
                                            vit_width=cfg.clip.vision_width,
                                            embed=cfg.clip.embedding_dim)
    return tree_to(params, device)


def build_frozen_state(visual: Dict[str, Any], logit_scale, fg_text, bg_text,
                       device="cpu") -> Dict[str, Any]:
    """Frozen constants: CLIP vision weights + class text embeddings."""
    t = lambda x: torch.as_tensor(x, dtype=torch.float32).to(device)
    return {"visual": tree_to(visual, device),
            "logit_scale": t(logit_scale), "fg_text": t(fg_text),
            "bg_text": t(bg_text)}



