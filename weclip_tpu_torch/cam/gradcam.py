"""GradCAM on the last CLIP block (port of weclip_tpu/cam/gradcam.py).

The gradient is taken at block 11's ln_1 output; the loss is the softmax
probability of each class seed over [present fg ; all bg] (absent classes
masked to -inf before the softmax).

The JAX package linearizes once per image and vmaps the pullback over the
class seeds.  Here the ln_1 output ``a0`` is expanded over the class bucket
to (B*MC, L, D) and ONE backward runs on the sum of the seeded
probabilities: each row's probability depends on its own row only, so the
gradient of the sum is every seed's gradient at once, and on CUDA the
attention backward (K3) runs as one launch at (B*MC, H, L, Dh) instead of
MC launches of a retained graph.  The price is the block-11 forward on
B*MC rows instead of B.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from weclip_tpu_torch.core import precision
from weclip_tpu_torch.core.config import ClipConfig
from weclip_tpu_torch.models.clip import vit


class CamOutputs(NamedTuple):
    cams: torch.Tensor        # (B, MC, P) min-max normalized CAMs, padded grid
    attn_last: torch.Tensor   # (B, L, L) head-mean attention of block 11
    probs: torch.Tensor       # (B, T) masked softmax over [fg ; bg]


def _image_text_probs(params, x_out: torch.Tensor, text_features: torch.Tensor,
                      text_mask: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """ln_post -> masked mean-pool -> proj -> L2 norm -> scaled cosine ->
    masked softmax, batched: x_out (N, L, D), text_mask (N, T), valid (N, L)."""
    x = vit.layer_norm(x_out, params["ln_post"]["g"], params["ln_post"]["b"])
    pmask = valid[:, 1:].float()
    pooled = (x[:, 1:] * pmask[..., None]).sum(dim=1) / pmask.sum(dim=1, keepdim=True).clamp_min(1.0)
    feat = torch.matmul(pooled, params["proj"].float())
    feat = feat / torch.linalg.vector_norm(feat, dim=-1, keepdim=True)
    tf = text_features / torch.linalg.vector_norm(text_features, dim=-1, keepdim=True)
    logits = torch.exp(params["logit_scale"]) * torch.matmul(feat, tf.t())
    logits = logits.masked_fill(~text_mask, float("-inf"))
    return torch.softmax(logits, dim=-1)


def _minmax_valid(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Min-max normalize over valid cells of the last axis; invalid -> 0."""
    big = 3.4e38
    lo = torch.where(valid, x, torch.full_like(x, big)).amin(dim=-1, keepdim=True)
    lo = torch.where(torch.isfinite(lo) & (lo < big), lo, torch.zeros_like(lo))
    x = x - lo
    hi = torch.where(valid, x, torch.zeros_like(x)).amax(dim=-1, keepdim=True)
    x = x / (1e-7 + hi)
    return torch.where(valid, x, torch.zeros_like(x))


def acts_and_grads(
    visual_params,
    logit_scale: torch.Tensor,
    x11: torch.Tensor,              # (B, L, D) input tokens to block 11
    text_features: torch.Tensor,    # (T, E) rows [fg ; bg]
    text_mask: torch.Tensor,        # (B, T) bool: present fg + all bg
    valid: torch.Tensor,            # (B, L)
    class_idx: torch.Tensor,        # (B, MC) class ids
    cfg: ClipConfig,
    policy: precision.Policy = precision.DEFAULT,
):
    """Block 11's ln_1 output ``a0`` (B, L, D), the gradient of each class
    seed's probability at it (B, MC, L, D), block 11's head-mean attention
    (B, L, L) and the probabilities (B, T): one backward over the class
    bucket expanded onto the batch."""
    b, l, d = x11.shape
    mc = class_idx.shape[1]
    block11 = vit.block_params(visual_params["blocks"], cfg.vision_layers - 1)
    p = {"ln_post": visual_params["ln_post"], "proj": visual_params["proj"],
         "logit_scale": logit_scale}

    with torch.no_grad():
        a0 = vit.layer_norm(x11, block11["ln_1"]["g"], block11["ln_1"]["b"])
    rep = lambda t: t.repeat_interleave(mc, dim=0)
    with torch.enable_grad():
        a = rep(a0).requires_grad_(True)
        x_out, attn_w = vit.block_forward_from_ln1(block11, rep(x11), a,
                                                   cfg.vision_heads,
                                                   valid=rep(valid), policy=policy)
        probs = _image_text_probs(p, x_out, text_features, rep(text_mask), rep(valid))
        seeds = torch.nn.functional.one_hot(class_idx.reshape(-1),
                                            text_features.shape[0]).to(probs.dtype)
        (grads,) = torch.autograd.grad((probs * seeds).sum(), a)
    return (a0, grads.reshape(b, mc, l, d), attn_w.detach()[::mc],
            probs.detach()[::mc])


def gradcam_batch(
    visual_params,
    logit_scale: torch.Tensor,
    x11: torch.Tensor,              # (B, L, D) input tokens to block 11
    text_features: torch.Tensor,    # (T, E) rows [fg ; bg]
    text_mask: torch.Tensor,        # (B, T) bool: present fg + all bg
    valid: torch.Tensor,            # (B, L)
    num_fg: int,
    cfg: ClipConfig,
    policy: precision.Policy = precision.DEFAULT,
    class_idx: Optional[torch.Tensor] = None,   # (B, MC) class ids
    num_patches: Optional[int] = None,
) -> CamOutputs:
    """GradCAMs for the given foreground classes of every image.  Returns
    cams (B, MC, P) on the grid block [1:1+P]."""
    b, l, _ = x11.shape
    if class_idx is None:
        class_idx = torch.arange(num_fg, device=x11.device).expand(b, num_fg)
    a0, grads, attn_last, probs = acts_and_grads(
        visual_params, logit_scale, x11, text_features, text_mask, valid,
        class_idx, cfg, policy)

    pe = 1 + (num_patches if num_patches is not None else l - 1)
    vp = valid[:, 1:pe]
    pmask = vp.float()
    denom = pmask.sum(dim=1).clamp_min(1.0)
    weights = (grads[:, :, 1:pe] * pmask[:, None, :, None]).sum(dim=2) / denom[:, None, None]
    cams = torch.matmul(weights, a0[:, 1:pe].float().transpose(1, 2))   # (B, MC, P)
    cams = torch.relu(cams)
    cams = _minmax_valid(cams, vp.bool()[:, None, :])
    return CamOutputs(cams.detach(), attn_last, probs)


def gradcam_single(visual_params, logit_scale, x11: torch.Tensor,
                   text_features: torch.Tensor, text_mask: torch.Tensor,
                   valid: torch.Tensor, class_idx: torch.Tensor, cfg: ClipConfig,
                   policy: precision.Policy = precision.DEFAULT,
                   num_patches: Optional[int] = None):
    """GradCAM for the classes ``class_idx`` (C,) of one image: x11 (L, D),
    text_mask (T,), valid (L,).  Returns (cams (C, P), attn_last (L, L),
    probs (T,))."""
    out = gradcam_batch(visual_params, logit_scale, x11[None], text_features,
                        text_mask[None], valid[None], text_features.shape[0],
                        cfg, policy, class_idx=class_idx[None],
                        num_patches=num_patches)
    return out.cams[0], out.attn_last[0], out.probs[0]
