"""GradCAM on the last CLIP block (a frozen copy of the plain math of
weclip_tpu_torch/cam/gradcam.py).

The gradient is taken at the last block's tap (the tower's ``tap``: ln_1's
output in OpenAI's block); the loss is the softmax probability of each
class seed over [present fg ; all bg] (absent classes masked to -inf before
the softmax).  The tap, the last block and the image feature are the
tower's (``reference/towers/``); the pooling, the text side and the CAMs
are WeCLIP's.

The JAX package linearizes once per image and vmaps the pullback over the
class seeds.  Here the tap ``a0`` is expanded over the class bucket to
(B*MC, L, D) and ONE backward runs on the sum of the seeded probabilities:
each row's probability depends on its own row only, so the gradient of the
sum is every seed's gradient at once (the program runs the attention
backward, K3, as one launch at (B*MC, H, L, Dh); here it is plain
autograd).  The price is the last block's forward on B*MC rows instead of
B.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from benchmark.reference import precision
from benchmark.reference.config import ClipConfig
from benchmark.reference import vit


class CamOutputs(NamedTuple):
    cams: torch.Tensor        # (B, MC, P) min-max normalized CAMs, padded grid
    attn_last: torch.Tensor   # (B, L, L) head-mean attention of the last block
    probs: torch.Tensor       # (B, T) masked softmax over [fg ; bg]


def _image_text_probs(params, x_out: torch.Tensor, logit_scale: torch.Tensor,
                      text_features: torch.Tensor, text_mask: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """The tower's image feature (masked mean-pool over the valid patch
    tokens) -> L2 norm -> scaled cosine -> masked softmax, batched: x_out
    (N, L, D), text_mask (N, T), valid (N, L)."""
    pmask = valid[:, 1:].float()

    def pool(x):
        return ((x[:, 1:] * pmask[..., None]).sum(dim=1)
                / pmask.sum(dim=1, keepdim=True).clamp_min(1.0))

    feat = params["tower"].out(params, x_out, pool)
    feat = feat / torch.linalg.vector_norm(feat, dim=-1, keepdim=True)
    tf = text_features / torch.linalg.vector_norm(text_features, dim=-1, keepdim=True)
    logits = torch.exp(logit_scale) * precision.matmul(feat, tf.t())
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
    x11: torch.Tensor,              # (B, L, D) input tokens to the last block
    text_features: torch.Tensor,    # (T, E) rows [fg ; bg]
    text_mask: torch.Tensor,        # (B, T) bool: present fg + all bg
    valid: torch.Tensor,            # (B, L)
    class_idx: torch.Tensor,        # (B, MC) class ids
    cfg: ClipConfig,
    policy: precision.Policy = precision.DEFAULT,
    *,
    grid: Tuple[int, int],          # the token grid (rows, columns)
):
    """The last block's tap ``a0`` (B, L, D), the gradient of each class
    seed's probability at it (B, MC, L, D), the block's head-mean attention
    (B, L, L) and the probabilities (B, T): one backward over the class
    bucket expanded onto the batch."""
    b, l, d = x11.shape
    mc = class_idx.shape[1]
    tower = visual_params["tower"]
    block = vit.block_params(visual_params["blocks"], cfg.vision_layers - 1)

    with torch.no_grad():
        a0 = tower.tap(block, x11)
    rep = lambda t: t.repeat_interleave(mc, dim=0)
    with torch.enable_grad():
        a = rep(a0).requires_grad_(True)
        x_out, attn_w = tower.block_from_tap(block, rep(x11), a, cfg.vision_heads,
                                             rep(valid), grid, policy)
        probs = _image_text_probs(visual_params, x_out, logit_scale, text_features,
                                  rep(text_mask), rep(valid))
        seeds = torch.nn.functional.one_hot(class_idx.reshape(-1),
                                            text_features.shape[0]).to(probs.dtype)
        (grads,) = torch.autograd.grad((probs * seeds).sum(), a)
    return (a0, grads.reshape(b, mc, l, d), attn_w.detach()[::mc],
            probs.detach()[::mc])


def gradcam_batch(
    visual_params,
    logit_scale: torch.Tensor,
    x11: torch.Tensor,              # (B, L, D) input tokens to the last block
    text_features: torch.Tensor,    # (T, E) rows [fg ; bg]
    text_mask: torch.Tensor,        # (B, T) bool: present fg + all bg
    valid: torch.Tensor,            # (B, L)
    num_fg: int,
    cfg: ClipConfig,
    policy: precision.Policy = precision.DEFAULT,
    class_idx: Optional[torch.Tensor] = None,   # (B, MC) class ids
    num_patches: Optional[int] = None,
    *,
    grid: Tuple[int, int],          # the token grid (rows, columns)
) -> CamOutputs:
    """GradCAMs for the given foreground classes of every image.  Returns
    cams (B, MC, P) on the grid block [1:1+P]."""
    b, l, _ = x11.shape
    if class_idx is None:
        class_idx = torch.arange(num_fg, device=x11.device).expand(b, num_fg)
    a0, grads, attn_last, probs = acts_and_grads(
        visual_params, logit_scale, x11, text_features, text_mask, valid,
        class_idx, cfg, policy, grid=grid)

    pe = 1 + (num_patches if num_patches is not None else l - 1)
    vp = valid[:, 1:pe]
    pmask = vp.float()
    denom = pmask.sum(dim=1).clamp_min(1.0)
    weights = (grads[:, :, 1:pe] * pmask[:, None, :, None]).sum(dim=2) / denom[:, None, None]
    cams = precision.matmul(weights, a0[:, 1:pe].float().transpose(1, 2))   # (B, MC, P)
    cams = torch.relu(cams)
    cams = _minmax_valid(cams, vp.bool()[:, None, :])
    return CamOutputs(cams.detach(), attn_last, probs)


