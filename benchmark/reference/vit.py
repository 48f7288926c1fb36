"""The frozen CLIP image tower's shared loop, and the primitives and the
pre-LN block that the towers and WeCLIP's decoder share (a frozen copy of
the plain math of weclip_tpu_torch/models/clip/vit.py).

Parameters are nested dicts of tensors with the transformer blocks stacked
on a leading axis, exactly as in the JAX package.  What a tower does before,
inside and after its blocks is its own module's (``reference/towers/``);
the frozen forward here runs it over a padded grid with a validity mask and
returns the per-layer tokens and head-averaged attention maps that the
pseudo-label chain reads.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import precision
from benchmark.reference.config import ClipConfig
from benchmark.reference.attention import MhaParams, mha_auto
from benchmark.reference.resize import _linear_matrix

Params = Dict[str, Any]


def tree_map(fn, tree):
    """``fn`` on every tensor of a nested dict/list tree; the mesh a
    sharded tree carries (parallel/mesh.py::shard_model) stays as it is."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def block_params(blocks: Params, i: int) -> Params:
    """Block ``i`` of a stacked block tree."""
    return tree_map(lambda a: a[i], blocks)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """fp32 LayerNorm with the population variance, cast back to x's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), g.float(), b.float(), eps)
    return y.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def mlp_forward(p: Params, x: torch.Tensor, policy: precision.Policy) -> torch.Tensor:
    """fc -> QuickGELU -> proj; products and activations in the compute
    dtype (fp32 accumulation), biases added in the compute dtype.

    A block split by ``parallel/mesh.py::shard_model`` (``p["tp"]``, its
    mesh) holds this rank's hidden slice: its partial projection, in the
    compute dtype, is summed over the model group, and ``proj_b`` is added
    once, after the sum.  The decision is the block's own: the text
    encoder and the heads share this function and are never split."""
    cd = policy.compute_dtype
    h = precision.matmul(x.to(cd), p["fc_w"].to(cd).mT) + p["fc_b"].to(cd)
    h = quick_gelu(h)
    y = precision.matmul(h, p["proj_w"].to(cd).mT)
    y = y + p["proj_b"].to(cd)
    return y.to(x.dtype)


def mha_params(p: Params) -> MhaParams:
    a = p["attn"]
    return MhaParams(a["in_w"], a["in_b"], a["out_w"], a["out_b"])


def block_forward(
    p: Params,
    x: torch.Tensor,
    n_heads: int,
    valid: Optional[torch.Tensor] = None,
    policy: precision.Policy = precision.DEFAULT,
    want_attn: bool = True,
    allow_kernel: bool = True,
    attn_bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Pre-LN residual attention block (WeCLIP's decoder block, and OpenAI's
    CLIP block).  Returns (x_out, head-mean attention (B, L, L) or None,
    ln_1 output).  The attention is the plain,
    differentiable formulation whatever ``allow_kernel`` says."""
    a = layer_norm(x, p["ln_1"]["g"], p["ln_1"]["b"])
    attn_out, attn_w = mha_auto(a, mha_params(p), n_heads, valid=valid,
                                policy=policy, want_weights=want_attn,
                                allow_kernel=allow_kernel, attn_bias=attn_bias)
    x = x + attn_out
    x = x + mlp_forward(p["mlp"], layer_norm(x, p["ln_2"]["g"], p["ln_2"]["b"]), policy)
    return x, attn_w, a


# ---------------------------------------------------------------------------
# patchify + embeddings
# ---------------------------------------------------------------------------

def patchify(img: torch.Tensor, conv_w: torch.Tensor, patch: int,
             policy: precision.Policy) -> torch.Tensor:
    """16x16/stride-16 patch embedding as unfold + matmul.
    img: (B, 3, H, W) with 16 | H, W.  Returns (B, gh*gw, width) fp32."""
    b, c, h, w = img.shape
    gh, gw = h // patch, w // patch
    x = img.reshape(b, c, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, gh * gw, c * patch * patch)
    wmat = conv_w.reshape(conv_w.shape[0], -1)
    return precision.matmul_f32(x, wmat.t(), policy.compute_dtype)


def pos_emb_host(pos_emb: np.ndarray, gh: int, gw: int,
                 pad_gh: int, pad_gw: int) -> np.ndarray:
    """Host (numpy) positional embedding for a (gh, gw) valid region on a
    (pad_gh, pad_gw) padded grid: (1 + pad_gh*pad_gw, D)."""
    n = pos_emb.shape[0] - 1
    g = int(round(n ** 0.5))
    d = pos_emb.shape[-1]
    grid = pos_emb[1:].reshape(g, g, d).astype(np.float32)
    mh = _linear_matrix(g, gh, False)
    mw = _linear_matrix(g, gw, False)
    grid = np.einsum("oh,hwd->owd", mh, grid)
    grid = np.einsum("pw,owd->opd", mw, grid)
    out = np.zeros((pad_gh, pad_gw, d), np.float32)
    out[:gh, :gw] = grid
    return np.concatenate([pos_emb[:1].astype(np.float32),
                           out.reshape(pad_gh * pad_gw, d)], axis=0)


def grid_valid_mask(gh: int, gw: int, pad_gh: int, pad_gw: int) -> np.ndarray:
    """(1+G*G,) token-validity mask for a (gh, gw) valid region, CLS first."""
    grid = np.zeros((pad_gh, pad_gw), bool)
    grid[:gh, :gw] = True
    return np.concatenate([np.ones((1,), bool), grid.reshape(-1)])


# ---------------------------------------------------------------------------
# frozen vision forward
# ---------------------------------------------------------------------------

class VisionFeatures(NamedTuple):
    """Per-layer products of the frozen forward (all blocks but the last:
    N of them).  Consumers slice the patch block as ``[1:1+P]``."""
    layer_tokens: torch.Tensor   # (N, B, L, D) policy compute dtype
    layer_attn: torch.Tensor     # (N or 0, k, L, L) fp32
    valid: torch.Tensor          # (B, L) bool


@torch.no_grad()
def vision_forward_frozen(
    params: Params,
    img: torch.Tensor,
    pos_emb: torch.Tensor,
    valid: torch.Tensor,
    cfg: ClipConfig,
    policy: precision.Policy = precision.DEFAULT,
    with_attn: bool = True,
    attn_rows: Optional[int] = None,
) -> VisionFeatures:
    """Frozen CLIP forward over all blocks but the last, with feature and
    attention export, through the tower ``params["tower"]`` (its module of
    ``reference/towers/``).

    img (B, 3, H, W) normalized; pos_emb (B or 1, L, D); valid (B, L).
    ``with_attn=False`` skips the map export (layer_attn has a zero-length
    leading axis).  ``attn_rows=k`` exports maps for the first k rows only:
    the msc-flip engine's flipped half never consumes its maps, so those
    rows run the export-free kernel (K2) and the first k the export kernel
    (K1)."""
    tower = params["tower"]
    b = img.shape[0]
    grid = (img.shape[-2] // cfg.patch_size, img.shape[-1] // cfg.patch_size)
    x = tower.embed(params, img, pos_emb, valid, grid, cfg, policy)
    # the residual stream runs in the compute dtype
    x = x.to(policy.compute_dtype)

    n_frozen = cfg.vision_layers - 1
    blocks = [block_params(params["blocks"], i) for i in range(n_frozen)]
    k = attn_rows if (with_attn and attn_rows is not None) else b

    if with_attn and k < b:
        x1, x2, v1, v2 = x[:k], x[k:], valid[:k], valid[k:]
        xs1, xs2, attn_l = [], [], []
        for bp in blocks:
            x1, attn_w = tower.block_forward(bp, x1, cfg.vision_heads, v1, grid, policy,
                                             True)
            x2, _ = tower.block_forward(bp, x2, cfg.vision_heads, v2, grid, policy, False)
            xs1.append(x1)
            xs2.append(x2)
            attn_l.append(attn_w)
        xs = torch.cat([torch.stack(xs1), torch.stack(xs2)], dim=1)
        attns = torch.stack(attn_l)
    else:
        xs_l, attn_l = [], []
        for bp in blocks:
            x, attn_w = tower.block_forward(bp, x, cfg.vision_heads, valid, grid, policy,
                                            with_attn)
            xs_l.append(x)
            attn_l.append(attn_w)
        xs = torch.stack(xs_l)
        l = x.shape[1]
        attns = (torch.stack(attn_l) if with_attn else
                 torch.zeros((0, b, l, l), device=x.device, dtype=torch.float32))
    return VisionFeatures(xs, attns, valid)


def stack_blocks(blocks) -> Params:
    first = blocks[0]
    if isinstance(first, dict):
        return {k: stack_blocks([bl[k] for bl in blocks]) for k in first}
    return torch.stack(blocks)
