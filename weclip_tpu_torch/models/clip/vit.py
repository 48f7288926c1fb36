"""Frozen CLIP ViT-B/16 and its text encoder (port of
weclip_tpu/models/clip/vit.py).

Parameters are nested dicts of tensors with the transformer blocks stacked
on a leading axis, exactly as in the JAX package (so ``convert.py`` carries
them across unchanged).  Tokens live on a padded grid with a validity mask;
per-layer tokens and head-averaged attention maps are returned for the
pseudo-label chain.  The text encoder runs once at start-up to embed the
class prompts (models/clip/prompts.py), on the plain attention with a
causal bias.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from weclip_tpu_torch.core import precision
from weclip_tpu_torch.core.config import ClipConfig
from weclip_tpu_torch.ops.attention import MhaParams, mha_auto, mha_with_weights
from weclip_tpu_torch.ops.resize import _linear_matrix, upsample_pos_emb
from weclip_tpu_torch.parallel.mesh import Mesh, enter_model, leave_model

Params = Dict[str, Any]


def tree_map(fn, tree):
    """``fn`` on every tensor of a nested dict/list tree; the mesh a
    sharded tree carries (parallel/mesh.py::shard_model) stays as it is."""
    if isinstance(tree, Mesh):
        return tree
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
    mesh = p.get("tp")
    xin = x if mesh is None else enter_model(x, mesh)
    h = torch.matmul(xin.to(cd), p["fc_w"].to(cd).mT) + p["fc_b"].to(cd)
    h = quick_gelu(h)
    y = torch.matmul(h, p["proj_w"].to(cd).mT)
    if mesh is not None:
        y = leave_model(y, mesh)
    y = y + p["proj_b"].to(cd)
    return y.to(x.dtype)


def _mha_params(p: Params) -> MhaParams:
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
    """Pre-LN residual attention block.  Returns (x_out, head-mean attention
    (B, L, L) or None, ln_1 output).  On CUDA the attention runs the forward
    kernels (K1 with the map, K2 without), which hold no gradient;
    ``allow_kernel=False`` takes the plain, differentiable attention, and so
    does a call with an additive ``attn_bias``."""
    a = layer_norm(x, p["ln_1"]["g"], p["ln_1"]["b"])
    attn_out, attn_w = mha_auto(a, _mha_params(p), n_heads, valid=valid,
                                policy=policy, want_weights=want_attn,
                                allow_kernel=allow_kernel, attn_bias=attn_bias)
    x = x + attn_out
    x = x + mlp_forward(p["mlp"], layer_norm(x, p["ln_2"]["g"], p["ln_2"]["b"]), policy)
    return x, attn_w, a


def block_forward_from_ln1(
    p: Params,
    x_in: torch.Tensor,
    a: torch.Tensor,
    n_heads: int,
    valid: Optional[torch.Tensor] = None,
    policy: precision.Policy = precision.DEFAULT,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block forward with the ln_1 output ``a`` given: gradients w.r.t.
    ``a`` are the GradCAM tap.  On CUDA the attention is the differentiable
    kernel pair (K1 forward, K3 backward); on CPU the plain formulation
    under autograd."""
    mha = _mha_params(p)
    if a.is_cuda:
        from weclip_tpu_torch.ops.attention_kernels import mha_with_weights_fused
        attn_out, attn_w = mha_with_weights_fused(a, mha, n_heads, valid=valid,
                                                  policy=policy)
    else:
        attn_out, attn_w = mha_with_weights(a, mha, n_heads, valid=valid,
                                            policy=policy)
    x = x_in + attn_out
    x = x + mlp_forward(p["mlp"], layer_norm(x, p["ln_2"]["g"], p["ln_2"]["b"]), policy)
    return x, attn_w


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


def build_pos_emb(params: Params, gh: int, gw: int, pad_gh: Optional[int] = None,
                  pad_gw: Optional[int] = None) -> torch.Tensor:
    """The positional embedding resampled to a (gh, gw) grid, (1 + gh*gw,
    D); with ``pad_gh``/``pad_gw`` placed on that padded grid, zeros
    outside, (1 + pad_gh*pad_gw, D)."""
    pe = upsample_pos_emb(params["positional_embedding"], gh, gw)
    if pad_gh is None:
        return pe
    d = pe.shape[-1]
    grid = pe.new_zeros((pad_gh, pad_gw, d))
    grid[:gh, :gw] = pe[1:].reshape(gh, gw, d)
    return torch.cat([pe[:1], grid.reshape(pad_gh * pad_gw, d)], dim=0)


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
    """Per-layer products of the frozen 11-block forward.  Consumers slice
    the patch block as ``[1:1+P]``."""
    layer_tokens: torch.Tensor   # (11, B, L, D) policy compute dtype
    layer_attn: torch.Tensor     # (11 or 0, k, L, L) fp32
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
    """Frozen CLIP forward over blocks 0..10 with feature/attention export.

    img (B, 3, H, W) normalized; pos_emb (B or 1, L, D); valid (B, L).
    ``with_attn=False`` skips the map export (layer_attn has a zero-length
    leading axis).  ``attn_rows=k`` exports maps for the first k rows only:
    the msc-flip engine's flipped half never consumes its maps, so those
    rows run the export-free kernel (K2) and the first k the export kernel
    (K1)."""
    b = img.shape[0]
    x = patchify(img, params["conv1_w"], cfg.patch_size, policy)
    cls = params["class_embedding"].float()[None, None, :].expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + pos_emb.float()
    x = layer_norm(x, params["ln_pre"]["g"], params["ln_pre"]["b"])
    x = x.masked_fill(~valid.bool()[..., None], 0.0)
    # the residual stream runs in the compute dtype
    x = x.to(policy.compute_dtype)

    n_frozen = cfg.vision_layers - 1
    blocks = [block_params(params["blocks"], i) for i in range(n_frozen)]
    k = attn_rows if (with_attn and attn_rows is not None) else b

    if with_attn and k < b:
        x1, x2, v1, v2 = x[:k], x[k:], valid[:k], valid[k:]
        xs1, xs2, attn_l = [], [], []
        for bp in blocks:
            x1, attn_w, _ = block_forward(bp, x1, cfg.vision_heads, valid=v1,
                                          policy=policy, want_attn=True)
            x2, _, _ = block_forward(bp, x2, cfg.vision_heads, valid=v2,
                                     policy=policy, want_attn=False)
            xs1.append(x1)
            xs2.append(x2)
            attn_l.append(attn_w)
        xs = torch.cat([torch.stack(xs1), torch.stack(xs2)], dim=1)
        attns = torch.stack(attn_l)
    else:
        xs_l, attn_l = [], []
        for bp in blocks:
            x, attn_w, _ = block_forward(bp, x, cfg.vision_heads, valid=valid,
                                         policy=policy, want_attn=with_attn)
            xs_l.append(x)
            attn_l.append(attn_w)
        xs = torch.stack(xs_l)
        l = x.shape[1]
        attns = (torch.stack(attn_l) if with_attn else
                 torch.zeros((0, b, l, l), device=x.device, dtype=torch.float32))
    return VisionFeatures(xs, attns, valid)


# ---------------------------------------------------------------------------
# text encoder
# ---------------------------------------------------------------------------

def causal_bias(l: int, device=None) -> torch.Tensor:
    """Additive causal mask (1, 1, L, L): -inf above the diagonal."""
    return torch.full((l, l), float("-inf"), device=device).triu(1)[None, None]


@torch.no_grad()
def encode_text(params: Params, tokens, cfg: ClipConfig,
                policy: precision.Policy = precision.FP32) -> torch.Tensor:
    """CLIP text encoder: tokens (N, context) ids -> (N, embed_dim) fp32,
    the final-LayerNorm feature of each row's end token (its largest id)
    projected.  Runs once at start-up to embed the class prompts, so it
    defaults to fp32."""
    emb = params["token_embedding"]
    tokens = torch.as_tensor(tokens, dtype=torch.int64, device=emb.device)
    x = emb[tokens].float() + params["positional_embedding"].float()[None]
    bias = causal_bias(cfg.context_length, device=emb.device)
    for i in range(cfg.transformer_layers):
        x, _, _ = block_forward(block_params(params["blocks"], i), x,
                                cfg.transformer_heads, policy=policy,
                                want_attn=False, attn_bias=bias)
    x = layer_norm(x, params["ln_final"]["g"], params["ln_final"]["b"])
    eot = torch.argmax(tokens, dim=-1)
    x = x[torch.arange(x.shape[0], device=x.device), eot]
    return torch.matmul(x, params["text_projection"].float())


# ---------------------------------------------------------------------------
# initialization (CLIP's scheme)
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * std


def _init_block(gen: torch.Generator, width: int, n_layers: int) -> Params:
    attn_std = width ** -0.5
    proj_std = (width ** -0.5) * ((2 * n_layers) ** -0.5)
    fc_std = (2 * width) ** -0.5
    return {
        "ln_1": {"g": torch.ones(width), "b": torch.zeros(width)},
        "attn": {
            "in_w": _normal(gen, (3 * width, width), attn_std),
            "in_b": torch.zeros(3 * width),
            "out_w": _normal(gen, (width, width), proj_std),
            "out_b": torch.zeros(width),
        },
        "ln_2": {"g": torch.ones(width), "b": torch.zeros(width)},
        "mlp": {
            "fc_w": _normal(gen, (4 * width, width), fc_std),
            "fc_b": torch.zeros(4 * width),
            "proj_w": _normal(gen, (width, 4 * width), proj_std),
            "proj_b": torch.zeros(width),
        },
    }


def stack_blocks(blocks) -> Params:
    first = blocks[0]
    if isinstance(first, dict):
        return {k: stack_blocks([bl[k] for bl in blocks]) for k in first}
    return torch.stack(blocks)


def init_vision_params(gen: torch.Generator, cfg: ClipConfig,
                       device: str = "cpu") -> Params:
    """Randomly initialized vision tower at the configured width (random
    weights from ``gen``; not the JAX package's draws)."""
    w = cfg.vision_width
    scale = w ** -0.5
    g = 224 // cfg.patch_size
    p = {
        "conv1_w": _normal(gen, (w, 3, cfg.patch_size, cfg.patch_size), scale),
        "class_embedding": _normal(gen, (w,), scale),
        "positional_embedding": _normal(gen, (g * g + 1, w), scale),
        "ln_pre": {"g": torch.ones(w), "b": torch.zeros(w)},
        "blocks": stack_blocks([_init_block(gen, w, cfg.vision_layers)
                                for _ in range(cfg.vision_layers)]),
        "ln_post": {"g": torch.ones(w), "b": torch.zeros(w)},
        "proj": _normal(gen, (w, cfg.embed_dim), scale),
    }
    return tree_map(lambda t: t.to(device), p)


def init_text_params(gen: torch.Generator, cfg: ClipConfig,
                     device: str = "cpu") -> Params:
    """Randomly initialized text tower at the configured width (random
    weights from ``gen``; not the JAX package's draws)."""
    w = cfg.transformer_width
    p = {
        "token_embedding": _normal(gen, (cfg.vocab_size, w), 0.02),
        "positional_embedding": _normal(gen, (cfg.context_length, w), 0.01),
        "blocks": stack_blocks([_init_block(gen, w, cfg.transformer_layers)
                                for _ in range(cfg.transformer_layers)]),
        "ln_final": {"g": torch.ones(w), "b": torch.zeros(w)},
        "text_projection": _normal(gen, (w, cfg.embed_dim), w ** -0.5),
    }
    return tree_map(lambda t: t.to(device), p)


def init_clip_params(gen: torch.Generator, cfg: ClipConfig,
                     device: str = "cpu") -> Params:
    """Both towers and the logit scale log(1 / 0.07)."""
    return {"visual": init_vision_params(gen, cfg, device),
            "text": init_text_params(gen, cfg, device),
            "logit_scale": torch.tensor(math.log(1.0 / 0.07), device=device)}
