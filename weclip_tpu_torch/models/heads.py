"""Trainable heads: per-layer MLP fusion + transformer decoder + class logits
(port of weclip_tpu/models/heads.py).

The 11 per-layer MLPs are stacked on a leading axis and applied in one
batched product, followed by channel dropout drawn from an explicit
generator; the decoder blocks reuse the ViT block with the masked
attention.  Gradient-free callers (evaluation) run the decoder attention
through the export-free forward kernel (K2, Dh=32) on CUDA and skip its
per-layer maps, which no consumer reads; training takes the plain,
differentiable attention and returns the maps, as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from weclip_tpu_torch.core import precision
from weclip_tpu_torch.models.clip import vit

Params = Dict[str, Any]


class HeadOutputs(NamedTuple):
    seg: torch.Tensor          # (B, P, num_classes) logits
    fused: torch.Tensor        # (B, P, embed) fused features
    dec_attn: torch.Tensor     # (layers, B, P, P) decoder maps, or (0, ...)


# ---------------------------------------------------------------------------
# init (torch default schemes)
# ---------------------------------------------------------------------------

def _linear_init(gen: torch.Generator, out_dim: int, in_dim: int):
    """nn.Linear / 1x1 Conv2d default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(in_dim)
    w = (torch.rand((out_dim, in_dim), generator=gen) * 2 - 1) * bound
    b = (torch.rand((out_dim,), generator=gen) * 2 - 1) * bound
    return w, b


def _xavier_uniform(gen: torch.Generator, shape):
    a = math.sqrt(6.0 / (shape[0] + shape[1]))
    return (torch.rand(shape, generator=gen) * 2 - 1) * a


def init_fuse_params(gen: torch.Generator, n_layers: int, in_dim: int,
                     embed: int) -> Params:
    w1s, b1s, w2s, b2s = [], [], [], []
    for _ in range(n_layers):
        w, b = _linear_init(gen, embed, in_dim)
        w1s.append(w)
        b1s.append(b)
        w, b = _linear_init(gen, embed, embed)
        w2s.append(w)
        b2s.append(b)
    fw, fb = _linear_init(gen, embed, embed * n_layers)
    return {
        "proj1_w": torch.stack(w1s), "proj1_b": torch.stack(b1s),
        "proj2_w": torch.stack(w2s), "proj2_b": torch.stack(b2s),
        "fuse_w": fw, "fuse_b": fb,
    }


def _init_dec_block(gen: torch.Generator, width: int) -> Params:
    in_w = _xavier_uniform(gen, (3 * width, width))
    out_w, _ = _linear_init(gen, width, width)
    fc_w, fc_b = _linear_init(gen, 4 * width, width)
    pj_w, pj_b = _linear_init(gen, width, 4 * width)
    return {
        "ln_1": {"g": torch.ones(width), "b": torch.zeros(width)},
        "attn": {"in_w": in_w, "in_b": torch.zeros(3 * width),
                 "out_w": out_w, "out_b": torch.zeros(width)},
        "ln_2": {"g": torch.ones(width), "b": torch.zeros(width)},
        "mlp": {"fc_w": fc_w, "fc_b": fc_b, "proj_w": pj_w, "proj_b": pj_b},
    }


def init_decoder_params(gen: torch.Generator, width: int, layers: int,
                        num_classes: int) -> Params:
    blocks = [_init_dec_block(gen, width) for _ in range(layers)]
    pw, pb = _linear_init(gen, num_classes, width)
    return {"blocks": vit.stack_blocks(blocks), "pred_w": pw, "pred_b": pb}


def init_head_params(gen: torch.Generator, n_layers: int = 11, in_dim: int = 768,
                     embed: int = 256, dec_layers: int = 3,
                     num_classes: int = 21) -> Params:
    return {
        "fuse": init_fuse_params(gen, n_layers, in_dim, embed),
        "decoder": init_decoder_params(gen, embed, dec_layers, num_classes),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def fuse_forward(p: Params, layer_tokens: torch.Tensor,
                 gen: Optional[torch.Generator] = None,
                 dropout_rate: float = 0.1,
                 policy: precision.Policy = precision.DEFAULT,
                 batch_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Stacked per-layer MLPs + channel concat (layer order) + 1x1 fuse,
    then, with a generator, Dropout2d (whole channels per image).
    layer_tokens: (N_layers, B, P, D) patch tokens.  ``batch_rows`` =
    (first row, global batch) where this batch is a slice of a larger one
    (a data-parallel rank): the masks are drawn for the global batch and
    this slice's rows taken, so every row gets the mask one process would
    give it.  Returns (B, P, embed) fp32."""
    cd = policy.compute_dtype
    nl, b, pp, d = layer_tokens.shape
    x = layer_tokens.reshape(nl, b * pp, d)
    h = precision.matmul_f32(x, p["proj1_w"].transpose(1, 2), cd) + p["proj1_b"][:, None]
    h = torch.relu(h)
    h = precision.matmul_f32(h, p["proj2_w"].transpose(1, 2), cd) + p["proj2_b"][:, None]
    e = h.shape[-1]
    h = h.reshape(nl, b, pp, e).permute(1, 2, 0, 3).reshape(b, pp, nl * e)
    out = precision.matmul_f32(h, p["fuse_w"].t(), cd) + p["fuse_b"]
    if gen is not None and dropout_rate > 0.0:
        first, total = (0, b) if batch_rows is None else batch_rows
        keep = torch.rand((total, 1, out.shape[-1]), generator=gen,
                          device=out.device)[first:first + b] < 1.0 - dropout_rate
        out = out * keep / (1.0 - dropout_rate)
    return out


def decoder_forward(p: Params, fts: torch.Tensor, n_heads: int = 8,
                    valid_p: Optional[torch.Tensor] = None,
                    policy: precision.Policy = precision.DEFAULT,
                    allow_kernel: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """3-block transformer + linear prediction.  fts: (B, P, C).  Returns
    (seg logits (B, P, num_classes), per-layer attention (layers, B, P, P)).
    ``allow_kernel`` (gradient-free callers): K2 on CUDA and a zero-length
    map stack, the maps being a dead output at inference."""
    x = fts
    n_blocks = p["blocks"]["ln_1"]["g"].shape[0]
    attns = []
    for i in range(n_blocks):
        x, attn_w, _ = vit.block_forward(vit.block_params(p["blocks"], i), x, n_heads,
                                         valid=valid_p, policy=policy,
                                         want_attn=not allow_kernel,
                                         allow_kernel=allow_kernel)
        attns.append(attn_w)
    seg = precision.matmul_f32(x, p["pred_w"].t(), policy.compute_dtype) + p["pred_b"]
    if allow_kernel:
        b, pp = fts.shape[:2]
        return seg, torch.zeros((0, b, pp, pp), device=fts.device, dtype=torch.float32)
    return seg, torch.stack(attns)


def head_forward(p: Params, layer_tokens: torch.Tensor,
                 gen: Optional[torch.Generator] = None,
                 valid_p: Optional[torch.Tensor] = None,
                 policy: precision.Policy = precision.DEFAULT,
                 allow_kernel: bool = False) -> HeadOutputs:
    """The fuse head, then the decoder on its output (``fuse_forward``,
    ``decoder_forward``)."""
    fused = fuse_forward(p["fuse"], layer_tokens, gen, policy=policy)
    seg, dec_attn = decoder_forward(p["decoder"], fused, valid_p=valid_p, policy=policy,
                                    allow_kernel=allow_kernel)
    return HeadOutputs(seg, fused, dec_attn)
