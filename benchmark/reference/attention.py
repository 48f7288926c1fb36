"""Multi-head self-attention that also exports the head-averaged attention
map (a frozen copy of the plain math of
weclip_tpu_torch/ops/attention.py).

``mha_with_weights`` is the plain formulation (the JAX package's XLA path).
In this copy ``mha_auto`` takes the plain formulation for every caller.
Layout is batch-first (B, L, D); matmuls take the policy's compute dtype
with fp32 accumulation; the softmax is fp32."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from benchmark.reference import precision


class MhaParams(NamedTuple):
    """torch-layout multihead attention parameters.

    in_w: (3D, D) packed q/k/v projection;  in_b: (3D,)
    out_w: (D, D);  out_b: (D,)
    """
    in_w: torch.Tensor
    in_b: torch.Tensor
    out_w: torch.Tensor
    out_b: torch.Tensor


def qkv_project(x: torch.Tensor, p: MhaParams, cd: torch.dtype) -> torch.Tensor:
    """(B, L, D) -> (3, B, L, D) packed projection in the compute dtype,
    bias added in the compute dtype."""
    d = x.shape[-1]
    w3 = p.in_w.reshape(3, d, d).to(cd)
    b3 = p.in_b.reshape(3, d).to(cd)
    return precision.einsum("bld,ted->tble", x.to(cd), w3) + b3[:, None, None, :]


def mha_with_weights(
    x: torch.Tensor,
    p: MhaParams,
    n_heads: int,
    valid: Optional[torch.Tensor] = None,
    policy: precision.Policy = precision.DEFAULT,
    attn_bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-attention returning (output (B,L,D), head-mean weights (B,L,L)).

    valid: optional (B, L) token-validity mask.  Invalid keys get zero
    attention mass; rows of invalid queries are zeroed in both outputs.
    attn_bias: optional additive bias on the fp32 scores, broadcast to
    (B, H, L, L) (the text encoder's causal mask)."""
    b, l, d = x.shape
    hd = d // n_heads
    if hd * n_heads != d:
        raise ValueError(f"width {d} not divisible by {n_heads} heads")
    cd = policy.compute_dtype
    q, k, v = qkv_project(x, p, cd)
    # q scaled by 1/sqrt(head_dim) in the compute dtype before the scores
    q = (q * torch.tensor(hd ** -0.5, dtype=cd)).reshape(b, l, n_heads, hd)
    k = k.reshape(b, l, n_heads, hd)
    v = v.reshape(b, l, n_heads, hd)

    scores = precision.einsum("bqhe,bkhe->bhqk", q.float(), k.float())
    if attn_bias is not None:
        scores = scores + attn_bias.float()
    if valid is not None:
        kmask = valid.bool()[:, None, None, :]
        scores = scores.masked_fill(~kmask, float("-inf"))

    # fp32 masked softmax, NaN-safe for fully-masked rows
    smax = scores.amax(dim=-1, keepdim=True)
    smax = torch.where(torch.isfinite(smax), smax, torch.zeros_like(smax))
    ex = torch.exp(scores - smax)
    if valid is not None:
        ex = ex.masked_fill(~kmask, 0.0)
    denom = ex.sum(dim=-1, keepdim=True)
    attn = ex / denom.clamp_min(1e-30)                       # (B,h,L,L) fp32

    out = precision.einsum("bhqk,bkhe->bqhe", attn.to(cd), v.to(cd))
    out = out.reshape(b, l, d)
    out = precision.matmul(out, p.out_w.to(cd).t()) + p.out_b.to(cd)

    attn_mean = attn.mean(dim=1)                              # (B,L,L)
    if valid is not None:
        qmask = valid.bool()
        out = out.masked_fill(~qmask[..., None], 0.0)
        attn_mean = attn_mean.masked_fill(~qmask[:, :, None], 0.0)
    return out.to(x.dtype), attn_mean


def mha_auto(
    x: torch.Tensor,
    p: MhaParams,
    n_heads: int,
    valid: Optional[torch.Tensor] = None,
    policy: precision.Policy = precision.DEFAULT,
    want_weights: bool = True,
    allow_kernel: bool = True,
    attn_bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``mha_with_weights`` (the program's plain path; no kernel here)."""
    out, attn = mha_with_weights(x, p, n_heads, valid=valid, policy=policy,
                                 attn_bias=attn_bias)
    return out, (attn if want_weights else None)


def _key_bias(kmask: torch.Tensor) -> torch.Tensor:
    """(B, L) {0,1} mask -> additive fp32 bias: 0 valid, -1e30 masked."""
    return (kmask.float() - 1.0) * 1e30


def cross_attention_core_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               kmask: torch.Tensor) -> torch.Tensor:
    """q (B, H, Lq, Dh) pre-scaled, in the score dtype (bf16 or fp32); k, v
    (B, H, Lk, Dh); kmask (B, Lk) {0,1}.  Returns fp32 (B, H, Lq, Dh),
    normalized after the value product."""
    sd = q.dtype
    scores = precision.matmul(q.float(), k.to(sd).float().transpose(-1, -2))
    scores = scores + _key_bias(kmask)[:, None, None, :]
    smax = scores.amax(dim=-1, keepdim=True).clamp_min(-5e29)
    ex = torch.exp(scores - smax)
    recip = 1.0 / ex.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return precision.matmul(ex.to(sd).float(), v.to(sd).float()) * recip
