"""Attention kernels K1-K3 and K6 (port of weclip_tpu/ops/pallas_attention.py).

Each wrapper sits beside its plain PyTorch version:

- ``attention_core`` (K1 with the head-mean map, K2 without) /
  ``attention_core_plain``;
- ``attention_bwd`` (K3, and K3-rect for Lq != Lk) / ``attention_bwd_plain``;
- ``cross_attention_core`` (K6, rectangular, no map) /
  ``cross_attention_core_plain``;
- ``AttentionCoreFn``, the ``torch.autograd.Function`` whose forward is K1
  and whose backward is K3 (the JAX ``custom_vjp`` attention_core_diff), and
  ``CrossAttentionCoreFn``, forward K6 and backward K3-rect (the CoMer
  ``custom_vjp`` _cross_core_fused).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises.  Sources, under bf16 up to head width 128:
K1, K2, K3 and K3-rect ``csrc/flash_attention.cu`` (key-tiled, any length;
K1 is K2's forward with each row's (max, 1/sum) written out, then a map
kernel that sums P over the heads, ``attention_row_stats_plain`` and
``attention_map_plain`` being the two launches' plain versions; K3 reads
bf16 q, k, v and dO as they come and scales q as it stages it); K6, and
K1's forward and K2 at head widths 32, 64 and 128 (``forward_design``),
``csrc/hopper_attention.cu`` (``wgmma`` products on TMA-loaded tiles).
Under fp32 (every attention call of the fp32 policy, and the eval
decoder's under the default ``head_dtype``): K2, K6, the backward and K1's
forward ``csrc/cross_attention.cu`` (split-TF32 products on the tensor
cores), K1's map ``csrc/attention.cu``; any L.  The TPU stream padding
(``stream_pad_len``/``pad_stream``, and CoMer's 128-multiples) is not
ported: the kernels run at the true sequence lengths.

Every kernel takes any head width Dh >= 1, as the Pallas kernels do: the
C side runs Dh 16, 32, 64 and 128 as compiled instances, a width between
them on the next one up with zeros in the lanes past Dh, and a width above
128 as slices of 128 columns (``csrc/cross_attention.cu`` under both score
types, K1's map ``csrc/attention.cu``).  K6 under bf16 up to 128 reads its
tiles by TMA, which needs rows of a multiple of 16 bytes, so there a width
that is not a multiple of 8 is handed over zero-padded to the next
multiple of 8 (a copy of q, k and v, part of the wrapper's time).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from weclip_tpu_torch import kernels
from weclip_tpu_torch.core import precision
from weclip_tpu_torch.ops.attention import MhaParams, qkv_project
from weclip_tpu_torch.utils import spans

# the widest head of the bf16 kernels of flash_attention.cu and
# hopper_attention.cu; wider heads run cross_attention.cu's slices
FLASH_MAX_HEAD_DIM = 128

# The designs of the bf16 self-attention forward (K1's first launch, K2),
# and the program counter that counts each bf16 call by the one that ran
# it: WGMMA, hopper_attention.cu's wgmma/TMA kernel; MMA,
# flash_attention.cu's mma.sync kernel (or, above Dh 128,
# cross_attention.cu's).  Graph replays count as the calls they replay.
WGMMA, MMA = "wgmma", "mma"
FWD_COUNTER = "attention_fwd"
# the head widths the wgmma forward is built at and checked at on the card
WGMMA_HEAD_DIMS = (32, 64, 128)


def _check_head_dim(name: str, dh: int) -> None:
    if dh < 1:
        raise ValueError(f"{name}: head dim {dh} is below 1")


def _key_bias(kmask: torch.Tensor) -> torch.Tensor:
    """(B, L) {0,1} mask -> additive fp32 bias: 0 valid, -1e30 masked."""
    return (kmask.float() - 1.0) * 1e30


def _padded_key_bias(kmask: torch.Tensor, tile: int = 64) -> torch.Tensor:
    """The key bias padded with -1e30 to whole ``tile``-key tiles, as the
    key-tiled kernels stage it: (B, L rounded up to ``tile``)."""
    pad = -kmask.shape[1] % tile
    return torch.nn.functional.pad(_key_bias(kmask), (0, pad), value=-1e30).contiguous()


def _check_cuda(name: str, kmask: torch.Tensor, *tensors: torch.Tensor) -> None:
    """The kernels read ``tensors`` directly (CUDA, contiguous, 16-byte
    aligned) and the key bias built from ``kmask`` (CUDA, any layout)."""
    for t in (kmask,) + tensors:
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: expected tensors on one CUDA device, "
                             f"got {t.device} and {tensors[0].device}")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: expected contiguous, 16-byte aligned tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no autograd rule here; "
                           "use AttentionCoreFn for a differentiable call")


# ---------------------------------------------------------------------------
# K1 / K2: forward
# ---------------------------------------------------------------------------

def _scores(q: torch.Tensor, k: torch.Tensor, kmask: torch.Tensor) -> torch.Tensor:
    """fp32 S = bf16-or-fp32(q * Dh^-0.5) K^T + key bias, (B, H, L, L): the
    scores of the Pallas ``_attn_kernel`` in q's score dtype."""
    sd = q.dtype
    qs = (q.float() * q.shape[-1] ** -0.5).to(sd).float()
    scores = torch.matmul(qs, k.to(sd).float().transpose(-1, -2))
    return scores + _key_bias(kmask)[:, None, None, :]


def attention_core_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kmask: torch.Tensor, export_weights: bool = True
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """q, k, v: (B, H, L, Dh) in the score dtype (bf16 or fp32); kmask
    (B, L) {0,1}.  Returns (out (B, H, L, Dh) in q's dtype, head-mean map
    (B, L, L) fp32 or None).  Arithmetic of the Pallas ``_attn_kernel``."""
    sd = q.dtype
    scores = _scores(q, k, kmask)
    smax = scores.amax(dim=-1, keepdim=True).clamp_min(-5e29)
    ex = torch.exp(scores - smax)
    recip = 1.0 / ex.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    vs = v.to(sd).float()
    if not export_weights:
        # normalize after the value matmul, like the no-export kernel
        ov = torch.matmul(ex.to(sd).float(), vs)
        return (ov * recip).to(sd), None
    attn = ex * recip
    out = torch.matmul(attn.to(sd).float(), vs).to(sd)
    return out, attn.sum(dim=1) * (1.0 / q.shape[1])


def attention_row_stats_plain(q: torch.Tensor, k: torch.Tensor,
                              kmask: torch.Tensor) -> torch.Tensor:
    """Plain version of K1's first launch's statistics: each query row's
    (max score, clamped at -5e29; 1 / sum of exp(s - max), the sum clamped
    at 1e-30), (B, H, L, 2) fp32.  q, k as for ``attention_core_plain``."""
    scores = _scores(q, k, kmask)
    smax = scores.amax(dim=-1, keepdim=True).clamp_min(-5e29)
    recip = 1.0 / torch.exp(scores - smax).sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.cat([smax, recip], dim=-1)


def attention_map_plain(q: torch.Tensor, k: torch.Tensor, kmask: torch.Tensor,
                        stats: torch.Tensor) -> torch.Tensor:
    """Plain version of K1's map launch: the mean over heads of P =
    exp(s - max) * (1/sum) from the (B, H, L, 2) row ``stats``, (B, L, L)
    fp32."""
    p = torch.exp(_scores(q, k, kmask) - stats[..., :1]) * stats[..., 1:]
    return p.sum(dim=1) * (1.0 / q.shape[1])


def forward_design(dtype: torch.dtype, dh: int) -> str:
    """The design of the self-attention forward at head width ``dh`` in
    ``dtype``: ``WGMMA`` for bf16 at a width of ``WGMMA_HEAD_DIMS``, else
    ``MMA`` (every other dtype and width keeps its kernel).  No shape term:
    on the H100 the wgmma kernel is the faster at every grid timed, down to
    one block (``chip_smoke.py::check_forward_designs``)."""
    if dtype != torch.bfloat16 or dh not in WGMMA_HEAD_DIMS:
        return MMA
    return WGMMA


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kmask: torch.Tensor, export_weights: bool = True,
                   stats: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1 (``export_weights=True``) / K2 on CUDA; the plain version on CPU.
    Both take any L and any head width.  K1 is two
    launches: a key-tiled forward that writes each row's (max, 1/sum), then
    the map kernel, which sums P over the heads from them.  ``stats``, a
    (B, H, L, 2) fp32 CUDA buffer, receives those statistics (K1 only).
    The bf16 forward's kernel is ``forward_design``'s; each bf16 call counts
    once under ``FWD_COUNTER``, keyed by the design that ran it."""
    if stats is not None and not (q.is_cuda and export_weights):
        raise ValueError("attention_core: stats are written by K1 on CUDA only")
    if not q.is_cuda:
        return attention_core_plain(q, k, v, kmask, export_weights)
    _check_cuda("attention_core", kmask, q, k, v)
    b, h, l, dh = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attention_core: unsupported dtype {q.dtype}")
    if k.shape != q.shape or v.shape != q.shape or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("attention_core: q, k, v must share shape and dtype")
    if tuple(kmask.shape) != (b, l):
        raise ValueError(f"attention_core: kmask {tuple(kmask.shape)} != {(b, l)}")
    _check_head_dim("attention_core", dh)
    out = torch.empty_like(q)
    amap = (torch.empty((b, l, l), device=q.device, dtype=torch.float32)
            if export_weights else None)
    bf16, c_scale = q.dtype == torch.bfloat16, ctypes.c_float(dh ** -0.5)
    if export_weights and stats is None:
        stats = torch.empty((b, h, l, 2), device=q.device, dtype=torch.float32)
    elif stats is not None and (
            tuple(stats.shape) != (b, h, l, 2) or stats.dtype != torch.float32
            or stats.device != q.device or not stats.is_contiguous()):
        raise ValueError("attention_core: stats must be a contiguous "
                         "(B, H, L, 2) fp32 tensor on q's device")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        bias = _padded_key_bias(kmask)
        st = None if stats is None else stats.data_ptr()
        design = forward_design(q.dtype, dh)
        flash = bf16 and dh <= FLASH_MAX_HEAD_DIM
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(), st)
        if design == WGMMA:
            kernels.call("hopper_attention", "attn_fwd_wgmma", *args, b, h, l, dh, c_scale,
                         stream)
        elif flash:
            kernels.call("flash_attention", "flash_fwd", *args, b, h, l, dh, c_scale, stream)
        elif bf16:   # above Dh 128, scaling q as it stages it
            kernels.call("cross_attention", "xattn_fwd_bf16", *args, b, h, l, l, dh, c_scale,
                         0, stream)
        else:        # split-TF32
            kernels.call("cross_attention", "xattn_fwd", *args, b, h, l, l, dh, c_scale,
                         stream)
        if export_weights:
            # the map from the forward's row statistics, on the same scaled q
            lib, fn = (("flash_attention", "attn_map") if flash else
                       ("attention", "attn_map_bf16" if bf16 else "attn_map_f32"))
            kernels.call(lib, fn, q.data_ptr(), k.data_ptr(), bias.data_ptr(),
                         stats.data_ptr(), amap.data_ptr(), b, h, l, dh, c_scale, stream)
    kernels.count_launch("attention_fwd_export" if export_weights else "attention_fwd",
                         (b, h, l, dh))
    if bf16:
        spans.count(FWD_COUNTER, key=design)
    return out, amap


# ---------------------------------------------------------------------------
# K3: backward
# ---------------------------------------------------------------------------

def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, kmask: torch.Tensor,
                        score_dtype: torch.dtype
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q pre-scaled; q, k, v, do (B, H, L, Dh); kmask (B, L).  Returns fp32
    (dq, dk, dv) w.r.t. the pre-scaled q — the arithmetic of the Pallas
    ``_attn_bwd_kernel`` over the whole sequence at once."""
    sd = score_dtype

    def r(t):
        return t.float().to(sd).float()

    qs, ks, vs, dos = r(q), r(k), r(v), r(do)
    scores = torch.matmul(qs, ks.transpose(-1, -2)) + _key_bias(kmask)[:, None, None, :]
    smax = scores.amax(dim=-1, keepdim=True).clamp_min(-5e29)
    ex = torch.exp(scores - smax)
    p = ex * (1.0 / ex.sum(dim=-1, keepdim=True).clamp_min(1e-30))
    dp = torch.matmul(dos, vs.transpose(-1, -2))
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.matmul(ds.to(sd).float(), ks)
    dk = torch.matmul(ds.to(sd).float().transpose(-1, -2), qs)
    dv = torch.matmul(p.to(sd).float().transpose(-1, -2), dos)
    return dq, dk, dv


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, kmask: torch.Tensor,
                  score_dtype: torch.dtype,
                  stats: Optional[torch.Tensor] = None,
                  q_scale: float = 1.0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 (Lq == Lk) and K3-rect (Lq != Lk) on CUDA, the plain version on
    CPU.  q, do (B, H, Lq, Dh); k, v (B, H, Lk, Dh); kmask (B, Lk).  The
    attention runs on the scaled query ``q * q_scale`` (taken in fp32, then
    rounded to the score type), and fp32 (dq, dk, dv) are the gradients
    with respect to it.  Under bf16 the kernels (csrc/flash_attention.cu)
    read q, k, v and do in bf16 (other dtypes are cast first; above Dh 128
    csrc/cross_attention.cu's bf16 kernels run); under fp32 the split-TF32
    kernels of csrc/cross_attention.cu.  ``stats``, a (B, H, Lq, 3) fp32
    CUDA buffer, receives each query row's (max score, 1/sum, delta)."""
    if not q.is_cuda:
        qs = q if q_scale == 1.0 else q.float() * q_scale
        return attention_bwd_plain(qs, k, v, do, kmask, score_dtype)
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    if (do.shape != q.shape or v.shape != k.shape
            or tuple(k.shape) != (b, h, lk, dh)):
        raise ValueError("attention_bwd: expected q, do (B, H, Lq, Dh) and "
                         "k, v (B, H, Lk, Dh)")
    if tuple(kmask.shape) != (b, lk):
        raise ValueError(f"attention_bwd: kmask {tuple(kmask.shape)} != {(b, lk)}")
    _check_head_dim("attention_bwd", dh)
    if score_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attention_bwd: unsupported score dtype {score_dtype}")
    dq = torch.empty(q.shape, device=q.device, dtype=torch.float32)
    dk = torch.empty(k.shape, device=q.device, dtype=torch.float32)
    dv = torch.empty_like(dk)
    if stats is None:
        stats = torch.empty((b, h, lq, 3), device=q.device, dtype=torch.float32)
    elif (tuple(stats.shape) != (b, h, lq, 3) or stats.dtype != torch.float32
          or stats.device != q.device or not stats.is_contiguous()):
        raise ValueError("attention_bwd: stats must be a contiguous (B, H, Lq, 3) "
                         "fp32 tensor on q's device")
    outs = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        bf16 = score_dtype == torch.bfloat16
        ins = [t.to(score_dtype).contiguous() for t in (q, k, v, do)]
        _check_cuda("attention_bwd", kmask, *ins)
        bias = _padded_key_bias(kmask)
        if bf16 and dh <= FLASH_MAX_HEAD_DIM:
            lib, fn = "flash_attention", "flash_bwd"
        else:
            lib, fn = "cross_attention", "xattn_bwd_bf16" if bf16 else "xattn_bwd"
        kernels.call(lib, fn, *(t.data_ptr() for t in ins), bias.data_ptr(), *outs,
                     b, h, lq, lk, dh, ctypes.c_float(q_scale), stream)
    kernels.count_launch("attention_bwd" if lq == lk else "attention_bwd_rect",
                         (b, h, lq, lk, dh))
    return dq, dk, dv


# ---------------------------------------------------------------------------
# K6: rectangular forward (the CoMer CTI cross-attention)
# ---------------------------------------------------------------------------

def cross_attention_core_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               kmask: torch.Tensor) -> torch.Tensor:
    """q (B, H, Lq, Dh) pre-scaled, in the score dtype (bf16 or fp32); k, v
    (B, H, Lk, Dh); kmask (B, Lk) {0,1}.  Returns fp32 (B, H, Lq, Dh): the
    arithmetic of the Pallas no-export ``_attn_kernel`` at scale 1
    (normalized after the value product)."""
    sd = q.dtype
    scores = torch.matmul(q.float(), k.to(sd).float().transpose(-1, -2))
    scores = scores + _key_bias(kmask)[:, None, None, :]
    smax = scores.amax(dim=-1, keepdim=True).clamp_min(-5e29)
    ex = torch.exp(scores - smax)
    recip = 1.0 / ex.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.matmul(ex.to(sd).float(), v.to(sd).float()) * recip


def cross_attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kmask: torch.Tensor) -> torch.Tensor:
    """K6 on CUDA; the plain version on CPU.  q, k, v share the score dtype
    (bf16: the wgmma kernel of csrc/hopper_attention.cu up to head width
    128, csrc/cross_attention.cu's bf16 forward above; fp32: the split-TF32
    forward of csrc/cross_attention.cu)."""
    if not q.is_cuda:
        return cross_attention_core_plain(q, k, v, kmask)
    _check_cuda("cross_attention_core", kmask, q, k, v)
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cross_attention_core: unsupported dtype {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("cross_attention_core: q, k, v must share one dtype")
    if tuple(k.shape) != (b, h, lk, dh) or v.shape != k.shape:
        raise ValueError("cross_attention_core: expected q (B, H, Lq, Dh) and "
                         "k, v (B, H, Lk, Dh)")
    if tuple(kmask.shape) != (b, lk):
        raise ValueError(f"cross_attention_core: kmask {tuple(kmask.shape)} != {(b, lk)}")
    _check_head_dim("cross_attention_core", dh)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        bias = _padded_key_bias(kmask)
        one = ctypes.c_float(1.0)
        if q.dtype == torch.bfloat16 and dh <= FLASH_MAX_HEAD_DIM:
            pad = -dh % 8   # TMA: rows of a multiple of 16 bytes
            if pad:
                q, k, v = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
            out = torch.empty(q.shape, device=q.device, dtype=torch.float32)
            kernels.call("hopper_attention", "xattn_fwd_wgmma", q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, lq, lk,
                         dh + pad, stream)
            if pad:
                out = out[..., :dh].contiguous()
        else:   # split-TF32 (fp32), or bf16 above Dh 128 with an fp32 output
            out = torch.empty(q.shape, device=q.device, dtype=torch.float32)
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), None, b, h, lq, lk, dh, one)
            if q.dtype == torch.bfloat16:
                kernels.call("cross_attention", "xattn_fwd_bf16", *args, 1, stream)
            else:
                kernels.call("cross_attention", "xattn_fwd", *args, stream)
    kernels.count_launch("cross_attention", (b, h, lq, lk, dh))
    return out


# ---------------------------------------------------------------------------
# differentiable core + MHA wrappers
# ---------------------------------------------------------------------------

class AttentionCoreFn(torch.autograd.Function):
    """Differentiable attention core: K1 forward (with the map export), K3
    backward.  q, k, v (B, H, L, Dh) UNscaled in the score dtype; kmask
    (B, L).  The map output is not differentiable: its cotangent is taken
    as zero (GradCAM consumes it detached)."""

    @staticmethod
    def forward(ctx, q, k, v, kmask):
        out, amap = attention_core(q.detach(), k.detach(), v.detach(), kmask,
                                   export_weights=True)
        ctx.save_for_backward(q, k, v, kmask)
        ctx.mark_non_differentiable(amap)
        return out, amap

    @staticmethod
    def backward(ctx, g_out, _g_map_assumed_zero):
        q, k, v, kmask = ctx.saved_tensors
        scale = q.shape[-1] ** -0.5
        dq, dk, dv = attention_bwd(q, k, v, g_out, kmask, score_dtype=q.dtype,
                                   q_scale=scale)
        return (dq * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


class CrossAttentionCoreFn(torch.autograd.Function):
    """Differentiable rectangular attention core: K6 forward, K3-rect
    backward.  q (B, H, Lq, Dh) pre-scaled, k, v (B, H, Lk, Dh), all in the
    score dtype; kmask (B, Lk).  Returns fp32; the cotangents come back in
    the primal dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, kmask):
        ctx.save_for_backward(q, k, v, kmask)
        return cross_attention_core(q.detach(), k.detach(), v.detach(), kmask)

    @staticmethod
    def backward(ctx, g_out):
        q, k, v, kmask = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, g_out, kmask, score_dtype=q.dtype)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def _heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, l, d = t.shape
    return t.reshape(b, l, n_heads, d // n_heads).permute(0, 2, 1, 3).contiguous()


def _out_project(out: torch.Tensor, p: MhaParams, valid, cd, x_dtype):
    b, h, l, hd = out.shape
    out = out.to(cd).permute(0, 2, 1, 3).reshape(b, l, h * hd)
    out = torch.matmul(out, p.out_w.to(cd).t()) + p.out_b.to(cd)
    if valid is not None:
        out = out.masked_fill(~valid.bool()[..., None], 0.0)
    return out.to(x_dtype)


def _kmask(valid, b, l, device):
    return (valid.float() if valid is not None
            else torch.ones((b, l), device=device, dtype=torch.float32))


def mha_with_weights_kernel(
    x: torch.Tensor,
    p: MhaParams,
    n_heads: int,
    valid: Optional[torch.Tensor] = None,
    policy: precision.Policy = precision.DEFAULT,
    want_weights: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """ops.attention.mha_with_weights through the forward kernels
    (projections stay torch matmuls); gradient-free callers only."""
    b, l, _ = x.shape
    cd = policy.compute_dtype
    q, k, v = qkv_project(x, p, cd)
    out, amap = attention_core(_heads(q, n_heads), _heads(k, n_heads),
                               _heads(v, n_heads), _kmask(valid, b, l, x.device),
                               export_weights=want_weights)
    if valid is not None and amap is not None:
        amap = amap.masked_fill(~valid.bool()[:, :, None], 0.0)
    return _out_project(out, p, valid, cd, x.dtype), amap


def mha_with_weights_fused(
    x: torch.Tensor,
    p: MhaParams,
    n_heads: int,
    valid: Optional[torch.Tensor] = None,
    policy: precision.Policy = precision.DEFAULT,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable ops.attention.mha_with_weights: K1 forward and K3
    backward through ``AttentionCoreFn``.  The map must be consumed
    detached."""
    b, l, _ = x.shape
    cd = policy.compute_dtype
    q, k, v = qkv_project(x, p, cd)
    out, amap = AttentionCoreFn.apply(_heads(q, n_heads), _heads(k, n_heads),
                                      _heads(v, n_heads),
                                      _kmask(valid, b, l, x.device))
    if valid is not None:
        amap = amap.masked_fill(~valid.bool()[:, :, None], 0.0)
    return _out_project(out, p, valid, cd, x.dtype), amap
