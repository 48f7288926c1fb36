"""The frozen ViT block's elementwise passes as three fused bf16 kernels
(csrc/block_epilogue.cu), each beside its plain PyTorch twin.

- ``qkv_bias_split`` / ``qkv_bias_split_plain``: the qkv product's bias and
  its split into the (B, H, L, Dh) heads the attention kernels take;
- ``residual_ln`` / ``residual_ln_plain``: the masked, biased residual add
  and the next LayerNorm, fp32 statistics;
- ``bias_quick_gelu`` / ``bias_quick_gelu_plain``: the MLP's first bias
  and QuickGELU, in place.

Every value rounds to bf16 where the unfused torch sequence of
``models/clip/vit.py::block_forward`` under the bf16 policy rounds it (the
twins are that sequence), so the bias adds, the residual, the head split
and the mask are bit-equal, and the LayerNorm and QuickGELU outputs within
one bf16 rounding.  The only caller is ``vit.frozen_block_forward``.  A
wrapper given CPU tensors runs the twin; given CUDA tensors it launches its
kernel or raises.  The kernels take widths that are a multiple of 8 (D up
to 32768 for ``residual_ln``), any number of rows, bf16 contiguous
tensors, 16-byte aligned.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from weclip_tpu_torch import kernels

BF16 = torch.bfloat16
MAX_LN_WIDTH = 32768     # csrc/block_epilogue.cu: 4 vectors of 8 a thread, 1024 threads


def _check(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    """The kernels read ``tensors`` directly: on one CUDA device, of
    ``dtype``, contiguous and 16-byte aligned."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: expected tensors on one CUDA device, "
                             f"got {t.device} and {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: expected contiguous, 16-byte aligned tensors")


def _width(name: str, d: int) -> None:
    if d < 8 or d % 8:
        raise ValueError(f"{name}: width {d} is not a positive multiple of 8")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# (a) the qkv bias and the head split
# ---------------------------------------------------------------------------

def qkv_bias_split_plain(g: torch.Tensor, bias: torch.Tensor, n_heads: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """g (B, L, 3D) the qkv product, bias (3D,): q, k, v (B, H, L, Dh) of
    g + bias, each added as torch's bf16 add rounds it."""
    b, l, d3 = g.shape
    d = d3 // 3
    x = (g + bias).reshape(b, l, 3, n_heads, d // n_heads)
    return tuple(x[:, :, t].permute(0, 2, 1, 3).contiguous() for t in range(3))


def qkv_bias_split(g: torch.Tensor, bias: torch.Tensor, n_heads: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``qkv_bias_split_plain`` in one pass over g on CUDA."""
    if not g.is_cuda:
        return qkv_bias_split_plain(g, bias, n_heads)
    b, l, d3 = g.shape
    d = d3 // 3
    if d3 != 3 * d or d % n_heads or tuple(bias.shape) != (d3,):
        raise ValueError(f"qkv_bias_split: g {tuple(g.shape)}, bias {tuple(bias.shape)} "
                         f"and {n_heads} heads do not make q, k, v")
    _width("qkv_bias_split", d)
    _check("qkv_bias_split", BF16, g, bias)
    dh = d // n_heads
    q, k, v = (torch.empty((b, n_heads, l, dh), device=g.device, dtype=BF16)
               for _ in range(3))
    with torch.cuda.device(g.device):
        kernels.call("block_epilogue", "qkv_bias_split", g.data_ptr(), bias.data_ptr(),
                     q.data_ptr(), k.data_ptr(), v.data_ptr(), b, l, n_heads, dh, _stream(g))
    kernels.count_launch("qkv_bias_split", (b * l, d3))
    return q, k, v


# ---------------------------------------------------------------------------
# (b) the residual add and the LayerNorm
# ---------------------------------------------------------------------------

def residual_ln_plain(g: torch.Tensor, ln: Optional[Tuple[torch.Tensor, torch.Tensor]],
                      x: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                      rowmask: Optional[torch.Tensor] = None,
                      out: Optional[torch.Tensor] = None, eps: float = 1e-5
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(y, LN(y)) over the last axis of g (bf16): y = g + bias, zeroed on
    the rows where ``rowmask`` (g's leading shape) is False, plus the
    residual x, each add rounded to bf16; each term optional.  y is written
    to ``out`` where given (only where it differs from g).  LN(y) is the
    fp32 LayerNorm with ``ln`` = (gamma, beta), rounded once to bf16; None
    without ``ln``."""
    y = g
    if bias is not None:
        y = y + bias
    if rowmask is not None:
        y = y.masked_fill(~rowmask[..., None], 0.0)
    if x is not None:
        y = x + y
    if out is not None and y is not g:
        y = out.copy_(y)
    if ln is None:
        return y, None
    gamma, beta = ln
    return y, F.layer_norm(y.float(), (y.shape[-1],), gamma.float(), beta.float(),
                           eps).to(y.dtype)


def residual_ln(g: torch.Tensor, ln: Optional[Tuple[torch.Tensor, torch.Tensor]],
                x: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                rowmask: Optional[torch.Tensor] = None,
                out: Optional[torch.Tensor] = None, eps: float = 1e-5
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``residual_ln_plain`` in one pass over the rows on CUDA: y is written
    (to ``out``, or a new tensor) where any of x, bias and rowmask is
    given, and LN(y) where ``ln`` is; gamma and beta fp32, rowmask bool."""
    if not g.is_cuda:
        return residual_ln_plain(g, ln, x, bias, rowmask, out, eps)
    d = g.shape[-1]
    rows = g.numel() // d
    _width("residual_ln", d)
    if d > MAX_LN_WIDTH:
        raise ValueError(f"residual_ln: width {d} is above {MAX_LN_WIDTH}")
    writes = x is not None or bias is not None or rowmask is not None
    if not writes and ln is None:
        raise ValueError("residual_ln: nothing to write")
    for name, t, shape in (("x", x, g.shape), ("bias", bias, (d,)), ("out", out, g.shape),
                           ("rowmask", rowmask, g.shape[:-1])):
        if t is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"residual_ln: {name} {tuple(t.shape)} != {tuple(shape)}")
    bf = [t for t in (g, x, bias, out) if t is not None]
    _check("residual_ln", BF16, *bf)
    y = g
    if writes:
        y = torch.empty_like(g) if out is None else out
    lo = gamma = beta = None
    if ln is not None:
        gamma, beta = ln
        if tuple(gamma.shape) != (d,) or tuple(beta.shape) != (d,):
            raise ValueError("residual_ln: gamma and beta must be (D,)")
        _check("residual_ln", torch.float32, gamma, beta)
        if gamma.device != g.device:
            raise ValueError("residual_ln: gamma and beta must be on g's device")
        lo = torch.empty_like(g)
    if rowmask is not None:
        if rowmask.dtype != torch.bool or not rowmask.is_contiguous():
            raise ValueError("residual_ln: rowmask must be a contiguous bool tensor")
        if rowmask.device != g.device:
            raise ValueError("residual_ln: rowmask must be on g's device")
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(g.device):
        kernels.call("block_epilogue", "residual_ln", ptr(x), g.data_ptr(), ptr(bias),
                     ptr(rowmask), ptr(gamma), ptr(beta),
                     y.data_ptr() if writes else None, ptr(lo), rows, d, float(eps),
                     _stream(g))
    kernels.count_launch("residual_ln", (rows, d))
    return y, lo


# ---------------------------------------------------------------------------
# (c) the MLP's first bias and QuickGELU
# ---------------------------------------------------------------------------

def bias_quick_gelu_plain(g: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """h * sigmoid(1.702 h), h = g + bias, in g's dtype at torch's rounding
    points; written into g, which is returned."""
    h = g + bias
    return g.copy_(h * torch.sigmoid(1.702 * h))


def bias_quick_gelu(g: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``bias_quick_gelu_plain`` in one pass on CUDA, in place in g."""
    if not g.is_cuda:
        return bias_quick_gelu_plain(g, bias)
    f = g.shape[-1]
    _width("bias_quick_gelu", f)
    if tuple(bias.shape) != (f,):
        raise ValueError(f"bias_quick_gelu: bias {tuple(bias.shape)} != {(f,)}")
    _check("bias_quick_gelu", BF16, g, bias)
    rows = g.numel() // f
    with torch.cuda.device(g.device):
        kernels.call("block_epilogue", "bias_quick_gelu", g.data_ptr(), bias.data_ptr(),
                     g.data_ptr(), rows, f, _stream(g))
    kernels.count_launch("bias_quick_gelu", (rows, f))
    return g
