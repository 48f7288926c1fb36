"""Mixed-precision policy of the plain reference, and its control.

The policy is the program's: fp32 parameters, products on inputs rounded to
the compute dtype (bf16 in the configurations) with fp32 accumulation, fp32
LayerNorm and softmax; the heads at ``head_dtype`` (fp32).  On the card the
reference runs with TF32 off and fp32-accumulated bf16 products
(``strict_matmul``).

Every product of the reference goes through ``matmul``, ``einsum``,
``conv2d`` and, for PAR's elementwise multiply-adds, ``mul`` here.  Inside ``lower_precision()`` each of them takes its
operands one step below the stated precision, the control of the
benchmark's correctness check: bf16 operands are rounded to float8 e4m3
(per-tensor scale to the format's largest value, 448), fp32 operands to
TF32 (10 mantissa bits, round to nearest even).  The rounding passes the
gradient through unchanged.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Policy:
    compute_dtype: torch.dtype
    param_dtype: torch.dtype
    softmax_dtype: torch.dtype


_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


def make_policy(compute_dtype: str = "bfloat16",
                param_dtype: str = "float32",
                softmax_dtype: str = "float32") -> Policy:
    return Policy(_DTYPES[compute_dtype], _DTYPES[param_dtype],
                  _DTYPES[softmax_dtype])


DEFAULT = make_policy()


def strict_matmul() -> None:
    """Full-fp32 products and fp32-accumulated bf16 products on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


_state = threading.local()


@contextlib.contextmanager
def lower_precision():
    """Every product inside runs one precision step below the stated one."""
    prev = getattr(_state, "lower", False)
    _state.lower = True
    try:
        yield
    finally:
        _state.lower = prev


def _lower() -> bool:
    return getattr(_state, "lower", False)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, in x's dtype."""
    xf = x.detach().float()
    amax = xf.abs().amax().clamp_min(1e-30)
    scale = 448.0 / amax
    q = (xf * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q.to(x.dtype) - x).detach()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32's 10 mantissa bits (nearest even)."""
    bits = x.detach().float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = ((bits + 0xFFF + lsb) >> 13) << 13
    return x + (bits.view(torch.float32) - x).detach()


def _operand(x: torch.Tensor, like: torch.dtype) -> torch.Tensor:
    """An operand at one step below ``like`` (the precision it stands for)."""
    if like in (torch.bfloat16, torch.float16):
        return round_fp8(x)
    return round_tf32(x)


def _lowered(*xs: torch.Tensor):
    return [_operand(x, x.dtype) for x in xs]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _lower():
        a, b = _lowered(a, b)
    return torch.matmul(a, b)


def einsum(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    if _lower():
        xs = _lowered(*xs)
    return torch.einsum(eq, *xs)


def conv2d(x: torch.Tensor, w: torch.Tensor, **kw) -> torch.Tensor:
    if _lower():
        x, w = _lowered(x, w)
    return F.conv2d(x, w, **kw)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The elementwise product ``a * b``."""
    if _lower():
        a, b = _lowered(a, b)
    return a * b


def matmul_f32(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` with inputs rounded to ``dtype`` and an fp32 result: a
    product of two bf16 values is exact in fp32, so an fp32 product of the
    rounded inputs is a bf16 matmul with fp32 accumulation."""
    a, b = a.to(dtype), b.to(dtype)
    if _lower():
        a, b = _operand(a, dtype), _operand(b, dtype)
    return torch.matmul(a.float(), b.float())
