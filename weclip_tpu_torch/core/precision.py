"""Mixed-precision policy (port of weclip_tpu/core/precision.py).

fp32 parameters, matmul inputs in the compute dtype with fp32 accumulation,
fp32 LayerNorm and softmax.  ``strict_matmul`` switches off TF32 and
reduced-precision bf16 reductions: the JAX package computes the affinity,
resize and PAR products at ``Precision.HIGHEST``, and TF32 (10-bit mantissa)
would break parity there.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


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
FP32 = make_policy("float32", "float32", "float32")


def strict_matmul() -> None:
    """Full-fp32 products and fp32-accumulated bf16 products on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def matmul_f32(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` with inputs rounded to ``dtype`` and an fp32 result.

    The counterpart of ``einsum(..., preferred_element_type=float32)`` on
    ``dtype`` inputs: a product of two bf16 values is exact in fp32, so an
    fp32 product of the rounded inputs is a bf16 matmul with fp32
    accumulation and an unrounded output."""
    return torch.matmul(a.to(dtype).float(), b.to(dtype).float())
