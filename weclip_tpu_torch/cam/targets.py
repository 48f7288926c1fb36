"""CAM target functions (port of weclip_tpu/cam/targets.py).

A target scores a model output; in the pullback formulation it is also the
cotangent (seed) fed to the backward pass, so each class builds that seed
directly.
"""

from __future__ import annotations

from typing import Optional

import torch


class ClassifierOutputTarget:
    """One class logit; its seed is the one-hot of the category over a
    (T,) output vector."""

    def __init__(self, category: int):
        self.category = category

    def seed(self, num_outputs: int, dtype=torch.float32) -> torch.Tensor:
        out = torch.zeros(num_outputs, dtype=dtype)
        out[self.category] = 1
        return out

    def __call__(self, model_output: torch.Tensor) -> torch.Tensor:
        if model_output.ndim == 1:
            return model_output[self.category]
        return model_output[:, self.category]


class ClassifierOutputSoftmaxTarget(ClassifierOutputTarget):
    """softmax(logits)[category].  The seed of a pullback through the raw
    logits is the softmax Jacobian's row, which depends on the logit values,
    so ``seed`` needs ``logits=``."""

    def __call__(self, model_output: torch.Tensor) -> torch.Tensor:
        p = torch.softmax(model_output, dim=-1)
        if model_output.ndim == 1:
            return p[self.category]
        return p[:, self.category]

    def seed(self, num_outputs: int, dtype=torch.float32,
             logits: Optional[torch.Tensor] = None) -> torch.Tensor:
        """d softmax(z)[c] / dz = p_c * (onehot_c - p)."""
        if logits is None:
            raise ValueError(
                "ClassifierOutputSoftmaxTarget.seed needs logits= — the "
                "softmax Jacobian row depends on the logit values (use "
                "ClassifierOutputTarget for a value-free one-hot seed)")
        p = torch.softmax(torch.as_tensor(logits).float(), dim=-1)
        e = torch.zeros(num_outputs, dtype=p.dtype, device=p.device)
        e[self.category] = 1
        pc = p[..., self.category]
        return ((e - p) * pc[..., None]).to(dtype)


class SemanticSegmentationTarget:
    """The category's output map summed over the mask's pixels."""

    def __init__(self, category: int, mask):
        self.category = category
        self.mask = torch.as_tensor(mask)

    def __call__(self, model_output: torch.Tensor) -> torch.Tensor:
        return (model_output[self.category] * self.mask).sum()

    def seed_fn(self, model_output_shape) -> torch.Tensor:
        """Cotangent for a (C, H, W) output: the mask in the category's slot."""
        seed = torch.zeros(tuple(model_output_shape), dtype=self.mask.dtype)
        seed[self.category] = self.mask
        return seed
