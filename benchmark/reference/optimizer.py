"""Poly-warmup AdamW and SGD (a frozen copy of the plain math of
weclip_tpu_torch/train/optimizer.py).

The JAX package uses ``optax.adamw`` with a schedule; this is
``torch.optim.AdamW`` with a ``LambdaLR`` that computes the same numbers:

- lr = learning_rate * head_lr_mult times the multiplier below, read at
  the step count BEFORE the update (LambdaLR's epoch, optax's count);
- warmup (t < W): 1 - (1 - t/W) * (1 - warmup_ratio); then poly
  (1 - t/T) ** power with t clamped to T - 1, so a run driven past
  ``max_iters`` keeps stepping at the last lr instead of 0;
- decoupled weight decay on every parameter, eps 1e-8, bias-corrected
  moments (the two updates differ only in fp32 rounding order).

The SGD variant keeps its own schedule, quirk included: during warmup the
multiplier is (1 - t/W) ** power * 10, so it falls from 10x to 0, then
poly decay over the remaining steps (1 - (t - W)/(T - W)) ** power, t
clamped to T - 1.  ``torch.optim.SGD`` adds the weight decay to the
gradient before the momentum, as the JAX package's
``add_decayed_weights`` ahead of ``optax.sgd`` does.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch

from benchmark.reference.config import OptimizerConfig


def poly_warmup_multiplier(cfg: OptimizerConfig, max_iters: int
                           ) -> Callable[[int], float]:
    def mult(step: int) -> float:
        t = float(step)
        if t < cfg.warmup_iter:
            return 1.0 - (1.0 - t / cfg.warmup_iter) * (1.0 - cfg.warmup_ratio)
        tp = min(t, float(max_iters - 1))
        return max(1.0 - tp / max_iters, 0.0) ** cfg.power
    return mult


def make_optimizer(params: Iterable[torch.Tensor], cfg: OptimizerConfig,
                   max_iters: int
                   ) -> Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """(optimizer, scheduler); call ``optimizer.step()`` then
    ``scheduler.step()`` once per training step."""
    opt = torch.optim.AdamW(list(params), lr=cfg.learning_rate * cfg.head_lr_mult,
                            betas=tuple(cfg.betas), eps=1e-8,
                            weight_decay=cfg.weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, poly_warmup_multiplier(cfg, max_iters))
    return opt, sched


