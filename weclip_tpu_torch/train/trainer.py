"""Iteration-based training loop (port of weclip_tpu/train/trainer.py,
trimmed to one card and an in-memory dataset).

``dataset`` is required: a sequence of examples, each a dict with ``img``
((3, crop, crop) float32, normalized) and ``present_mask`` ((C_fg,) bool).
Batches follow the JAX loader's order for one process: a fresh
permutation of the dataset per epoch from ``numpy.random.default_rng``
seeded with ``train.seed``, incomplete batches dropped.  Each step compacts
its batch's present classes into a bucket (core/compaction.py).  The VOC
loader, resuming, validation and checkpoint saving are not ported yet:
``resume`` and ``val_dataset`` raise ``NotImplementedError``, and so does a
run that reaches a step where the JAX trainer saves a checkpoint (every
``train.eval_iters`` steps past ``train.ckpt_start_iter``); no final
checkpoint is written.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from weclip_tpu_torch.core import precision
from weclip_tpu_torch.core.compaction import compact_classes, pick_bucket
from weclip_tpu_torch.core.config import Config
from weclip_tpu_torch.models import weclip
from weclip_tpu_torch.models.clip.vit import pos_emb_host
from weclip_tpu_torch.train import step as step_mod

log = logging.getLogger("weclip_tpu_torch")


def batches(dataset: Sequence[Dict[str, np.ndarray]], batch_size: int,
            seed: int) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled, repeating, drop-last batches of ``img`` and
    ``present_mask``."""
    if len(dataset) < batch_size:
        raise ValueError(f"dataset of {len(dataset)} examples is smaller than "
                         f"one batch ({batch_size})")
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(len(dataset))
        for s in range(0, len(order) // batch_size * batch_size, batch_size):
            exs = [dataset[int(i)] for i in order[s:s + batch_size]]
            yield {k: np.stack([np.asarray(e[k]) for e in exs])
                   for k in ("img", "present_mask")}


def make_batcher(cfg: Config, frozen: Dict, device
                 ) -> Callable[[Dict[str, np.ndarray]],
                               Tuple[weclip.Batch, torch.Tensor, torch.Tensor]]:
    """Returns ``to_device(host_batch) -> (batch, cls_idx, cls_active)``:
    host arrays of full square crops -> a ``weclip.Batch`` on ``device``
    (the positional embedding at the crop's grid, every token valid), and
    the batch's present classes compacted into the smallest class bucket
    that holds them (core/compaction.py)."""
    grid = cfg.dataset.crop_size // cfg.clip.patch_size
    pe_table = frozen["visual"]["positional_embedding"].float().cpu().numpy()
    pos_emb = torch.from_numpy(pos_emb_host(pe_table, grid, grid, grid, grid))[None].to(device)
    num_fg = cfg.dataset.num_classes - 1
    buckets = tuple(b for b in (4, 8, 16) if b < num_fg) + (num_fg,)
    dev = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def to_device(host_batch):
        b = host_batch["img"].shape[0]
        batch = weclip.Batch(
            img=dev(host_batch["img"].astype(np.float32)), pos_emb=pos_emb,
            valid=torch.ones((b, grid * grid + 1), dtype=torch.bool, device=device),
            gh=torch.full((b,), grid, device=device),
            gw=torch.full((b,), grid, device=device),
            present_mask=dev(host_batch["present_mask"]).bool())
        present = host_batch["present_mask"]
        ci, ca = compact_classes(present, pick_bucket(present, buckets))
        return batch, dev(ci), dev(ca)

    return to_device


def train(cfg: Config, dataset: Sequence[Dict[str, np.ndarray]],
          max_steps: Optional[int] = None, device="cuda",
          frozen: Optional[Dict] = None, resume: bool = False,
          val_dataset=None) -> step_mod.TrainState:
    """Train the heads (and CoMer where enabled) for ``max_steps`` (default
    ``train.max_iters``) steps; ``frozen`` defaults to the random frozen
    state of seed ``train.seed``.  Logs the window means of the losses and
    the pseudo-label accuracy every ``train.log_iters`` steps."""
    if resume or val_dataset is not None:
        raise NotImplementedError("resume and validation are not ported yet")
    pc = cfg.precision
    policy = precision.make_policy(pc.compute_dtype, pc.param_dtype, pc.softmax_dtype)
    if torch.device(device).type == "cuda":
        precision.strict_matmul()
    if frozen is None:
        frozen = weclip.random_frozen_state(cfg, seed=cfg.train.seed, device=device)
    state = step_mod.create_train_state(
        torch.Generator().manual_seed(cfg.train.seed), cfg, device)
    step_fn = step_mod.make_train_step(cfg, policy)
    to_device = make_batcher(cfg, frozen, device)

    bsz = cfg.train.samples_per_gpu
    total = max_steps or cfg.train.max_iters
    it = batches(dataset, bsz, cfg.train.seed)
    msum, n_window, t_window = None, 0, time.perf_counter()
    for n_iter in range(state.step, total):
        if ((n_iter + 1) % cfg.train.eval_iters == 0
                and n_iter + 1 > cfg.train.ckpt_start_iter):
            raise NotImplementedError("checkpoint saving is not ported yet")
        batch, ci, ca = to_device(next(it))
        state, m = step_fn(state, frozen, batch, rng=cfg.train.seed + 1,
                           cls_idx=ci, cls_active=ca)
        msum = m if msum is None else step_mod.StepMetrics(*(a + b for a, b in zip(msum, m)))
        n_window += 1
        if (n_iter + 1) % cfg.train.log_iters == 0 or n_iter + 1 == total:
            means = [float(x) / n_window for x in msum]
            rate = n_window * bsz / (time.perf_counter() - t_window)
            log.info("iter %d/%d; img/s %.2f; loss %.4f; seg_loss %.4f; "
                     "attn_loss %.4f; pseudo_acc %.4f", n_iter + 1, total, rate,
                     *means)
            msum, n_window, t_window = None, 0, time.perf_counter()
    return state
