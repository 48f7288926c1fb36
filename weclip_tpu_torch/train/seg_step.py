"""The fully supervised variant ("seg", port of weclip_tpu/train/seg_step.py):
frozen CLIP features -> fuse -> decoder, trained with masked cross-entropy
against ground-truth masks.  No GradCAM, no PAR, no affinity loss.  Over
a ``mesh`` it reduces as train/step.py does: the loss is this rank's share
of the global-batch loss, the gradients are summed over the data group,
and the metrics are global; the ranks of a model group hold the same
gradients and reduce none.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from weclip_tpu_torch.core import precision
from weclip_tpu_torch.core.config import Config, crop_grid
from weclip_tpu_torch.models import weclip
from weclip_tpu_torch.ops.resize import resize_bilinear
from weclip_tpu_torch.parallel import mesh as meshlib
from weclip_tpu_torch.train.losses import _masked_ce
from weclip_tpu_torch.train.step import (TrainState, all_reduce_grads, create_train_state,
                                         param_leaves, step_generator)


class SegMetrics(NamedTuple):
    loss: torch.Tensor
    acc: torch.Tensor    # share of labelled pixels predicted right


# the seg variant trains the same tree with the same poly-warmup AdamW
create_seg_train_state = create_train_state


def make_seg_train_step(cfg: Config, policy: precision.Policy = precision.DEFAULT,
                        mesh: Optional[meshlib.Mesh] = None):
    """Returns ``train_step(state, frozen, batch, label, rng=None) -> (state,
    SegMetrics)``: ``label`` (B, H, W) ground truth at the crop size, pixels
    at ``ignore_index`` left out; ``rng`` seeds the step's dropout generator
    (None: dropout off).  Updates the state in place.  ``mesh``:
    the ranks, ``batch`` and ``label`` this rank's slice, ``frozen``
    sharded over the model axis where the mesh has one."""
    crop = cfg.dataset.crop_size
    g = crop_grid(cfg)
    dp = meshlib.dp_only(mesh)
    reduce = functools.partial(meshlib.psum, group=mesh.data_group) if dp else None

    def loss_fn(params, frozen, batch: weclip.Batch, label, gen):
        b = batch.img.shape[0]
        out = weclip.forward_train(params, frozen, batch, cfg, False, gen, policy,
                                   with_pseudo=False,
                                   batch_rows=(mesh.data_rank * b, mesh.data * b)
                                   if dp else None)
        seg_hw = resize_bilinear(out.seg.reshape(b, g, g, -1).permute(0, 3, 1, 2),
                                 crop, crop)
        valid = label != cfg.dataset.ignore_index
        loss = _masked_ce(seg_hw, label, valid, reduce)
        hits, n = ((seg_hw.argmax(dim=1) == label) & valid).sum(), valid.sum()
        if dp:
            loss_sum, hits, n = reduce(torch.stack([
                loss.detach(), hits.float(), n.float()])).unbind(0)
            return loss, SegMetrics(loss_sum, hits / n.clamp_min(1))
        return loss, SegMetrics(loss.detach(), (hits / n.clamp_min(1)).float())

    def train_step(state: TrainState, frozen, batch: weclip.Batch, label: torch.Tensor,
                   rng: Optional[int] = None) -> Tuple[TrainState, SegMetrics]:
        gen = None if rng is None else step_generator(rng, state.step, batch.img.device)
        with torch.enable_grad():
            loss, metrics = loss_fn(state.params, frozen, batch, label.long(), gen)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        if dp:
            all_reduce_grads(param_leaves(state.params), mesh.data_group)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return state, metrics

    return train_step
