"""The training step: forward -> pseudo labels -> losses -> update (port of
weclip_tpu/train/step.py).

The JAX package jits the whole step and returns a new state; here the step
runs eagerly and updates the state's parameters in place through its
optimizer.  Only the trainable tree (the heads, and CoMer where enabled)
carries gradients: the frozen ViT forward runs without them, and GradCAM's
own backward (inside the pseudo-label chain) takes gradients of block 11's
input alone, so its graph never joins the loss's.

Each call is a ``train.step`` of the program's span recorder
(utils/spans.py): the forward's stages (``backbone``, ``heads``, ``comer``,
``chain.*``, models/weclip.py), ``loss``, ``backward`` and ``optimizer``,
with the loader's ``input.wait`` and the batcher's ``input.batch`` before
it.

Data parallel (``mesh`` of more than one data rank, parallel/mesh.py):
each data rank runs its slice of the global batch.  The losses' counts are
summed over the data group first (train/losses.py), so each rank's loss is
its share of the global-batch loss; the gradients are then summed over the
data group, and every rank takes the update one process would take over
the whole batch, as the JAX package's GSPMD step does.  The dropout masks
are drawn for the global batch, each data rank taking its rows; the
metrics are global.

Tensor parallel (``mesh.model`` > 1): the ranks of a model group run the
same rows against their shards of the frozen MLPs (``shard_model``), whose
outputs are summed over the group inside the forward.  Every activation
after that sum is replicated, so the ranks of a model group hold identical
trainable gradients and need no reduction of them: a mesh of data 1 and
model 2 reduces no gradient at all.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from weclip_tpu_torch.core import precision
from weclip_tpu_torch.core.config import Config, crop_grid
from weclip_tpu_torch.models import weclip
from weclip_tpu_torch.models.clip import vit
from weclip_tpu_torch.ops.resize import resize_bilinear
from weclip_tpu_torch.parallel import mesh as meshlib
from weclip_tpu_torch.train import losses
from weclip_tpu_torch.train.optimizer import make_optimizer
from weclip_tpu_torch.utils import spans


@dataclasses.dataclass
class TrainState:
    params: Dict[str, Any]
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    seg_loss: torch.Tensor
    attn_loss: torch.Tensor
    pseudo_acc: torch.Tensor   # share of pixels where argmax(seg) == pseudo label


def param_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict/list parameter tree, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in tree for t in param_leaves(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in param_leaves(v)]
    return [tree]


def create_train_state(gen: torch.Generator, cfg: Config, device="cuda",
                       params: Optional[Dict[str, Any]] = None) -> TrainState:
    """Fresh trainable parameters from ``gen`` (or copies of ``params``)
    on ``device``, and their optimizer at step 0."""
    if params is None:
        params = weclip.init_trainable_params(gen, cfg, device)
    else:
        params = weclip.tree_to(params, device)
        params = vit.tree_map(lambda t: t.detach().clone(), params)
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    opt, sched = make_optimizer(leaves, cfg.optimizer, cfg.train.max_iters)
    return TrainState(params, opt, sched, 0)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of one step, seeded from (seed, step)."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step) % (2 ** 63))


def train_losses(cfg: Config, out: weclip.ForwardOutputs, pseudo: torch.Tensor,
                 rmask: torch.Tensor, reduce: losses.Reduce = None
                 ) -> Tuple[torch.Tensor, StepMetrics]:
    """The step's loss on the forward's outputs against pseudo labels
    ``pseudo`` (B, H, W): the segmentation loss on the crop-size upsampled
    logits plus ``attn_loss_weight`` times the affinity loss, whose labels
    use the (hw, hw) neighbourhood ``rmask``.  With ``reduce`` (a sum over
    data-parallel ranks) the loss is this rank's share of the global-batch
    loss and the metrics are global."""
    crop = cfg.dataset.crop_size
    g = crop_grid(cfg)
    b = out.seg.shape[0]
    seg_hw = resize_bilinear(out.seg.reshape(b, g, g, -1).permute(0, 3, 1, 2),
                             crop, crop)                          # (B, K, H, W)
    sloss = losses.seg_loss(seg_hw, pseudo, cfg.dataset.ignore_index, reduce)
    aff_label = losses.cams_to_affinity_label(
        pseudo, rmask, cfg.dataset.ignore_index, cfg.clip.patch_size)
    aloss, _, _ = losses.aff_loss(out.attn_pred, aff_label, reduce)
    total = sloss + cfg.train.attn_loss_weight * aloss
    hit = (seg_hw.argmax(dim=1) == pseudo).float()
    if reduce is None:
        return total, StepMetrics(total.detach(), sloss.detach(), aloss.detach(),
                                  hit.mean())
    # one collective: the three loss shares, the hits and the pixel count
    t, sl, al, hits, n = reduce(torch.stack([
        total.detach(), sloss.detach(), aloss.detach(), hit.sum(),
        torch.tensor(float(hit.numel()), device=hit.device)])).unbind(0)
    return total, StepMetrics(t, sl, al, hits / n)


def make_loss_fn(cfg: Config, policy: precision.Policy = precision.DEFAULT,
                 mesh: Optional[meshlib.Mesh] = None):
    """Returns ``loss_fn(params, frozen, batch, require_seg_trans, gen,
    cls_idx, cls_active, pseudo=None) -> (total loss, StepMetrics)``: the
    training forward, then ``train_losses`` against its own detached pseudo
    labels, or against ``pseudo`` (B, H, W) where given.  Over a
    data-parallel ``mesh``, ``batch`` is this rank's slice of the global
    batch (every rank the same size) and the loss its share."""
    dp = meshlib.dp_only(mesh)
    reduce = functools.partial(meshlib.psum, group=mesh.data_group) if dp else None
    g = crop_grid(cfg)
    rmask_np = losses.radius_mask(g, g, cfg.train.radius)
    rmasks: Dict[Any, torch.Tensor] = {}

    def loss_fn(params, frozen, batch: weclip.Batch, require_seg_trans, gen,
                cls_idx, cls_active, pseudo: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, StepMetrics]:
        b = batch.img.shape[0]
        rows = (mesh.data_rank * b, mesh.data * b) if dp else None
        out = weclip.forward_train(params, frozen, batch, cfg, require_seg_trans,
                                   gen, policy, cls_idx=cls_idx,
                                   cls_active=cls_active, batch_rows=rows)
        dev = out.seg.device
        if dev not in rmasks:
            rmasks[dev] = torch.from_numpy(rmask_np).to(dev)
        labels = out.cam_labels.detach() if pseudo is None else pseudo
        with spans.span("loss"):
            return train_losses(cfg, out, labels, rmasks[dev], reduce)

    return loss_fn


def all_reduce_grads(leaves: List[torch.Tensor], group=None) -> None:
    """Sum the gradients of ``leaves`` over the ranks of ``group`` (default:
    every rank), in place, as one flat buffer (one collective)."""
    grads = [t.grad for t in leaves if t.grad is not None]
    if not grads:
        return
    flat = meshlib.psum(torch.cat([g.reshape(-1) for g in grads]), group)
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))


def make_train_step(cfg: Config, policy: precision.Policy = precision.DEFAULT,
                    mesh: Optional[meshlib.Mesh] = None):
    """Returns ``train_step(state, frozen, batch, rng=None, cls_idx=None,
    cls_active=None, extra_iter_num=0, pseudo=None) -> (state,
    StepMetrics)``.

    ``rng``: an integer seed for the step's dropout generator, or None to
    train with dropout off.  ``extra_iter_num`` counts forwards outside
    training (validation) that advance the seg-trans gate, as the reference
    does.  ``pseudo``: labels (B, H, W) to train against in place of the
    forward's own, so that steps on two devices can be held to the same
    labels.  Metrics are detached device scalars.  ``mesh``: the ranks (see
    the module docstring); ``batch`` is this rank's slice, and ``frozen``
    is sharded over the mesh's model axis where it has one
    (``meshlib.shard_model``)."""
    loss_fn = make_loss_fn(cfg, policy, mesh)
    dp = meshlib.dp_only(mesh)

    def train_step(state: TrainState, frozen, batch: weclip.Batch,
                   rng: Optional[int] = None, cls_idx=None, cls_active=None,
                   extra_iter_num: int = 0, pseudo: Optional[torch.Tensor] = None
                   ) -> Tuple[TrainState, StepMetrics]:
        with spans.step("train.step"):
            require_seg_trans = (state.step + 1 + extra_iter_num) > cfg.train.seg_trans_start_iter
            gen = (None if rng is None
                   else step_generator(rng, state.step, batch.img.device))
            with torch.enable_grad():
                total, metrics = loss_fn(state.params, frozen, batch, require_seg_trans,
                                         gen, cls_idx, cls_active, pseudo)
                with spans.span("backward"):
                    state.optimizer.zero_grad(set_to_none=True)
                    total.backward()
            with spans.span("optimizer"):
                if dp:
                    all_reduce_grads(param_leaves(state.params), mesh.data_group)
                state.optimizer.step()
                state.scheduler.step()
            state.step += 1
            return state, metrics

    return train_step
