"""Iteration-based training loop (port of weclip_tpu/train/trainer.py).

Batches come from ``data/loader.py::PrefetchLoader``: a fresh permutation
of the dataset per epoch from ``numpy.random.default_rng(train.seed)``,
incomplete batches dropped, per-item augmentation seeds.  Each step compacts
its batch's present classes into a bucket (core/compaction.py).  Every
``train.eval_iters`` steps the loop saves a checkpoint (past
``train.ckpt_start_iter``) and validates on ``val_dataset`` where one is
given; it saves a last checkpoint at the end.  Each validation advances the
seg-trans gate by ``len(val_dataset)``, as the reference's shared forward
counter does.  ``resume`` continues from the latest checkpoint: parameters,
optimizer and scheduler state, the step, the validation count, and the data
stream at the batch an uninterrupted run would read next (the JAX trainer
restarts the stream), so a resumed run computes what an uninterrupted one
does.

``build_frozen`` gives the frozen state: the CLIP checkpoint at
``clip.pretrained_path`` with the class prompts encoded by its text tower,
or random weights where there is none.  Each logged window also goes to
``work_dir.dir/work_dir.tb_logger_dir/scalars.jsonl`` (utils/tb.py), and
``profile_steps`` traces a range of steps with ``torch.profiler`` into
``work_dir.dir/profile``: ``trace.json`` (a Chrome trace, the program's
stages as its top-level host events) and ``spans.json`` (the recorder's
records of the traced steps, utils/spans.py: host time by stage, host
syncs by stage and source line, kernel launches by kernel and shape).

Under ``torchrun`` (``mesh.data_parallel`` x ``mesh.model_parallel``
ranks, parallel/mesh.py) every data rank reads its own shard of each epoch
at ``samples_per_gpu`` images, so the global batch is ``samples_per_gpu``
times the data width, and the step reduces the losses' counts and the
gradients over the data group (train/step.py).  The ranks of a model group
read the same shard and hold their slices of the frozen MLPs
(``shard_model``).  Rank 0 alone writes checkpoints, scalars, logs and
profiles, and the ranks meet at a barrier after each checkpoint; every rank
resumes from it, and validation sums its histograms over the data group.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from weclip_tpu_torch.core import precision
from weclip_tpu_torch.core.compaction import compact_classes, pick_bucket
from weclip_tpu_torch.core.config import Config, crop_grid
from weclip_tpu_torch.data.loader import PrefetchLoader
from weclip_tpu_torch.models import weclip
from weclip_tpu_torch.models.clip import loader as clip_loader
from weclip_tpu_torch.models.clip import prompts
from weclip_tpu_torch.models.clip.vit import pos_emb_host
from weclip_tpu_torch.parallel import mesh as meshlib
from weclip_tpu_torch.train import checkpoint
from weclip_tpu_torch.train import step as step_mod
from weclip_tpu_torch.utils import spans

log = logging.getLogger("weclip_tpu_torch")


def build_frozen(cfg: Config, rng_seed: int = 0, device="cuda"):
    """(frozen, clip_params, cfg) on ``device``.

    With a checkpoint at ``cfg.clip.pretrained_path`` (a file, or a name or
    URL ``clip/loader.py`` fetches): its weights, the clip config taken from
    its shapes, and the class text features of ``cfg.dataset.name``'s prompt
    tables encoded by its text tower (the tokenizer's merges file from
    ``WECLIP_BPE_PATH``).  Without one: ``weclip.random_frozen_state`` of
    ``rng_seed``, with a warning; ``clip_params`` then holds the vision
    tower and the logit scale only."""
    if torch.device(device).type == "cuda":
        precision.strict_matmul()
    path = cfg.clip.pretrained_path
    if clip_loader.is_fetchable(path) or (path and os.path.exists(path)):
        from weclip_tpu_torch.models.clip.tokenizer import Tokenizer
        clip_params, clip_cfg = clip_loader.load_clip(
            path, cfg.clip, expected_sha256=cfg.clip.pretrained_sha256, device=device)
        cfg = dataclasses.replace(cfg, clip=clip_cfg)
        fg, bg = prompts.build_text_features(
            cfg.dataset.name, clip_params["text"], cfg.clip, Tokenizer(),
            template=cfg.clip.prompt_template)
        frozen = weclip.build_frozen_state(clip_params["visual"], clip_params["logit_scale"],
                                           fg, bg, device)
    else:
        log.warning("no CLIP checkpoint at %r — random init (dev only)", path)
        frozen = weclip.random_frozen_state(cfg, seed=rng_seed, device=device)
        clip_params = {"visual": frozen["visual"], "logit_scale": frozen["logit_scale"]}
    return frozen, clip_params, cfg


def make_batcher(cfg: Config, frozen: Dict, device,
                 mesh: Optional[meshlib.Mesh] = None
                 ) -> Callable[[Dict[str, np.ndarray]],
                               Tuple[weclip.Batch, torch.Tensor, torch.Tensor]]:
    """Returns ``to_device(host_batch) -> (batch, cls_idx, cls_active)``:
    host arrays of full square crops -> a ``weclip.Batch`` on ``device``
    (the positional embedding at the crop's grid, every token valid), and
    the batch's present classes compacted into the smallest class bucket
    that holds them (core/compaction.py); over a data-parallel ``mesh``,
    the largest bucket of any rank, so the ranks agree on one."""
    grid = crop_grid(cfg)
    pe_table = frozen["visual"]["positional_embedding"].float().cpu().numpy()
    pos_emb = torch.from_numpy(pos_emb_host(pe_table, grid, grid, grid, grid))[None].to(device)
    num_fg = cfg.dataset.num_classes - 1
    buckets = tuple(b for b in (4, 8, 16) if b < num_fg) + (num_fg,)
    dev = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def to_device(host_batch):
        with spans.span("input.batch"):
            b = host_batch["img"].shape[0]
            batch = weclip.Batch(
                img=dev(host_batch["img"].astype(np.float32)), pos_emb=pos_emb,
                valid=torch.ones((b, grid * grid + 1), dtype=torch.bool, device=device),
                gh=torch.full((b,), grid, device=device),
                gw=torch.full((b,), grid, device=device),
                present_mask=dev(host_batch["present_mask"]).bool())
            present = host_batch["present_mask"]
            mc = pick_bucket(present, buckets)
            if meshlib.dp_only(mesh):
                mc = int(meshlib.pmax(torch.tensor(mc)))
            ci, ca = compact_classes(present, mc)
            return batch, dev(ci), dev(ca)

    return to_device


def build_dataset(cfg: Config):
    """The training dataset of ``cfg.dataset`` (VOC or COCO layout)."""
    if cfg.dataset.name == "coco":
        from weclip_tpu_torch.data.coco import CocoClsDataset
        return CocoClsDataset(cfg.dataset, cfg.train.split, seed=cfg.train.seed)
    from weclip_tpu_torch.data.voc import VOCClsDataset
    return VOCClsDataset(cfg.dataset, cfg.train.split, seed=cfg.train.seed)


def train(cfg: Config, dataset=None, max_steps: Optional[int] = None, device="cuda",
          frozen: Optional[Dict] = None, resume: bool = False,
          val_dataset=None, profile_steps: Optional[Tuple[int, int]] = None
          ) -> step_mod.TrainState:
    """Train the heads (and CoMer where enabled) to step ``max_steps``
    (default ``train.max_iters``).  ``dataset``: examples with ``img``
    ((3, crop, crop) float32, normalized) and ``present_mask`` ((C_fg,)
    bool), by default the training split of ``cfg.dataset``; ``val_dataset``:
    examples as ``evalx/runner.py::Evaluator.run`` reads them.  ``frozen``
    defaults to ``build_frozen(cfg, train.seed)``.
    Checkpoints go to ``work_dir.dir/work_dir.ckpt_dir``.  Logs the window
    means of the losses and the pseudo-label accuracy every
    ``train.log_iters`` steps, and the validation scores.
    ``profile_steps=(start, end)`` traces steps start..end into
    ``work_dir.dir/profile/trace.json`` and writes their span records to
    ``spans.json`` beside it."""
    pc = cfg.precision
    policy = precision.make_policy(pc.compute_dtype, pc.param_dtype, pc.softmax_dtype)
    mesh = meshlib.make_mesh(cfg.mesh.data_parallel, cfg.mesh.model_parallel)
    lead = mesh.rank == 0
    device = meshlib.local_device(device)
    if torch.device(device).type == "cuda":
        precision.strict_matmul()
    if frozen is None:
        frozen, _, cfg = build_frozen(cfg, cfg.train.seed, device=device)
    frozen = meshlib.shard_model(mesh, frozen)
    if dataset is None:
        dataset = build_dataset(cfg)
    ckpt_dir = os.path.join(cfg.work_dir.dir, cfg.work_dir.ckpt_dir)
    params = None
    val_forward_calls = 0
    if resume and checkpoint.latest_step(ckpt_dir) is not None:
        params, saved, step0 = checkpoint.restore(ckpt_dir, device=device)
    state = step_mod.create_train_state(
        torch.Generator().manual_seed(cfg.train.seed), cfg, device, params=params)
    if params is not None:
        state.optimizer.load_state_dict(saved["optimizer"])
        state.scheduler.load_state_dict(saved["scheduler"])
        state.step = step0
        if val_dataset is not None:
            val_forward_calls = (step0 // cfg.train.eval_iters) * len(val_dataset)
        log.info("resumed from step %d", step0)
    step_fn = step_mod.make_train_step(cfg, policy, mesh)
    to_device = make_batcher(cfg, frozen, device, mesh)

    bsz = cfg.train.samples_per_gpu
    total = max_steps or cfg.train.max_iters
    loader = PrefetchLoader(dataset, bsz, seed=cfg.train.seed, start=state.step,
                            process_index=mesh.data_rank, process_count=mesh.data)
    if lead:
        log.info("global batch %d (%d per rank x %d data ranks; model width %d)",
                 bsz * mesh.data, bsz, mesh.data, mesh.model)
    from weclip_tpu_torch.utils.tb import ScalarWriter
    writer = (ScalarWriter(os.path.join(cfg.work_dir.dir, cfg.work_dir.tb_logger_dir))
              if lead else None)
    prof, spans_from = None, 0
    msum, n_window, t_window = None, 0, time.perf_counter()
    try:
        for n_iter in range(state.step, total):
            if lead and profile_steps and n_iter == profile_steps[0]:
                prof, spans_from = _start_profile(device), spans.RECORDER.closed
            batch, ci, ca = to_device(next(loader))
            state, m = step_fn(state, frozen, batch, rng=cfg.train.seed + 1,
                               cls_idx=ci, cls_active=ca,
                               extra_iter_num=val_forward_calls)
            msum = m if msum is None else step_mod.StepMetrics(
                *(a + b for a, b in zip(msum, m)))
            n_window += 1
            if prof is not None and n_iter == profile_steps[1]:
                prof = _stop_profile(prof, cfg.work_dir.dir, spans_from)
            if lead and ((n_iter + 1) % cfg.train.log_iters == 0 or n_iter + 1 == total):
                means = step_mod.StepMetrics(*(float(x) / n_window for x in msum))
                rate = n_window * bsz * mesh.data / (time.perf_counter() - t_window)
                log.info("iter %d/%d; img/s %.2f; loss %.4f; seg_loss %.4f; "
                         "attn_loss %.4f; pseudo_acc %.4f", n_iter + 1, total, rate,
                         *means)
                writer.add_scalars("train", {
                    "seg_loss": means.seg_loss, "attn_loss": means.attn_loss,
                    "pseudo_mAcc": means.pseudo_acc, "imgs_per_sec": rate,
                }, n_iter + 1)
                msum, n_window, t_window = None, 0, time.perf_counter()
            if (n_iter + 1) % cfg.train.eval_iters == 0:
                if n_iter + 1 > cfg.train.ckpt_start_iter:
                    save_checkpoint(ckpt_dir, n_iter + 1, state, lead)
                if val_dataset is not None:
                    scores = validate(cfg, state.params, frozen, val_dataset, policy,
                                      device=device)
                    if lead:
                        log.info("val seg: %s", scores["seg"])
                        log.info("val cam: %s", scores["cam"])
                    val_forward_calls += len(val_dataset)
    finally:
        loader.close()
        if writer is not None:
            writer.close()
        if prof is not None:
            _stop_profile(prof, cfg.work_dir.dir, spans_from)
    save_checkpoint(ckpt_dir, total, state, lead)
    return state


def save_checkpoint(ckpt_dir: str, step: int, state: step_mod.TrainState, lead: bool) -> None:
    """Rank 0 saves the state; every rank waits until it is written."""
    if lead:
        log.info("saved %s", checkpoint.save(ckpt_dir, step, state.params,
                                             state.optimizer, state.scheduler))
    meshlib.barrier()


def _start_profile(device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, work_dir: str, spans_from: int) -> None:
    """Stops the trace and writes it as ``<work_dir>/profile/trace.json``
    (a Chrome trace), and the recorder's records closed since it had closed
    ``spans_from`` that the profiler saw as ``spans.json``; returns None."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    spans.RECORDER.notice()
    out = os.path.join(work_dir, "profile")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
    with open(os.path.join(out, "spans.json"), "w") as f:
        json.dump([r.to_json() for r in spans.profiled(spans.RECORDER.since(spans_from))],
                  f, indent=1)
    log.info("profile written to %s", out)
    return None


def validate(cfg: Config, params, frozen, val_dataset, policy: precision.Policy,
             max_images: Optional[int] = None, device="cuda"):
    """Training-time validation: the original-size, single-scale forward
    with the CAM chain, scored for the segmentation and the CAM labels
    (``Evaluator.run``'s dict); images up to 512 pixels (VOC) or 640
    (COCO)."""
    from weclip_tpu_torch.evalx.runner import Evaluator, make_prep
    max_ori = 512 if cfg.dataset.name == "voc" else 640
    prep = make_prep(cfg, max_ori=max_ori, resize_long=None)
    pe = frozen["visual"]["positional_embedding"].float().cpu().numpy()
    ev = Evaluator(cfg, prep, pe, policy=policy, with_cam=True, msc=False,
                   device=str(torch.device(device)))
    return ev.run(params, frozen, val_dataset, max_images=max_images)
