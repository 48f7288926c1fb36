"""Fully supervised VOC training of the seg variant (port of
weclip_tpu/cli/train_voc_seg.py): the heads trained on ground-truth masks
with train/seg_step.py, checkpoints every ``train.eval_iters`` steps past
``train.ckpt_start_iter`` and at the end, ``--resume`` from the latest.

Usage:
    python -m weclip_tpu_torch.cli.train_voc_seg --config configs/voc.yaml
    torchrun --nproc_per_node N -m weclip_tpu_torch.cli.train_voc_seg ...

Under ``torchrun`` each of the ``mesh.data_parallel`` data ranks reads its
own shard at ``samples_per_gpu`` images, the ranks of a model group
(``mesh.model_parallel``) the same one against their slices of the frozen
MLPs (parallel/mesh.py); rank 0 writes the checkpoints and the log.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from weclip_tpu_torch.cli import common
from weclip_tpu_torch.data.voc import VOCBase

log = logging.getLogger("weclip_tpu_torch")


class VOCSegTrainDataset(VOCBase):
    """Ground-truth supervised crops: flip, photometric distortion and crop
    with the label, then ImageNet normalization."""

    def __getitem__(self, idx):
        return self.get_example(idx, None)

    def get_example(self, idx, rng):
        from weclip_tpu_torch.data import transforms
        name = self.names[idx]
        image = np.asarray(self.read_image(name), np.float32)
        label = np.asarray(self.read_label(name), np.float32)
        image, label = transforms.random_fliplr(image, label, rng=rng)
        image = transforms.PhotoMetricDistortion()(image, rng=rng).astype(np.float32)
        image, label, _ = transforms.random_crop(
            image, self.cfg.crop_size, label, ignore_index=self.cfg.ignore_index, rng=rng)
        image = transforms.normalize_img(image)
        return {"img": np.transpose(image, (2, 0, 1)).astype(np.float32),
                "label": label.astype(np.int32),
                "present_mask": np.zeros(self.cfg.num_classes - 1, bool)}


def main(argv=None):
    args = common.train_parser().parse_args(argv)
    cfg = common.load_train_config(args, "voc")

    from weclip_tpu_torch.core import precision
    from weclip_tpu_torch.data.loader import PrefetchLoader
    from weclip_tpu_torch.parallel import mesh as meshlib
    from weclip_tpu_torch.train import checkpoint
    from weclip_tpu_torch.train.seg_step import create_seg_train_state, make_seg_train_step
    from weclip_tpu_torch.train.trainer import build_frozen, make_batcher, save_checkpoint

    mesh = meshlib.make_mesh(cfg.mesh.data_parallel, cfg.mesh.model_parallel)
    device = meshlib.local_device(args.device)
    policy = precision.make_policy(cfg.precision.compute_dtype)
    frozen, _, cfg = build_frozen(cfg, device=device)
    frozen = meshlib.shard_model(mesh, frozen)
    ckpt_dir = os.path.join(cfg.work_dir.dir, cfg.work_dir.ckpt_dir)
    params, saved, start = None, None, 0
    if args.resume and checkpoint.latest_step(ckpt_dir) is not None:
        params, saved, start = checkpoint.restore(ckpt_dir, device=device)
        log.info("resumed from step %d", start)
    state = create_seg_train_state(torch.Generator().manual_seed(cfg.train.seed), cfg,
                                   device, params=params)
    if saved is not None:
        state.optimizer.load_state_dict(saved["optimizer"])
        state.scheduler.load_state_dict(saved["scheduler"])
    state.step = start
    step_fn = make_seg_train_step(cfg, policy, mesh)
    to_device = make_batcher(cfg, frozen, device)
    loader = PrefetchLoader(VOCSegTrainDataset(cfg.dataset, cfg.train.split),
                            cfg.train.samples_per_gpu, seed=cfg.train.seed, start=start,
                            process_index=mesh.data_rank, process_count=mesh.data)
    lead = mesh.rank == 0
    try:
        for n_iter in range(start, cfg.train.max_iters):
            hb = next(loader)
            batch, _, _ = to_device(hb)
            label = torch.from_numpy(hb["label"]).to(device)
            state, m = step_fn(state, frozen, batch, label, rng=cfg.train.seed + 1)
            if lead and (n_iter + 1) % cfg.train.log_iters == 0:
                log.info("iter %d: loss %.4f acc %.4f", n_iter + 1, float(m.loss),
                         float(m.acc))
            if ((n_iter + 1) % cfg.train.eval_iters == 0
                    and n_iter + 1 > cfg.train.ckpt_start_iter):
                save_checkpoint(ckpt_dir, n_iter + 1, state, lead)
    finally:
        loader.close()
    save_checkpoint(ckpt_dir, cfg.train.max_iters, state, lead)
    return state


if __name__ == "__main__":
    main()
