"""Offline CAM generation (port of weclip_tpu/cli/generate_cams.py): one
``<name>.npy`` per image holding ``{"keys": present class ids,
"attn_highres": (len(keys), H, W) float16}``, the refined CAMs of
cam/highres.py at the original size.

Usage:
    python -m weclip_tpu_torch.cli.generate_cams --config configs/voc.yaml \
        --split train_aug --out cams/

Under ``torchrun --nproc_per_node N ... --mesh N`` each of the D = N /
``mesh.model_parallel`` data ranks computes the strided shard
``range(n)[data_rank::D]`` of the images with its model group, whose first
rank writes it.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from weclip_tpu_torch.cam.variants import METHODS
from weclip_tpu_torch.cli import common

log = logging.getLogger("weclip_tpu_torch")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None, type=str)
    p.add_argument("--split", default="train_aug", type=str)
    p.add_argument("--out", default="cams", type=str)
    p.add_argument("--resize_long", default=512, type=int)
    p.add_argument("--max_images", default=None, type=int)
    p.add_argument("--cam_method", default="grad_cam", type=str, choices=list(METHODS),
                   help="CAM method (the reference's live path is grad_cam)")
    common.add_mesh_arg(p)
    common.add_device_arg(p)
    args = p.parse_args(argv)
    common.setup_logger()

    from weclip_tpu_torch.cam.highres import make_cam_program
    from weclip_tpu_torch.core import precision
    from weclip_tpu_torch.core.config import Config, load_config
    from weclip_tpu_torch.evalx.runner import Evaluator, make_prep
    from weclip_tpu_torch.parallel.mesh import shard_model
    from weclip_tpu_torch.train.trainer import build_frozen

    cfg = load_config(args.config) if args.config else Config()
    mesh, device = common.build_eval_mesh(args, cfg)
    frozen, _, cfg = build_frozen(cfg, device=device)
    frozen = shard_model(mesh, frozen)
    policy = precision.make_policy(cfg.precision.compute_dtype)
    if cfg.dataset.name == "coco":
        from weclip_tpu_torch.data.coco import CocoSegDataset as DS
    else:
        from weclip_tpu_torch.data.voc import VOCSegDataset as DS
    ds = DS(cfg.dataset, split=args.split, stage="train")
    prep = make_prep(cfg, max_ori=640 if cfg.dataset.name == "coco" else 512,
                     resize_long=args.resize_long)
    pe = frozen["visual"]["positional_embedding"].float().cpu().numpy()
    ev = Evaluator(cfg, prep, pe, policy=policy, with_cam=True, msc=False,
                   device=device)
    cams_for_batch = make_cam_program(cfg, prep, policy, method=args.cam_method)

    os.makedirs(args.out, exist_ok=True)
    bsz = cfg.eval.batch_images
    n = len(ds) if args.max_images is None else min(len(ds), args.max_images)
    # a model group computes its shard together; its first rank writes
    mine = list(range(n))[mesh.data_rank::mesh.data]
    writes = mesh.model_rank == 0
    for s in range(0, len(mine), bsz):
        examples = [ds[i] for i in mine[s:s + bsz]]
        n_real = len(examples)
        while len(examples) < bsz:
            examples.append(examples[-1])
        sb1, _, sizes, _, presents, _, _ = ev.build_batch(examples)
        highres = cams_for_batch(frozen, sb1, presents, sizes).float().cpu().numpy()
        for ex, cams in zip(examples[:n_real] if writes else [], highres):
            oh, ow = ex["label"].shape
            keys = np.where(np.asarray(ex["present_mask"]))[0]
            np.save(os.path.join(args.out, ex["name"] + ".npy"),
                    {"keys": keys,
                     "attn_highres": cams[keys, :oh, :ow].astype(np.float16)})
        log.info("%d / %d", min(s + bsz, len(mine)), len(mine))


if __name__ == "__main__":
    main()
