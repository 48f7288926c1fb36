"""VOC msc-flip evaluation entry point (port of weclip_tpu/cli/eval_voc.py).

Usage:
    python -m weclip_tpu_torch.cli.eval_voc --config configs/voc.yaml \
        --model_path <checkpoint dir> [--save_preds] [--save_logits] \
        [--crf [--crf_impl native|jax] [--crf_stride 4]]
    torchrun --nproc_per_node N -m weclip_tpu_torch.cli.eval_voc ... --mesh N

The frozen CLIP and class text features come from ``clip.pretrained_path``
(train/trainer.py::build_frozen); ``--model_path`` takes the port's
checkpoints and the JAX package's Orbax ones.
"""

from __future__ import annotations

import logging

import torch

from weclip_tpu_torch.cli import common

log = logging.getLogger("weclip_tpu_torch")


def load_eval_model(cfg, args, device: str):
    """(frozen, params, cfg) on ``device``: ``build_frozen``, then the
    trained parameters of ``--model_path`` (randomly initialized heads
    without one)."""
    from weclip_tpu_torch.models import weclip
    from weclip_tpu_torch.train import checkpoint
    from weclip_tpu_torch.train.trainer import build_frozen

    frozen, _, cfg = build_frozen(cfg, device=device)
    params = weclip.init_trainable_params(torch.Generator().manual_seed(0), cfg, device)
    if args.model_path:
        params, _, step = checkpoint.restore(args.model_path, device=device)
        log.info("restored step %d from %s", step, args.model_path)
    else:
        log.warning("no --model_path: evaluating randomly initialized heads")
    return frozen, params, cfg


def run_eval(cfg, args, dataset_name: str, with_cam: bool = None):
    """Msc-flip evaluation of ``args.eval_set``: the scores dict of
    ``Evaluator.run`` (``cam`` with the CAM chain, which VOC runs and COCO,
    whose validation is segmentation only, does not)."""
    from weclip_tpu_torch.core import precision
    from weclip_tpu_torch.evalx.runner import Evaluator, make_prep

    from weclip_tpu_torch.parallel.mesh import shard_model

    mesh, device = common.build_eval_mesh(args, cfg)
    policy = precision.make_policy(cfg.precision.compute_dtype)
    frozen, params, cfg = load_eval_model(cfg, args, device)
    frozen = shard_model(mesh, frozen)
    if dataset_name == "coco":
        from weclip_tpu_torch.data.coco import CocoSegDataset
        ds = CocoSegDataset(cfg.dataset, split=args.eval_set)
        max_ori = 640
    else:
        from weclip_tpu_torch.data.voc import VOCSegDataset
        ds = VOCSegDataset(cfg.dataset, split=args.eval_set,
                           stage="test" if "test" in args.eval_set else "val")
        max_ori = 512
    if with_cam is None:
        with_cam = dataset_name == "voc"
    prep = make_prep(cfg, max_ori=max_ori, resize_long=args.resize_long)
    pe = frozen["visual"]["positional_embedding"].float().cpu().numpy()
    ev = Evaluator(cfg, prep, pe, policy=policy, with_cam=with_cam, msc=True,
                   device=device)
    scores = ev.run(params, frozen, ds, max_images=args.max_images, progress=True,
                    crf=args.crf, crf_impl=args.crf_impl, crf_stride=args.crf_stride,
                    save_dir=args.work_dir if args.save_preds else None,
                    logits_dir=args.work_dir if args.save_logits else None)
    if "cam" in scores:
        log.info("cams score:\n%s", scores["cam"])
    log.info("segs score:\n%s", scores["seg"])
    log.info("msc segs score:\n%s", scores["msc_seg"])
    if "crf_seg" in scores:
        log.info("crf segs score:\n%s", scores["crf_seg"])
    return scores


def main(argv=None):
    args = common.eval_parser().parse_args(argv)
    common.setup_logger()
    return run_eval(common.load_eval_config(args, "voc"), args, "voc")


if __name__ == "__main__":
    main()
