"""VOC training entry point (port of weclip_tpu/cli/train_voc.py).

Usage:
    python -m weclip_tpu_torch.cli.train_voc --config configs/voc.yaml [--resume]

Validates on the ``train`` split every ``train.eval_iters`` steps where its
files exist.
"""

from __future__ import annotations

from weclip_tpu_torch.cli import common


def main(argv=None):
    args = common.train_parser().parse_args(argv)
    cfg = common.load_train_config(args, "voc")

    from weclip_tpu_torch.data.voc import VOCSegDataset
    from weclip_tpu_torch.train.trainer import train
    val = None
    try:
        val = VOCSegDataset(cfg.dataset, split="train", stage="train")
    except (FileNotFoundError, OSError):
        pass
    return train(cfg, resume=args.resume, val_dataset=val, device=args.device,
                 profile_steps=common.parse_profile(args.profile))


if __name__ == "__main__":
    main()
