"""COCO training entry point (port of weclip_tpu/cli/train_coco.py): 80k steps,
checkpoints past 40k, no validation during training.

Usage:
    python -m weclip_tpu_torch.cli.train_coco --config configs/coco.yaml
"""

from __future__ import annotations

from weclip_tpu_torch.cli import common


def main(argv=None):
    args = common.train_parser().parse_args(argv)
    cfg = common.load_train_config(args, "coco")
    from weclip_tpu_torch.train.trainer import train
    return train(cfg, resume=args.resume, val_dataset=None, device=args.device,
                 profile_steps=common.parse_profile(args.profile))


if __name__ == "__main__":
    main()
