"""COCO msc-flip evaluation entry point (port of weclip_tpu/cli/eval_coco.py).
COCO validation runs segmentation only, without the CAM chain.

Usage:
    python -m weclip_tpu_torch.cli.eval_coco --config configs/coco.yaml \
        --model_path <checkpoint dir>
"""

from __future__ import annotations

from weclip_tpu_torch.cli import common
from weclip_tpu_torch.cli.eval_voc import run_eval


def main(argv=None):
    args = common.eval_parser().parse_args(argv)
    common.setup_logger()
    return run_eval(common.load_eval_config(args, "coco"), args, "coco")


if __name__ == "__main__":
    main()
