"""Msc-flip evaluation of the fully supervised variant (port of
weclip_tpu/cli/eval_seg.py): segmentation only, no CAM chain.

Usage:
    python -m weclip_tpu_torch.cli.eval_seg --config configs/voc.yaml \
        --model_path <train_voc_seg checkpoint dir>
"""

from __future__ import annotations

from weclip_tpu_torch.cli import common
from weclip_tpu_torch.cli.eval_voc import run_eval


def main(argv=None):
    args = common.eval_parser().parse_args(argv)
    common.setup_logger()
    return run_eval(common.load_eval_config(args, "voc"), args, "voc", with_cam=False)


if __name__ == "__main__":
    main()
