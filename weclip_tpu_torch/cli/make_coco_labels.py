"""Rebuild COCO's image-level one-hot labels from the segmentation PNGs
(ids 1..80; 0 background, 255 ignore), in VOC's blob format (port of
weclip_tpu/cli/make_coco_labels.py).

Usage:
    python -m weclip_tpu_torch.cli.make_coco_labels \
        --root /data/coco2014 --name_list_dir /data/weclip/datasets/coco
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from weclip_tpu_torch.cli.make_voc_labels import onehot_of_label
from weclip_tpu_torch.data.coco import _strip


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--name_list_dir", required=True)
    p.add_argument("--num_classes", default=81, type=int)
    args = p.parse_args(argv)

    out = {}
    for split in ("train", "val"):
        lst = os.path.join(args.name_list_dir, split + ".txt")
        if not os.path.exists(lst):
            continue
        with open(lst) as f:
            names = [x.strip() for x in f if x.strip()]
        for name in names:
            path = os.path.join(args.root, "SegmentationClass", split,
                                _strip(name, split) + ".png")
            out[name] = onehot_of_label(path, args.num_classes)
        print(f"{split}: {len(names)} images")

    dst = os.path.join(args.name_list_dir, "cls_labels_onehot.npy")
    np.save(dst, out)
    print("wrote", dst)


if __name__ == "__main__":
    main()
