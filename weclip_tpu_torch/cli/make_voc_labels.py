"""Rebuild VOC's image-level one-hot labels (``cls_labels_onehot.npy``:
name -> (num_fg,) float32, foreground index = class id - 1) and missing
split lists from a VOCdevkit checkout (port of
weclip_tpu/cli/make_voc_labels.py).

Usage:
    python -m weclip_tpu_torch.cli.make_voc_labels \
        --root /data/VOCdevkit/VOC2012 --name_list_dir /data/weclip/datasets/voc
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def onehot_of_label(path: str, num_classes: int) -> np.ndarray:
    """The class set of a label PNG (0 background and 255 ignore left out)
    as a (num_classes - 1,) float32 one-hot."""
    from PIL import Image
    lab = np.asarray(Image.open(path))
    onehot = np.zeros(num_classes - 1, np.float32)
    ids = np.unique(lab)
    ids = ids[(ids != 0) & (ids != 255)]
    onehot[ids - 1] = 1
    return onehot


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--name_list_dir", required=True)
    p.add_argument("--num_classes", default=21, type=int)
    p.add_argument("--splits", default="train_aug,train,val,trainval",
                   help="comma-separated split txt files to scan")
    args = p.parse_args(argv)

    os.makedirs(args.name_list_dir, exist_ok=True)
    names = set()
    for split in args.splits.split(","):
        lst = os.path.join(args.name_list_dir, split + ".txt")
        if not os.path.exists(lst):
            # derive a missing list from the VOC ImageSets
            src = os.path.join(args.root, "ImageSets", "Segmentation", split + ".txt")
            if not os.path.exists(src):
                continue
            with open(src) as f:
                content = f.read()
            with open(lst, "w") as f:
                f.write(content)
        with open(lst) as f:
            names.update(x.strip() for x in f if x.strip())

    out = {}
    for name in sorted(names):
        path = os.path.join(args.root, "SegmentationClassAug", name + ".png")
        if not os.path.exists(path):
            path = os.path.join(args.root, "SegmentationClass", name + ".png")
        out[name] = onehot_of_label(path, args.num_classes)
    dst = os.path.join(args.name_list_dir, "cls_labels_onehot.npy")
    np.save(dst, out)
    print(f"wrote {dst} ({len(out)} images)")


if __name__ == "__main__":
    main()
