"""MS COCO 2014 datasets in the VOC-style layout (port of
weclip_tpu/data/coco.py).

Images are ``<root>/JPEGImages/{train,val}/COCO_*_*.jpg`` and labels
``<root>/SegmentationClass/{train,val}/<name>.png``, where the label name
drops the ``COCO_train2014_`` or ``COCO_val2014_`` prefix.  Grayscale
images are promoted to RGB.  PIL is imported only where an image is read.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Optional

import numpy as np

from weclip_tpu_torch.core.config import DatasetConfig
from weclip_tpu_torch.data import transforms
from weclip_tpu_torch.data.voc import class_set_from_label, load_name_list
from weclip_tpu_torch.utils.imutils import promote_rgb


def _strip(name: str, split: str) -> str:
    return name[15:] if "train" in split else name[13:]


class CocoBase:
    def __init__(self, cfg: DatasetConfig, split: str):
        self.cfg = cfg
        self.split = split
        sub = "train" if "train" in split else "val"
        self.img_dir = os.path.join(cfg.root_dir, "JPEGImages", sub)
        self.label_dir = os.path.join(cfg.root_dir, "SegmentationClass", sub)
        self.names = load_name_list(os.path.join(cfg.name_list_dir, split + ".txt"))
        p = os.path.join(cfg.name_list_dir, "cls_labels_onehot.npy")
        self.cls_labels = np.load(p, allow_pickle=True).item() if os.path.exists(p) else {}

    def __len__(self):
        return len(self.names)

    def read_image(self, name: str) -> np.ndarray:
        from PIL import Image
        return promote_rgb(np.asarray(Image.open(os.path.join(self.img_dir, name + ".jpg"))))

    def read_label(self, name: str) -> np.ndarray:
        from PIL import Image
        p = os.path.join(self.label_dir, _strip(name, self.split) + ".png")
        if os.path.exists(p):
            return np.asarray(Image.open(p))
        # a split without labels: an all-ignore label at the image's size
        return np.full(self.read_image(name).shape[:2], 255, np.uint8)


class CocoClsDataset(CocoBase):
    """Training dataset, augmented as ``voc.VOCClsDataset``."""

    def __init__(self, cfg: DatasetConfig, split: str = "train", seed: Optional[int] = None):
        super().__init__(cfg, split)
        self.rng = random.Random(seed)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.get_example(idx, self.rng)

    def get_example(self, idx: int, rng) -> Dict[str, np.ndarray]:
        name = self.names[idx]
        image = np.asarray(self.read_image(name))
        image = transforms.random_scaling(image, self.cfg.rescale_range, rng=rng)
        image = transforms.random_fliplr(image, rng=rng)
        image, img_box = transforms.random_crop(
            image, self.cfg.crop_size, ignore_index=self.cfg.ignore_index, rng=rng)
        image = transforms.normalize_img(image, np.asarray(self.cfg.mean, np.float32),
                                         np.asarray(self.cfg.std, np.float32))
        present = class_set_from_label(self.read_label(name), self.cfg.num_classes - 1)
        out = {
            "name": name,
            "img": np.transpose(image, (2, 0, 1)).astype(np.float32),
            "img_box": img_box,
            "present_mask": present,
        }
        if name in self.cls_labels:
            out["cls_label"] = np.asarray(self.cls_labels[name], np.uint8)
        return out


class CocoSegDataset(CocoBase):
    """Evaluation dataset: full-size uint8 image and label."""

    def __init__(self, cfg: DatasetConfig, split: str = "val", stage: str = "val"):
        super().__init__(cfg, split)
        self.stage = stage

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        name = self.names[idx]
        image = self.read_image(name).astype(np.float32)
        label = self.read_label(name).astype(np.int32)
        return {
            "name": name,
            "img_raw": image.astype(np.uint8),
            "label": label,
            "present_mask": class_set_from_label(label, self.cfg.num_classes - 1),
        }
