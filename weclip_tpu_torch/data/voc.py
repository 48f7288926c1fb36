"""PASCAL VOC 2012 (aug) datasets, host-side numpy (port of
weclip_tpu/data/voc.py).

Name lists come from ``<name_list_dir>/<split>.txt``, images from
``JPEGImages``, labels from ``SegmentationClassAug`` and image-level one-hot
labels from ``cls_labels_onehot.npy``.  Each example carries its class set
as a ``present_mask`` computed once from its label.  PIL is imported only
where an image is decoded, so a tree already in the decoded cache needs none.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Optional

import numpy as np

from weclip_tpu_torch.core.config import DatasetConfig
from weclip_tpu_torch.data import transforms

CLASS_NAMES_VOC = [
    'aeroplane', 'bicycle', 'bird', 'boat', 'bottle',
    'bus', 'car', 'cat', 'chair', 'cow',
    'diningtable', 'dog', 'horse', 'motorbike', 'person',
    'pottedplant', 'sheep', 'sofa', 'train', 'tvmonitor',
]


def load_name_list(path: str):
    with open(path) as f:
        return [x.strip() for x in f.read().split("\n") if x.strip()]


def load_cls_labels(name_list_dir: str) -> Dict[str, np.ndarray]:
    return np.load(os.path.join(name_list_dir, "cls_labels_onehot.npy"),
                   allow_pickle=True).item()


def class_set_from_label(label: np.ndarray, num_fg: int) -> np.ndarray:
    """The image-level class set of a label map, as a (num_fg,) bool mask.

    Class ids are taken as ``unique(label) - 1`` in uint8, so background 0
    wraps to 255 and ignore 255 to 254, and both drop out: background never
    joins the class set.  Ids at or past ``num_fg`` are dropped too."""
    ids = np.unique(np.asarray(label).astype(np.uint8)) - np.uint8(1)
    ids = ids[(ids != 254) & (ids != 255)].astype(np.int64)
    mask = np.zeros(num_fg, bool)
    mask[ids[ids < num_fg]] = True
    return mask


class VOCBase:
    def __init__(self, cfg: DatasetConfig, split: str, cache_dir: Optional[str] = None):
        self.cfg = cfg
        self.split = split
        self.img_dir = os.path.join(cfg.root_dir, "JPEGImages")
        self.label_dir = os.path.join(cfg.root_dir, "SegmentationClassAug")
        self.names = load_name_list(os.path.join(cfg.name_list_dir, split + ".txt"))
        self.cls_labels = load_cls_labels(cfg.name_list_dir)
        # decoded images and labels as .npy, written at first read and
        # memory-mapped after
        self.cache_dir = cache_dir or cfg.decoded_cache_dir
        if self.cache_dir:
            os.makedirs(self.cache_dir, exist_ok=True)

    def __len__(self):
        return len(self.names)

    def read_image(self, name: str) -> np.ndarray:
        if self.cache_dir:
            p = os.path.join(self.cache_dir, name + ".npy")
            if os.path.exists(p):
                return np.load(p, mmap_mode="r")
        from PIL import Image
        img = np.asarray(Image.open(os.path.join(self.img_dir, name + ".jpg")).convert("RGB"))
        if self.cache_dir:
            np.save(os.path.join(self.cache_dir, name + ".npy"), img)
        return img

    def read_label(self, name: str) -> np.ndarray:
        if self.cache_dir:
            pc = os.path.join(self.cache_dir, name + "_lab.npy")
            if os.path.exists(pc):
                return np.load(pc, mmap_mode="r")
        from PIL import Image
        p = os.path.join(self.label_dir, name + ".png")
        if os.path.exists(p):
            lab = np.asarray(Image.open(p))
            if self.cache_dir:
                np.save(os.path.join(self.cache_dir, name + "_lab.npy"), lab)
            return lab
        # a split without labels (VOC test): an all-ignore label at the
        # image's size leaves the histograms empty
        with Image.open(os.path.join(self.img_dir, name + ".jpg")) as im:
            w, h = im.size
        return np.full((h, w), 255, np.uint8)


class VOCClsDataset(VOCBase):
    """Training dataset: random rescale, flip and crop with ``img_box``,
    then ImageNet normalization; CHW float32 output."""

    def __init__(self, cfg: DatasetConfig, split: str = "train_aug",
                 seed: Optional[int] = None):
        super().__init__(cfg, split)
        self.rng = random.Random(seed)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.get_example(idx, self.rng)

    def get_example(self, idx: int, rng) -> Dict[str, np.ndarray]:
        """Example ``idx`` augmented with draws from ``rng`` (the loader
        passes one per item, so augmentations do not depend on which thread
        loads which item)."""
        name = self.names[idx]
        # uint8 through scale, flip and crop; float only after the crop
        image = np.asarray(self.read_image(name))
        image = transforms.random_scaling(image, self.cfg.rescale_range, rng=rng)
        image = transforms.random_fliplr(image, rng=rng)
        image, img_box = transforms.random_crop(
            image, self.cfg.crop_size, ignore_index=self.cfg.ignore_index, rng=rng)
        image = transforms.normalize_img(image, np.asarray(self.cfg.mean, np.float32),
                                         np.asarray(self.cfg.std, np.float32))
        present = class_set_from_label(self.read_label(name), self.cfg.num_classes - 1)
        return {
            "name": name,
            "img": np.transpose(image, (2, 0, 1)).astype(np.float32),
            "cls_label": np.asarray(self.cls_labels[name], np.uint8),
            "img_box": img_box,
            "present_mask": present,
        }


class VOCSegDataset(VOCBase):
    """Evaluation dataset: the full-size uint8 image and its label, no
    augmentation (the evaluator normalizes on the device)."""

    def __init__(self, cfg: DatasetConfig, split: str = "val", stage: str = "val"):
        super().__init__(cfg, split)
        self.stage = stage

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        name = self.names[idx]
        image = self.read_image(name).astype(np.float32)
        if self.stage == "test":
            # no ground truth: an all-ignore label and no classes
            label = np.full(image.shape[:2], 255, np.int32)
            present = np.zeros(self.cfg.num_classes - 1, bool)
        else:
            label = self.read_label(name).astype(np.int32)
            present = class_set_from_label(label, self.cfg.num_classes - 1)
        return {
            "name": name,
            "img_raw": image.astype(np.uint8),
            "label": label,
            "cls_label": np.asarray(self.cls_labels.get(name, 0), np.uint8),
            "present_mask": present,
        }


def parse_xml_to_dict(node) -> dict:
    """A VOC annotation XML tree as a dict: repeated ``object`` tags collect
    into a list, leaves map tag -> text."""
    if len(node) == 0:
        return {node.tag: node.text}
    result: dict = {}
    for child in node:
        sub = parse_xml_to_dict(child)
        if child.tag != "object":
            result[child.tag] = sub[child.tag]
        else:
            result.setdefault(child.tag, []).append(sub[child.tag])
    return {node.tag: result}


def classes_from_xml(xml_path: str, num_fg: int = 20) -> np.ndarray:
    """Image-level one-hot labels from a VOC ``Annotations/*.xml`` file."""
    import xml.etree.ElementTree as ET
    d = parse_xml_to_dict(ET.parse(xml_path).getroot())["annotation"]
    onehot = np.zeros(num_fg, np.uint8)
    for obj in d.get("object", []):
        name = obj.get("name")
        if name in CLASS_NAMES_VOC:
            onehot[CLASS_NAMES_VOC.index(name)] = 1
    return onehot
