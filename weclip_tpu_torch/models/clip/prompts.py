"""Class-name prompt tables and the zero-shot text embeddings (port
of weclip_tpu/models/clip/prompts.py).

The tables are the reference's own strings, synonyms included: pseudo-label
quality depends on them.  The text encoder runs once at start-up; the
(num_classes, embed_dim) tables it gives are constants afterwards.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from weclip_tpu_torch.core.config import ClipConfig
from weclip_tpu_torch.models.clip import vit
from weclip_tpu_torch.models.clip.tokenizer import Tokenizer, tokenize

BACKGROUND_CATEGORY_VOC: List[str] = [
    'ground', 'land', 'grass', 'tree', 'building', 'wall', 'sky', 'lake',
    'water', 'river', 'sea', 'railway', 'railroad', 'keyboard', 'helmet',
    'cloud', 'house', 'mountain', 'ocean', 'road', 'rock', 'street',
    'valley', 'bridge', 'sign',
]

CLASS_NAMES_VOC: List[str] = [
    'aeroplane', 'bicycle', 'bird', 'boat', 'bottle',
    'bus', 'car', 'cat', 'chair', 'cow',
    'diningtable', 'dog', 'horse', 'motorbike', 'person',
    'pottedplant', 'sheep', 'sofa', 'train', 'tvmonitor',
]

NEW_CLASS_NAMES_VOC: List[str] = [
    'aeroplane', 'bicycle', 'bird avian', 'boat', 'bottle',
    'bus', 'car', 'cat', 'chair seat', 'cow',
    'diningtable', 'dog', 'horse', 'motorbike',
    'person with clothes,people,human',
    'pottedplant', 'sheep', 'sofa', 'train', 'tvmonitor screen',
]

CLASS_NAMES_COCO: List[str] = [
    'person', 'bicycle', 'car', 'motorbike', 'aeroplane',
    'bus', 'train', 'truck', 'boat', 'traffic light',
    'fire hydrant', 'stop sign', 'parking meter', 'bench', 'bird',
    'cat', 'dog', 'horse', 'sheep', 'cow',
    'elephant', 'bear', 'zebra', 'giraffe', 'backpack',
    'umbrella', 'handbag', 'tie', 'suitcase', 'frisbee',
    'skis', 'snowboard', 'sports ball', 'kite', 'baseball bat',
    'baseball glove', 'skateboard', 'surfboard', 'tennis racket', 'bottle',
    'wine glass', 'cup', 'fork', 'knife', 'spoon',
    'bowl', 'banana', 'apple', 'sandwich', 'orange',
    'broccoli', 'carrot', 'hot dog', 'pizza', 'donut',
    'cake', 'chair', 'sofa', 'pottedplant', 'bed',
    'diningtable', 'toilet', 'tvmonitor', 'laptop', 'mouse',
    'remote', 'keyboard', 'cell phone', 'microwave', 'oven',
    'toaster', 'sink', 'refrigerator', 'book', 'clock',
    'vase', 'scissors', 'teddy bear', 'hair drier', 'toothbrush',
]

NEW_CLASS_NAMES_COCO: List[str] = [
    'person with clothes,people,human', 'bicycle', 'car', 'motorbike', 'aeroplane',
    'bus', 'train', 'truck', 'boat', 'traffic light',
    'fire hydrant', 'stop sign', 'parking meter', 'bench', 'bird avian',
    'cat', 'dog', 'horse', 'sheep', 'cow',
    'elephant', 'bear', 'zebra', 'giraffe', 'backpack,bag',
    'umbrella,parasol', 'handbag,purse', 'necktie', 'suitcase', 'frisbee',
    'skis', 'sknowboard', 'sports ball', 'kite', 'baseball bat',
    'glove', 'skateboard', 'surfboard', 'tennis racket', 'bottle',
    'wine glass', 'cup', 'fork', 'knife', 'dessertspoon',
    'bowl', 'banana', 'apple', 'sandwich', 'orange',
    'broccoli', 'carrot', 'hot dog', 'pizza', 'donut',
    'cake', 'chair seat', 'sofa', 'pottedplant', 'bed',
    'diningtable', 'toilet', 'tvmonitor screen', 'laptop', 'mouse',
    'remote control', 'keyboard', 'cell phone', 'microwave', 'oven',
    'toaster', 'sink', 'refrigerator', 'book', 'clock',
    'vase', 'scissors', 'teddy bear', 'hairdrier,blowdrier', 'toothbrush',
]

BACKGROUND_CATEGORY_COCO: List[str] = [
    'ground', 'land', 'grass', 'tree', 'building', 'wall', 'sky', 'lake',
    'water', 'river', 'sea', 'railway', 'railroad', 'helmet',
    'cloud', 'house', 'mountain', 'ocean', 'road', 'rock', 'street',
    'valley', 'bridge',
]


def class_tables(dataset: str) -> Tuple[List[str], List[str]]:
    """(fg_names, bg_names) for a dataset key."""
    if dataset == "voc":
        return NEW_CLASS_NAMES_VOC, BACKGROUND_CATEGORY_VOC
    if dataset == "coco":
        return NEW_CLASS_NAMES_COCO, BACKGROUND_CATEGORY_COCO
    raise ValueError(dataset)


def zeroshot_classifier(classnames: Sequence[str], templates: Sequence[str],
                        text_params, cfg: ClipConfig,
                        tokenizer: Tokenizer) -> np.ndarray:
    """Per class, the L2-normalized mean of its L2-normalized prompt
    embeddings: (num_classes, embed_dim) fp32.  Every prompt of every class
    goes through the encoder in one batch (each row depends on its own
    tokens only)."""
    toks = tokenize([t.format(name) for name in classnames for t in templates],
                    tokenizer, cfg.context_length)
    emb = vit.encode_text(text_params, toks, cfg)
    emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    mean = emb.reshape(len(classnames), len(templates), -1).mean(dim=1)
    mean = mean / torch.linalg.vector_norm(mean, dim=-1, keepdim=True)
    return mean.cpu().numpy().astype(np.float32)


def build_text_features(dataset: str, text_params, cfg: ClipConfig,
                        tokenizer: Tokenizer,
                        template: str = "a clean origami {}."):
    """(fg_features (C_fg, E), bg_features (C_bg, E)) fp32 numpy."""
    fg_names, bg_names = class_tables(dataset)
    fg = zeroshot_classifier(fg_names, [template], text_params, cfg, tokenizer)
    bg = zeroshot_classifier(bg_names, [template], text_params, cfg, tokenizer)
    return fg, bg
