"""Image helpers (port of the parts of weclip_tpu/utils/imutils.py the
inference path reads)."""

from __future__ import annotations

import numpy as np


def promote_rgb(img: np.ndarray) -> np.ndarray:
    """Promote grayscale to 3-channel and drop any alpha channel."""
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[..., :3]
