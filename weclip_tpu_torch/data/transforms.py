"""Host-side image transforms in numpy (port of weclip_tpu/data/transforms.py).

- normalization with the ImageNet statistics on 0..255 pixels;
- random rescale with PIL bilinear (nearest for labels);
- random horizontal flip;
- random crop: zero padding up to the crop size, up to 10 tries for a crop
  box in which no class holds 75% of the labelled pixels, and the box of the
  valid (unpadded) region, ``img_box``;
- ``PhotoMetricDistortion``: brightness, contrast, saturation and hue
  jitter through cv2.

Every draw comes from the caller's ``random.Random`` in the JAX package's
order, so one seed gives the same augmentation in both packages.  PIL and
cv2 are imported inside the functions that use them.
"""

from __future__ import annotations

import random
from typing import Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.asarray([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.asarray([58.395, 57.12, 57.375], np.float32)


def normalize_img(img: np.ndarray, mean: np.ndarray = IMAGENET_MEAN,
                  std: np.ndarray = IMAGENET_STD) -> np.ndarray:
    return ((np.asarray(img, np.float32) - mean) / std).astype(np.float32)


def rescale(image: np.ndarray, scale: float, label: Optional[np.ndarray] = None):
    """PIL bilinear image and nearest label resize to ``scale`` times the
    size.  uint8 stays uint8; other input is resized as uint8 and returned
    as float32."""
    from PIL import Image
    h, w = image.shape[:2]
    new_size = (int(scale * w), int(scale * h))
    src = image if image.dtype == np.uint8 else image.astype(np.uint8)
    im = np.asarray(Image.fromarray(src).resize(new_size, Image.BILINEAR))
    if image.dtype != np.uint8:
        im = im.astype(np.float32)
    if label is None:
        return im
    lb = Image.fromarray(label).resize(new_size, Image.NEAREST)
    return im, np.asarray(lb)


def random_scaling(image: np.ndarray, scale_range: Tuple[float, float],
                   label: Optional[np.ndarray] = None,
                   rng: Optional[random.Random] = None):
    r = rng or random
    return rescale(image, r.uniform(*scale_range), label)


def random_fliplr(image: np.ndarray, label: Optional[np.ndarray] = None,
                  rng: Optional[random.Random] = None):
    r = rng or random
    flip = r.random() > 0.5
    if label is None:
        return np.fliplr(image) if flip else image
    if flip:
        return np.fliplr(image), np.fliplr(label)
    return image, label


def random_crop(image: np.ndarray, crop_size: int, label: Optional[np.ndarray] = None,
                ignore_index: int = 255, cat_max_ratio: float = 0.75,
                rng: Optional[random.Random] = None):
    """Zero-pad to at least ``crop_size``, then crop; returns the crop, its
    label crop where a label is given, and ``img_box`` (top, bottom, left,
    right) of the valid region inside the crop."""
    r = rng or random
    h, w = image.shape[:2]
    big_h, big_w = max(crop_size, h), max(crop_size, w)
    pad_img = np.zeros((big_h, big_w, 3),
                       image.dtype if image.dtype == np.uint8 else np.float32)
    # the pad offsets come from the same rng as the crop offsets
    h_pad = r.randrange(0, big_h - h + 1)
    w_pad = r.randrange(0, big_w - w + 1)
    pad_img[h_pad:h_pad + h, w_pad:w_pad + w] = image

    pad_label = None
    if label is not None:
        pad_label = np.full((big_h, big_w), ignore_index, np.float32)
        pad_label[h_pad:h_pad + h, w_pad:w_pad + w] = label

    h0 = w0 = 0
    for _ in range(10):
        h0 = r.randrange(0, big_h - crop_size + 1)
        w0 = r.randrange(0, big_w - crop_size + 1)
        if pad_label is None:
            break
        tmp = pad_label[h0:h0 + crop_size, w0:w0 + crop_size]
        index, cnt = np.unique(tmp, return_counts=True)
        cnt = cnt[index != ignore_index]
        if len(cnt) > 1 and np.max(cnt) / np.sum(cnt) < cat_max_ratio:
            break

    img = pad_img[h0:h0 + crop_size, w0:w0 + crop_size]
    img_box = np.asarray([max(h_pad - h0, 0), min(h0 + crop_size, h_pad + h) - h0,
                          max(w_pad - w0, 0), min(w0 + crop_size, w_pad + w) - w0],
                         np.int16)
    if label is None:
        return img, img_box
    return img, pad_label[h0:h0 + crop_size, w0:w0 + crop_size], img_box


class PhotoMetricDistortion:
    """Brightness, contrast, saturation and hue jitter (the mmseg
    transform).  The HSV round trips convert the RGB array as if it were
    BGR, as the original does."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_lower, self.contrast_upper = contrast_range
        self.saturation_lower, self.saturation_upper = saturation_range
        self.hue_delta = hue_delta

    @staticmethod
    def _convert(img, alpha=1.0, beta=0.0):
        img = img.astype(np.float32) * alpha + beta
        return np.clip(img, 0, 255).astype(np.uint8)

    def __call__(self, img: np.ndarray, rng: Optional[random.Random] = None) -> np.ndarray:
        """Without ``rng`` the draws come from the global ``random`` and
        ``numpy.random`` streams."""
        import cv2
        coin = ((lambda: rng.getrandbits(1)) if rng is not None
                else (lambda: int(np.random.randint(2))))
        uni = rng.uniform if rng is not None else random.uniform
        irand = ((lambda a, b: rng.randint(a, b - 1)) if rng is not None
                 else (lambda a, b: int(np.random.randint(a, b))))
        img = img.astype(np.uint8)
        if coin():
            img = self._convert(img, beta=uni(-self.brightness_delta,
                                              self.brightness_delta))
        mode = coin()
        if mode == 1 and coin():
            img = self._convert(img, alpha=uni(self.contrast_lower, self.contrast_upper))
        if coin():
            hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
            hsv[:, :, 1] = self._convert(hsv[:, :, 1], alpha=uni(
                self.saturation_lower, self.saturation_upper))
            img = cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)
        if coin():
            hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
            hsv[:, :, 0] = (hsv[:, :, 0].astype(int)
                            + irand(-self.hue_delta, self.hue_delta)) % 180
            img = cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)
        if mode == 0 and coin():
            img = self._convert(img, alpha=uni(self.contrast_lower, self.contrast_upper))
        return img
