"""Image helpers (port of the parts of weclip_tpu/utils/imutils.py that the
inference and evaluation paths read): grayscale promotion, the VOC palette
and prediction PNGs, written without an image package."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def promote_rgb(img: np.ndarray) -> np.ndarray:
    """Promote grayscale to 3-channel and drop any alpha channel."""
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[..., :3]


def colormap(n: int = 256) -> np.ndarray:
    """The VOC palette: bit k of each of a class id's 3-bit groups sets
    bit 7 - k of its red, green and blue."""
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= (c & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


_CMAP = colormap()


def encode_cmap(label: np.ndarray) -> np.ndarray:
    """Class-id mask -> (H, W, 3) uint8 RGB in the VOC palette."""
    return _CMAP[np.asarray(label, np.int64) % 256]


def write_png(path: str, arr: np.ndarray) -> None:
    """An (H, W) or (H, W, 3) uint8 array as an 8-bit grayscale or RGB PNG,
    with the standard library's zlib (no image package needed)."""
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w = arr.shape[:2]
    color = 2 if arr.ndim == 3 else 0

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


def save_prediction(path: str, pred: np.ndarray, cmap: bool = False) -> None:
    """A class-id mask as an 8-bit grayscale PNG, or in the VOC palette."""
    write_png(path, encode_cmap(pred) if cmap else np.asarray(pred, np.uint8))
