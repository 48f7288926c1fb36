"""Image helpers (port of weclip_tpu/utils/imutils.py): grayscale
promotion, the VOC palette, denormalization, prediction PNGs written
without an image package, and the TensorBoard grid renderers.

The renderers take and return numpy arrays.  They tile with numpy and
resize with the port's bilinear resize on the CPU; matplotlib gives the
jet/viridis colour maps where it imports, else a closed-form jet stands in
for both (the JAX package's rule)."""

from __future__ import annotations

import struct
import zlib
from typing import List, Sequence, Tuple

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


def denormalize_img(img: np.ndarray,
                    mean=(123.675, 116.28, 103.53),
                    std=(58.395, 57.12, 57.375)) -> np.ndarray:
    """(..., 3, H, W) normalized -> uint8 RGB."""
    arr = np.asarray(img, np.float32)
    out = arr * np.asarray(std, np.float32)[:, None, None] \
        + np.asarray(mean, np.float32)[:, None, None]
    return np.clip(out, 0, 255).astype(np.uint8)


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


# ---------------------------------------------------------------------------
# TensorBoard grid renderers
# ---------------------------------------------------------------------------

def _apply_cmap(x: np.ndarray, name: str) -> np.ndarray:
    """(..., H, W) in [0, 1] -> (..., H, W, 3) float RGB in [0, 255]:
    matplotlib's ``name`` map, or without matplotlib a closed-form jet."""
    try:
        import matplotlib
        rgb = matplotlib.colormaps[name](np.asarray(x, np.float32))[..., :3]
        return rgb * 255.0
    except (ImportError, AttributeError):
        v = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
        r = np.clip(1.5 - np.abs(4 * v - 3), 0, 1)
        g = np.clip(1.5 - np.abs(4 * v - 2), 0, 1)
        b = np.clip(1.5 - np.abs(4 * v - 1), 0, 1)
        return np.stack([r, g, b], -1) * 255.0


def _resize_chw(x: np.ndarray, h: int, w: int,
                align_corners: bool = False) -> np.ndarray:
    """(B, C, H, W) bilinear resize on the CPU (ops/resize.py)."""
    import torch

    from weclip_tpu_torch.ops.resize import resize_bilinear
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return resize_bilinear(t, h, w, align_corners=align_corners).numpy()


def make_grid(imgs: np.ndarray, nrow: int = 2, padding: int = 2) -> np.ndarray:
    """(B, 3, H, W) uint8 -> one (3, H', W') uint8 tile grid, ``nrow``
    images a row (torchvision's ``make_grid`` layout)."""
    b, c, h, w = imgs.shape
    nrows = (b + nrow - 1) // nrow
    grid = np.zeros((c, nrows * (h + padding) + padding,
                     nrow * (w + padding) + padding), np.uint8)
    for i in range(b):
        r, cc = divmod(i, nrow)
        y = padding + r * (h + padding)
        x = padding + cc * (w + padding)
        grid[:, y:y + h, x:x + w] = imgs[i]
    return grid


def tensorboard_image(imgs: np.ndarray, cam: np.ndarray,
                      nrow: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """The denormalized image grid and the grid of jet CAM overlays.
    imgs: (B, 3, H, W) normalized; cam: (B, C, h, w) CAM scores."""
    _imgs = np.stack([denormalize_img(im) for im in imgs])
    cam_up = _resize_chw(np.asarray(cam, np.float32), _imgs.shape[2], _imgs.shape[3])
    heat = _apply_cmap(cam_up.max(axis=1), "jet")            # (B, H, W, 3)
    blend = heat.transpose(0, 3, 1, 2) * 0.5 + _imgs * 0.5
    return (make_grid(_imgs, nrow),
            make_grid(np.clip(blend, 0, 255).astype(np.uint8), nrow))


def tensorboard_edge(edge: np.ndarray, n_row: int = 2,
                     size: Tuple[int, int] = (224, 224)) -> np.ndarray:
    """Viridis-coloured grid of (B, 1, h, w) edge or score maps."""
    e = _resize_chw(np.asarray(edge, np.float32), *size)[:, 0]
    heat = _apply_cmap(e, "viridis").transpose(0, 3, 1, 2)
    return make_grid(heat.astype(np.uint8), n_row)


def tensorboard_attn(attns: Sequence[np.ndarray],
                     size: Tuple[int, int] = (224, 224),
                     n_pix: float = 0.0, n_row: int = 4) -> np.ndarray:
    """For each (B, HW, HW) attention: the row of the pixel at relative
    position ``n_pix`` as an (h, w) map, upsampled (align_corners),
    min-max normalized per image, viridis-coloured; all tiled."""
    tiles: List[np.ndarray] = []
    for attn in attns:
        b, hw, _ = attn.shape
        h = w = int(np.sqrt(hw))
        row = int(h * n_pix) * (w + 1)
        a = np.asarray(attn[:, row, :], np.float32).reshape(b, 1, h, w)
        a = _resize_chw(a, *size, align_corners=True)[:, 0]
        a = a - a.min(axis=(1, 2), keepdims=True)
        a = a / np.maximum(a.max(axis=(1, 2), keepdims=True), 1e-12)
        tiles.append(_apply_cmap(a, "viridis").transpose(0, 3, 1, 2))
    return make_grid(np.concatenate(tiles, axis=0).astype(np.uint8), n_row)


def tensorboard_attn2(attns: Sequence[np.ndarray],
                      size: Tuple[int, int] = (224, 224),
                      n_pixs: Sequence[float] = (0.0, 0.3, 0.6, 0.9),
                      n_row: int = 4,
                      with_attn_pred: bool = True) -> List[np.ndarray]:
    """``tensorboard_attn`` at each relative pixel of ``n_pixs``, for the
    top layers (with the predicted affinity last where
    ``with_attn_pred``) and then the last two layers."""
    if with_attn_pred:
        top, last = list(attns[:-3]) + [attns[-1]], list(attns[-3:-1])
    else:
        top, last = list(attns[:-2]), list(attns[-2:])
    grids = [tensorboard_attn(top, size, p, n_row) for p in n_pixs]
    grids += [tensorboard_attn(last, size, p, 2 * n_row) for p in n_pixs]
    return grids


def tensorboard_label(labels: np.ndarray, nrow: int = 2) -> np.ndarray:
    """Grid of (B, H, W) or (H, W) class-id masks in the VOC palette."""
    lab = np.asarray(labels)
    if lab.ndim == 2:
        lab = lab[None]
    rgb = np.stack([encode_cmap(l) for l in lab]).transpose(0, 3, 1, 2)
    return make_grid(rgb, nrow)
