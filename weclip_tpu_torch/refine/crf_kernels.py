"""K7, the windowed bilateral message of the mean-field CRF (csrc/crf.cu),
and its plain PyTorch twin.

The JAX package computes this sum as an XLA ``fori_loop`` over the window
offsets (weclip_tpu/refine/crf.py, ``mean_field_crf_jax``'s windowed
branch); no ``pallas_call`` stands behind it.  ``window_message`` given CPU
tensors runs the twin, ``window_message_plain``, which is that offset loop
written in PyTorch; given CUDA tensors it launches the kernel or raises.

Both keep the reference's edge rule: the neighbour is read rolled,
``q[(y - dy) mod hs, (x - dx) mod ws]``, but masked by whether
``(y + dy, x + dx)`` lies in the grid, so within r of an edge wrapped
pixels are summed and real neighbours dropped (ROADMAP.md §3).  The kernel
states the rule in virtual source coordinates: sy_v = y - dy reads row
sy_v mod hs and counts iff |y - sy_v| <= r and 2y - hs < sy_v <= 2y
(columns alike), so a tile of pixels reads a halo with modular addressing
and multiplies it on the tensor cores (csrc/crf.cu).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from weclip_tpu_torch import kernels


def window_message_plain(q: Optional[torch.Tensor], img: torch.Tensor, sig: float,
                         r: int) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(acc (B, C, hs, ws) or None, norm (B, 1, hs, ws)): the window sum of
    ``exp(-0.5 (dist^2 / sig^2 + |img_p - img_s|^2)) * inb`` times ``q``
    (B, C, hs, ws), and of the weight alone; ``img`` (B, 3, hs, ws), already
    divided by the colour sigma.  ``q`` None computes the normalizer only."""
    b, _, hs, ws = img.shape
    dev = img.device
    ys = torch.arange(hs, device=dev)[:, None]
    xs = torch.arange(ws, device=dev)[None, :]
    acc = None if q is None else torch.zeros_like(q)
    norm = torch.zeros((b, 1, hs, ws), dtype=torch.float32, device=dev)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            img_sh = torch.roll(img, (dy, dx), (-2, -1))
            dist2 = torch.tensor(float(dy * dy + dx * dx), dtype=torch.float32,
                                 device=dev) / (sig * sig)
            cd2 = torch.sum((img - img_sh) ** 2, dim=1, keepdim=True)
            inb = ((ys + dy >= 0) & (ys + dy < hs) & (xs + dx >= 0) & (xs + dx < ws))
            k = torch.exp(-0.5 * (dist2 + cd2)) * inb
            if acc is not None:
                acc = acc + torch.roll(q, (dy, dx), (-2, -1)) * k
            norm = norm + k
    return acc, norm


def window_message(q: Optional[torch.Tensor], img: torch.Tensor, sig: float,
                   r: int) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """K7 on CUDA tensors, ``window_message_plain`` on CPU ones."""
    if not img.is_cuda:
        return window_message_plain(q, img, sig, r)
    b, c3, hs, ws = img.shape
    tensors = [img] if q is None else [q, img]
    for t in tensors:
        if t.device != img.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"window_message: expected contiguous fp32 tensors on "
                             f"{img.device}, got {t.dtype} on {t.device}")
    if c3 != 3:
        raise ValueError(f"window_message: expected a 3-channel image, got {c3}")
    c = 0 if q is None else q.shape[1]
    if q is not None and tuple(q.shape) != (b, c, hs, ws):
        raise ValueError(f"window_message: q {tuple(q.shape)} != {(b, c, hs, ws)}")
    acc = None if q is None else torch.empty_like(q)
    norm = torch.empty((b, 1, hs, ws), dtype=torch.float32, device=img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.call("crf", "crf_window", None if q is None else q.data_ptr(),
                     img.data_ptr(), None if acc is None else acc.data_ptr(),
                     norm.data_ptr(), b, c, hs, ws, r, sig * sig, stream)
    kernels.launches["crf_window"] += 1
    return acc, norm


GEOMETRY_FIELDS = ("n_tiles", "halo_cols", "unit_cols", "row_stride", "units_per_row",
                   "smem_bytes")


def window_geometry(c: int, hs: int, ws: int, r: int) -> Dict[str, int]:
    """The launch ``window_message`` makes for C channels (0: the
    normalizer alone) on an (hs, ws) grid at radius r, as csrc/crf.cu picks
    it: n-tiles of 8 channel columns (the ones column included), halo
    columns a block reads, columns a staged unit holds, their row stride in
    shared memory, units a source row, and dynamic shared memory in bytes.
    Needs the built kernel library (nvcc), not a card."""
    out = (ctypes.c_int * len(GEOMETRY_FIELDS))()
    kernels.call("crf", "crf_window_geometry", c, hs, ws, r, ctypes.addressof(out))
    return dict(zip(GEOMETRY_FIELDS, out))
