"""Dense-CRF post-processing (port of weclip_tpu/refine/crf.py), two
implementations.

1. ``DenseCRF``: the exact permutohedral-lattice mean field of the port's
   own copy of ``native/permutohedral.cc``, run on the host through ctypes,
   as the JAX package runs it (the reference's pydensecrf path).
2. ``mean_field_crf``: the on-device mean field, the counterpart of
   ``mean_field_crf_jax``.  The spatial kernel is the exact separable
   Gaussian; the bilateral kernel is evaluated on a stride-``bi_stride``
   subsampled grid and resized back bilinearly, either as one dense
   (N, N) kernel matrix (``N <= dense_max_points``) or as the truncated
   window sum of K7 (refine/crf_kernels.py, csrc/crf.cu).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from weclip_tpu_torch.core import precision
from weclip_tpu_torch.core.config import CrfConfig
from weclip_tpu_torch.native.build import load
from weclip_tpu_torch.ops.resize import resize_bilinear
from weclip_tpu_torch.refine.crf_kernels import window_message


# ---------------------------------------------------------------------------
# native exact path
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DenseCRF:
    """Mean-field dense CRF on the permutohedral lattice (the reference's
    utils/dcrf.py parameters by default)."""
    iter_max: int = 10
    pos_xy_std: float = 3.0
    pos_w: float = 3.0
    bi_xy_std: float = 64.0
    bi_rgb_std: float = 5.0
    bi_w: float = 4.0

    def __call__(self, image: np.ndarray, probmap: np.ndarray) -> np.ndarray:
        """image: (H, W, 3) uint8 RGB; probmap: (C, H, W) softmax
        probabilities.  Returns the refined (C, H, W) float32."""
        c, h, w = probmap.shape
        q = np.ascontiguousarray(probmap.transpose(1, 2, 0).reshape(-1, c), np.float32)
        img = np.ascontiguousarray(image.reshape(-1, 3), np.uint8)
        load().dense_crf_inference(
            q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            h, w, c, self.iter_max, self.pos_xy_std, self.pos_w,
            self.bi_xy_std, self.bi_rgb_std, self.bi_w)
        return q.reshape(h, w, c).transpose(2, 0, 1)

    @classmethod
    def from_config(cls, cfg: CrfConfig) -> "DenseCRF":
        return cls(cfg.iter_max, cfg.pos_xy_std, cfg.pos_w,
                   cfg.bi_xy_std, cfg.bi_rgb_std, cfg.bi_w)


def permutohedral_filter(features: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Gaussian filter on the lattice: (n, d) features x (n, v) values ->
    (n, v)."""
    f = np.ascontiguousarray(features, np.float32)
    v = np.ascontiguousarray(values, np.float32)
    out = np.empty_like(v)
    n, d = f.shape
    fp = ctypes.POINTER(ctypes.c_float)
    load().permutohedral_filter(f.ctypes.data_as(fp), n, d, v.ctypes.data_as(fp),
                                v.shape[1], out.ctypes.data_as(fp))
    return out


def crf_inference(img: np.ndarray, probs: np.ndarray, t: int = 10,
                  scale_factor: float = 1.0, labels: int = 21) -> np.ndarray:
    """Image (H, W, 3) uint8 and (C, H, W) probabilities -> refined
    probabilities, with the reference crf_inference's own pairwise
    constants (Gaussian sxy 3/scale, compat 3; bilateral sxy 80/scale,
    srgb 13, compat 10)."""
    crf = DenseCRF(iter_max=t, pos_xy_std=3 / scale_factor, pos_w=3,
                   bi_xy_std=80 / scale_factor, bi_rgb_std=13, bi_w=10)
    return crf(img, probs[:labels])


def crf_inference_label(img: np.ndarray, labels_map: np.ndarray, t: int = 10,
                        n_labels: int = 21, gt_prob: float = 0.7) -> np.ndarray:
    """Hard-label unary: the unary of a label map at confidence
    ``gt_prob``, refined, argmax; constants of the reference
    crf_inference_label (Gaussian sxy 3, compat 3; bilateral sxy 50,
    srgb 5, compat 10)."""
    h, w = labels_map.shape
    probs = np.full((n_labels, h, w), (1.0 - gt_prob) / (n_labels - 1), np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    probs[labels_map.reshape(-1), ys.reshape(-1), xs.reshape(-1)] = gt_prob
    crf = DenseCRF(iter_max=t, pos_xy_std=3, pos_w=3, bi_xy_std=50, bi_rgb_std=5, bi_w=10)
    return crf(img, probs).argmax(0).astype(labels_map.dtype)


# ---------------------------------------------------------------------------
# on-device mean field
# ---------------------------------------------------------------------------

def _sep_gauss(x: torch.Tensor, sigma: float, radius: int) -> torch.Tensor:
    """Separable truncated spatial Gaussian over the last two axes of
    (..., H, W), zero-padded: two (2 radius + 1)-tap convolutions.  The
    JAX package writes it as two band-matrix products (TPU convolutions of
    one feature are slow); both compute the same sum, and at 640 pixels
    the band product does about 34 times the work of 19 taps."""
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=x.device)
    taps = torch.exp(-0.5 * (d / sigma) ** 2)
    shape = x.shape
    y = x.reshape(-1, 1, shape[-2], shape[-1])
    y = F.conv2d(y, taps.view(1, 1, -1, 1), padding=(radius, 0))
    y = F.conv2d(y, taps.view(1, 1, 1, -1), padding=(0, radius))
    return y.reshape(shape)


DENSE_BILATERAL_MAX_POINTS = 4096


def mean_field_crf(probs: torch.Tensor, image: torch.Tensor, cfg: CrfConfig,
                   bi_stride: int = 4,
                   dense_max_points: int = DENSE_BILATERAL_MAX_POINTS) -> torch.Tensor:
    """On-device mean field.  probs: (C, H, W) or (B, C, H, W); image:
    (3, H, W) or (B, 3, H, W) float 0..255.  Returns refined probabilities
    of probs' shape.

    The bilateral kernel lives on the stride-``bi_stride`` grid of
    hs x ws points.  Up to ``dense_max_points`` points it is the full
    untruncated kernel, one (N, N) matrix per image built from the Gram
    product of the centered 5-D features; above, the 2-sigma window sum of
    K7 (the reference's edge rule included)."""
    if probs.is_cuda:
        precision.strict_matmul()
    single = probs.dim() == 3
    if single:
        probs, image = probs[None], image[None]
    b, c, h, w = probs.shape
    dev = probs.device
    unary = -torch.log(torch.clamp(probs, min=1e-20))
    q = torch.softmax(-unary, dim=1)

    r_pos = max(int(round(3 * cfg.pos_xy_std)), 1)
    ones = torch.ones((1, 1, h, w), dtype=torch.float32, device=dev)
    norm_pos = torch.rsqrt(_sep_gauss(ones, cfg.pos_xy_std, r_pos) + 1e-20)

    hs, ws = h // bi_stride, w // bi_stride
    img_s = (resize_bilinear(image.float(), hs, ws) / cfg.bi_rgb_std).contiguous()
    sig_s = cfg.bi_xy_std / bi_stride

    if hs * ws <= dense_max_points:
        n = hs * ws
        ys = torch.arange(hs, dtype=torch.float32, device=dev)[:, None] / sig_s
        xs = torch.arange(ws, dtype=torch.float32, device=dev)[None, :] / sig_s
        pos = torch.stack([ys.expand(hs, ws), xs.expand(hs, ws)])[None].expand(b, 2, hs, ws)
        feats = torch.cat([pos, img_s], dim=1).reshape(b, 5, n).transpose(1, 2)
        # exp(-|f_p - f_q|^2 / 2) through the Gram identity, a difference
        # of large squares: centered as the JAX package does, and formed in
        # float64, since in fp32 the cancellation leaves ~1e-4 on the
        # exponent (about 1e-5 on the refined probabilities).  Row blocks
        # keep the float64 temporaries at 4096 rows.
        feats = feats.double()
        feats = feats - feats.mean(dim=1, keepdim=True)
        sq = torch.sum(feats * feats, dim=-1)                        # (B, N)
        kmat = torch.empty((b, n, n), dtype=torch.float32, device=dev)
        for r0 in range(0, n, 4096):
            gram = torch.matmul(feats[:, r0:r0 + 4096], feats.transpose(1, 2))
            kmat[:, r0:r0 + 4096] = torch.exp(
                gram - 0.5 * sq[:, r0:r0 + 4096, None] - 0.5 * sq[:, None, :])
        del gram
        normb = torch.matmul(kmat, torch.ones((n, 1), dtype=torch.float32, device=dev))
        nb = torch.rsqrt(normb.reshape(b, 1, hs, ws) + 1e-20)

        def bilateral_msg(qs):
            """q @ K (K symmetric): (B, C, hs, ws) -> (B, C, hs, ws)."""
            return torch.matmul(qs.reshape(b, c, n), kmat).reshape(b, c, hs, ws)
    else:
        r_bi = max(int(round(2 * sig_s)), 1)
        _, normb = window_message(None, img_s, sig_s, r_bi)
        nb = torch.rsqrt(normb + 1e-20)

        def bilateral_msg(qs):
            return window_message(qs.contiguous(), img_s, sig_s, r_bi)[0]

    for _ in range(cfg.iter_max):
        logits = -unary
        # spatial (Potts, symmetric normalization)
        msg = norm_pos * _sep_gauss(q * norm_pos, cfg.pos_xy_std, r_pos)
        logits = logits + cfg.pos_w * msg
        # bilateral (subsampled, symmetric normalization)
        qs = resize_bilinear(q, hs, ws)
        msg_s = bilateral_msg(qs * nb)
        msg_b = resize_bilinear(nb * msg_s, h, w)
        logits = logits + cfg.bi_w * msg_b
        q = torch.softmax(logits, dim=1)
    return q[0] if single else q
