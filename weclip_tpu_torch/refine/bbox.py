"""CAM -> bounding-box affinity masks on the device
(port of weclip_tpu/refine/bbox.py).

cv2-exact: the normalized CAM is quantized like cv2 (uint8 truncation,
strict ``>`` against ``int(thr * max)``), 8-connected components are found
by iterated 3x3 min-label propagation, and the union of the components'
bounding boxes keeps the reference's ``min(x1, w-1)`` clipping (the last
valid row/column is excluded for components that touch it).  Everything
is batched over leading axes on the padded grid.  ``box_iou`` is a host
numpy utility.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def connected_components(binary: torch.Tensor) -> torch.Tensor:
    """8-connected component labels of (..., H, W) bool grids.

    Returns int64 labels (= min flat index in the component); background
    cells get H*W.  Iterates until no label changes in any grid."""
    h, w = binary.shape[-2:]
    lead = binary.shape[:-2]
    sentinel = h * w
    idx = torch.arange(h * w, device=binary.device).reshape(h, w)
    labels = torch.where(binary, idx, torch.full_like(idx, sentinel))
    binary = binary.reshape(-1, h, w)
    labels = labels.expand(*lead, h, w).reshape(-1, h, w)
    while True:
        p = F.pad(labels, (1, 1, 1, 1), value=sentinel)
        best = labels
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                best = torch.minimum(best, p[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
        new = torch.where(binary, best, torch.full_like(best, sentinel))
        if not bool(torch.any(new != labels)):
            break
        labels = new
    return labels.reshape(*lead, h, w)


def scoremap_box_mask(cam: torch.Tensor, valid: torch.Tensor,
                      gh: torch.Tensor, gw: torch.Tensor,
                      threshold: float) -> torch.Tensor:
    """Union-of-component-bboxes masks.

    cam:   (N, G0, G1) min-max-normalized scores (0 on invalid cells)
    valid: (N, G0, G1) bool; gh/gw: (N,) true grid extents
    Returns (N, G0, G1) float32 masks in {0, 1}."""
    n, g0, g1 = cam.shape
    q = torch.floor(cam.float().clamp(0.0, 1.0) * 255.0).to(torch.int64)
    q = torch.where(valid, q, torch.zeros_like(q))
    qmax = q.reshape(n, -1).amax(dim=1).float()
    thr = torch.floor(threshold * qmax).to(torch.int64)
    binary = (q > thr[:, None, None]) & valid

    labels = connected_components(binary).reshape(n, -1)
    ncell = g0 * g1
    cells = torch.arange(ncell, device=cam.device)
    ys, xs = cells // g1, cells % g1
    big = 1 << 20
    # per-component extents; background cells land in the extra slot ncell
    ymin = torch.full((n, ncell + 1), big, device=cam.device, dtype=torch.int64)
    xmin = torch.full_like(ymin, big)
    ymax = torch.full_like(ymin, -1)
    xmax = torch.full_like(ymin, -1)
    yb, xb = ys.expand(n, -1), xs.expand(n, -1)
    ymin = ymin.scatter_reduce(1, labels, yb, "amin")
    xmin = xmin.scatter_reduce(1, labels, xb, "amin")
    ymax = ymax.scatter_reduce(1, labels, yb, "amax")
    xmax = xmax.scatter_reduce(1, labels, xb, "amax")
    ymin, xmin, ymax, xmax = (t[:, :ncell] for t in (ymin, xmin, ymax, xmax))
    exists = ymax >= 0

    # reference clipping: x1 = min(x + w, width - 1), mask[y0:y1, x0:x1] = 1
    y1 = torch.minimum(ymax + 1, gh.to(torch.int64)[:, None] - 1)
    x1 = torch.minimum(xmax + 1, gw.to(torch.int64)[:, None] - 1)
    rows = torch.arange(g0, device=cam.device)
    cols = torch.arange(g1, device=cam.device)
    in_r = ((rows[None, None] >= ymin[..., None]) & (rows[None, None] < y1[..., None])
            & exists[..., None])                                   # (N, R, G0)
    in_c = (cols[None, None] >= xmin[..., None]) & (cols[None, None] < x1[..., None])
    # union of boxes: a cell is covered when some component's row and
    # column ranges both hold it (exact counts in fp32)
    cover = torch.matmul(in_r.float().transpose(1, 2), in_c.float())
    return (cover > 0).float()


def box_iou(box_a, box_b):
    """Pairwise IoU (na, nb) float64 of x0y0x1y1 integer boxes, a host
    numpy utility: inclusive-pixel areas (the +1 convention), pairs whose
    union is not positive scored 0."""
    a = np.asarray(box_a)[:, None, :].astype(np.float64)   # (na, 1, 4)
    b = np.asarray(box_b)[None, :, :].astype(np.float64)   # (1, nb, 4)
    ix = np.maximum(0, np.minimum(a[..., 2], b[..., 2])
                    - np.maximum(a[..., 0], b[..., 0]) + 1)
    iy = np.maximum(0, np.minimum(a[..., 3], b[..., 3])
                    - np.maximum(a[..., 1], b[..., 1]) + 1)
    inter = ix * iy
    area_a = (a[..., 2] - a[..., 0] + 1) * (a[..., 3] - a[..., 1] + 1)
    area_b = (b[..., 2] - b[..., 0] + 1) * (b[..., 3] - b[..., 1] + 1)
    denom = area_a + area_b - inter
    bad = denom <= 0
    return np.where(bad, 0.0, inter / np.where(bad, 1.0, denom))
