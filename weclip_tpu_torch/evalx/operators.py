"""Per-image resize operators for shape-static evaluation
(port of the device builders in weclip_tpu/evalx/operators.py).

Each variable-size bilinear resize is a pair of per-image interpolation
matrices on fixed canvases; rows past an image's true extent clamp to its
last row, so canvas padding is edge-replicated (which makes PAR's replicate
padding exact on the padded canvas).  Built on the device from the sizes,
batched over images."""

from __future__ import annotations

import torch


def device_resize_matrix(in_size: torch.Tensor, out_size: torch.Tensor,
                         canvas: int, src_pad: int,
                         align_corners: bool = False) -> torch.Tensor:
    """(B,) sizes -> (B, canvas, src_pad) clamp-resize matrices: bilinear
    weights as the hat function max(0, 1 - |src(r) - c|)."""
    in_f = in_size.float()[:, None]
    out_f = out_size.float()[:, None]
    r = torch.arange(canvas, device=in_size.device, dtype=torch.float32)[None]
    dst = torch.minimum(r, out_f - 1.0)
    if align_corners:
        src = dst * (in_f - 1.0) / torch.clamp_min(out_f - 1.0, 1.0)
    else:
        src = (dst + 0.5) * (in_f / out_f) - 0.5
    src = torch.minimum(torch.clamp_min(src, 0.0), in_f - 1.0)
    c = torch.arange(src_pad, device=in_size.device, dtype=torch.float32)
    return torch.clamp_min(1.0 - (src[..., None] - c).abs(), 0.0)


def device_scale_matrix(in_size: torch.Tensor, out_size: torch.Tensor,
                        scale: float, canvas: int, src_pad: int) -> torch.Tensor:
    """Clamp-resize matrices with torch's scale_factor coordinate mapping
    (src = (dst + 0.5) / s - 0.5): the 0.75-scale TTA input is derived from
    the scale-1 tensor through the original scale."""
    in_f = in_size.float()[:, None]
    out_f = out_size.float()[:, None]
    r = torch.arange(canvas, device=in_size.device, dtype=torch.float32)[None]
    dst = torch.minimum(r, out_f - 1.0)
    src = (dst + 0.5) / torch.tensor(scale, dtype=torch.float32) - 0.5
    src = torch.minimum(torch.clamp_min(src, 0.0), in_f - 1.0)
    c = torch.arange(src_pad, device=in_size.device, dtype=torch.float32)
    return torch.clamp_min(1.0 - (src[..., None] - c).abs(), 0.0)
