"""Operations and bytes of a cell's calls, from the configuration's sizes and
the cell's shapes, never from which kernel ran.

Counted: the matmul, convolution and attention products the algorithm needs
(the frozen ViT forward of every view, GradCAM's last-block forward and its
backward to the block's tap over the class bucket, the heads, the decoder
and CoMer forward, and backward in training, the affinity products of the
pseudo-label chain), and PAR's elementwise multiply-adds.  A tower block's
products are its tower's own (``towers/<tower>.py``, ``block_products``).  Not counted:
recomputation, resizes done as interpolation matrices, normalisations,
softmaxes, losses and the optimizer's elementwise update.  Bytes: each input
byte read once and each output byte written once, per call.  Only the
tokens and pixels of each image's valid region count, not the canvas it is
padded onto.

Each product is charged at the peak of the precision the configuration
states for it: bf16 products (the ViT and CoMer, ``compute_dtype``) at
989 TFLOP/s, fp32 products (the heads, ``head_dtype``, and the affinity
products) at TF32's 494.7 TFLOP/s, the fastest rate at which the tensor
cores take an fp32 operand; PAR's elementwise fp32 multiply-adds at the
67 TFLOP/s of the fp32 units; bytes at 3.35 TB/s.  These are one NVIDIA
H100 SXM's published dense peaks at its 700 W limit.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple

from benchmark import towers

PEAK_FLOPS = {"bf16": 989e12, "fp32": 494.7e12, "fp32_fma": 67e12}
PEAK_BYTES = 3.35e12
_BYTES = {"bf16": 2, "fp32": 4, "fp32_fma": 4}


@dataclass(frozen=True)
class Op:
    layer: str          # "attention", "par" or "dense"
    flops: float
    bytes: float
    dtype: str          # key of PEAK_FLOPS

    def least_s(self) -> float:
        return max(self.flops / PEAK_FLOPS[self.dtype], self.bytes / PEAK_BYTES)


def least_seconds(ops: Iterable[Op], layer: str = None) -> float:
    """The least time of ``ops`` (of one ``layer``, or all): each op at the
    larger of its operations over the peak and its bytes over the
    bandwidth."""
    return sum(o.least_s() for o in ops if layer is None or o.layer == layer)


def product_seconds(ops: Iterable[Op]) -> float:
    """The products' operations at their peaks alone (for mfu)."""
    return sum(o.flops / PEAK_FLOPS[o.dtype] for o in ops if o.layer != "par")


def _dt(name: str) -> str:
    return {"bfloat16": "bf16", "float32": "fp32"}[name]


def _mm(rows: float, k: float, n: float, dt: str, times: float = 1.0) -> Op:
    """rows x k times k x n."""
    b = _BYTES[dt]
    return Op("dense", 2 * rows * k * n * times,
              (rows * k + k * n + rows * n) * b * times, dt)


def _attn(rows: int, heads: int, lq: int, lk: int, dh: int, dt: str,
          backward: bool = False, map_out: bool = False) -> Op:
    """An attention core: forward QK^T and PV (4 lq lk dh a head), or its
    backward (dQ, dK, dV and dP: 8 lq lk dh a head)."""
    b = _BYTES[dt]
    if backward:
        flops = 8 * rows * heads * lq * lk * dh
        byts = rows * heads * (2 * lq * dh + 2 * lk * dh) * b * 2
    else:
        flops = 4 * rows * heads * lq * lk * dh
        byts = rows * heads * (2 * lq * dh + 2 * lk * dh) * b
        if map_out:
            byts += rows * lq * lk * 4
    return Op("attention", flops, byts, dt)


def config_dict(config: dict) -> dict:
    """What the functions here read of a configuration file: its overlay
    onto the port's ``Config``, with the class-feature count ``num_bg``, the
    ``tower`` and the ``published`` sizes beside it."""
    d = copy.deepcopy(config["config"])
    d["num_bg"] = config["text"]["num_bg"]
    d["tower"], d["published"] = config["tower"], copy.deepcopy(config["published"])
    return d


def _block(cfg: dict, rows: int, length: int) -> List[Tuple[int, int, int]]:
    """The matrix products of one block of the configuration's tower."""
    return towers.load(cfg["tower"]).block_products(cfg["clip"], cfg["published"], rows,
                                                    length)


def vit_blocks(cfg: dict, lens: Sequence[int], dt: str, export: Sequence[bool],
               blocks: int) -> List[Op]:
    """``blocks`` frozen ViT blocks over one row per token length in
    ``lens`` (CLS included); ``export[i]``: row i writes its head-mean map."""
    d, h = cfg["clip"]["vision_width"], cfg["clip"]["vision_heads"]
    ops = []
    for l, ex in zip(lens, export):
        ops += [_mm(m, k, n, dt, blocks) for m, k, n in _block(cfg, 1, l)]
        ops += [_attn(1, h, l, l, d // h, dt, map_out=ex)] * blocks
    return ops


def patch_embed(clip: dict, lens: Sequence[int], dt: str) -> List[Op]:
    p, d = clip["patch_size"], clip["vision_width"]
    return [_mm(l - 1, 3 * p * p, d, dt) for l in lens]


def gradcam(cfg: dict, lens: Sequence[int], mcs: Sequence[int], n_text: int,
            dt: str) -> List[Op]:
    """The last block's forward over each image's class rows (``mcs``: the
    classes each image holds), the image head, and the backward to the
    block's tap, the input of its first products (input gradients only:
    the tower is frozen), then the CAM weights' product."""
    clip = cfg["clip"]
    d, h, e = clip["vision_width"], clip["vision_heads"], clip["embed_dim"]
    ops = []
    for l, r in zip(lens, mcs):
        products = _block(cfg, r, l)
        ops += [_mm(m, k, n, dt) for m, k, n in products]
        ops.append(_attn(r, h, l, l, d // h, dt, map_out=True))
        ops += [_mm(r, d, e, "fp32"), _mm(r, e, n_text, "fp32")]
        # backward: the same products' input gradients, the last first
        ops += [_mm(r, n_text, e, "fp32"), _mm(r, e, d, "fp32")]
        ops += [_mm(m, n, k, dt) for m, k, n in reversed(products)]
        ops.append(_attn(r, h, l, l, d // h, dt, backward=True))
        ops.append(_mm(r, d, l - 1, "fp32"))
    return ops


def chain(ps: Sequence[int], mcs: Sequence[int], pixels: Sequence[int],
          par: dict) -> List[Op]:
    """The pseudo-label chain after GradCAM, an image at a time: the
    Sinkhorn self-product and the walk (fp32), and PAR on the background
    and the image's classes (``mcs``) over ``pixels``: K4's affinity and K5's ``num_iter`` propagations."""
    n = 8 * len(par["dilations"])
    ops = []
    for p, mc, px in zip(ps, mcs, pixels):
        ops += [_mm(p, p, p, "fp32"), _mm(mc, p, p, "fp32")]
        c = 1 + mc
        ops.append(Op("par", 12 * n * px, (3 + n) * px * 4, "fp32_fma"))
        ops.append(Op("par", 2 * par["num_iter"] * n * c * px,
                      (2 * c + n) * px * 4, "fp32_fma"))
    return ops


def heads(cfg: dict, ps: Sequence[int], backward: bool) -> List[Op]:
    """Fuse head, decoder and the Gram affinity over one row per patch
    count in ``ps``; with ``backward``, their gradients (no input gradient
    of the frozen tokens)."""
    clip = cfg["clip"]
    dt = _dt(cfg["precision"]["head_dtype"])
    d, c = clip["vision_width"], clip["embedding_dim"]
    nl, k = clip["vision_layers"] - 1, cfg["dataset"]["num_classes"]
    dec_heads, dec_layers = 8, 3
    ops = []
    for p in ps:
        fwd = [_mm(p, c, c, dt, nl), _mm(p, nl * c, c, dt)]
        for _ in range(dec_layers):
            fwd += [_mm(p, c, 3 * c, dt), _mm(p, c, c, dt), _mm(p, c, 4 * c, dt),
                    _mm(p, 4 * c, c, dt), _attn(1, dec_heads, p, p, c // dec_heads, dt)]
        fwd += [_mm(p, c, k, dt), _mm(p, c, p, dt)]
        first = _mm(p, d, c, dt, nl)
        ops += fwd + [first]
        if backward:
            ops += [Op(o.layer, 2 * o.flops, 2 * o.bytes, o.dtype) for o in fwd]
            ops.append(first)
    return ops


def comer(cfg: dict, items: Sequence[Tuple[int, int, int]], backward: bool) -> List[Op]:
    """The CoMer branch on images of (h, w) pixels with p ViT patches, one
    per item (h, w, p): stem, MRFP, projections and the CTI stages; with
    ``backward``, their gradients (no input gradient of the image or the
    frozen tokens)."""
    cm, clip = cfg["comer"], cfg["clip"]
    dt = _dt(cfg["precision"]["compute_dtype"])
    c, d, sw = clip["embedding_dim"], clip["vision_width"], cm["stem_width"]
    c3, c4, c5 = cm["pyramid_dims"]
    ops = []

    def conv(h, w, cin, cout, k, stride):
        ho, wo = -(-h // stride), -(-w // stride)
        return _mm(ho * wo, cin * k * k, cout, dt), ho, wo

    for h, w, p in items:
        first, h1, w1 = conv(h, w, 3, sw, 3, 2)
        fwd = []
        o, h2, w2 = conv(h1, w1, sw, sw, 3, 2)
        fwd.append(o)
        levels = []
        hh, ww, cin = h2, w2, sw
        for cout in (c3, c4, c5):
            o, hh, ww = conv(hh, ww, cin, cout, 3, 2)
            fwd.append(o)
            levels.append((hh * ww, cout))
            cin = cout
        n_ms = 0
        for n, ch in levels:
            fwd += [_mm(n, ch * 9, ch, dt, len(cm["mrfp_dilations"])),
                    _mm(n, ch * len(cm["mrfp_dilations"]), ch, dt), _mm(n, ch, c, dt)]
            n_ms += n
        stages = len(cm["interaction_indexes"])
        vit_proj = _mm(p, d, c, dt, stages)
        for _ in range(stages):
            fwd += [_mm(n_ms, c, c, dt, 2), _mm(p, c, c, dt, 2),
                    _attn(1, cm["cti_heads"], n_ms, p, c // cm["cti_heads"], dt),
                    _mm(p, c, c, dt, 2), _mm(n_ms, c, c, dt, 2),
                    _attn(1, cm["cti_heads"], p, n_ms, c // cm["cti_heads"], dt)]
        fwd.append(_mm(p, c, c, dt))
        ops += fwd + [first, vit_proj]
        if backward:
            for o in fwd:
                if o.layer == "attention":
                    ops.append(_attn_bwd_of(o))
                else:
                    ops.append(Op(o.layer, 2 * o.flops, 2 * o.bytes, o.dtype))
            ops += [first, vit_proj]
    return ops


def _attn_bwd_of(o: Op) -> Op:
    return Op("attention", 2 * o.flops, 2 * o.bytes, o.dtype)


def train_step(cfg: dict, mcs: Sequence[int]) -> List[Op]:
    """One training step at the configuration's batch and crop (``cfg``:
    the configuration's ``config_dict``); ``mcs``:
    the classes each image of the batch holds (the CAM chain needs those,
    not the padded class bucket the program runs)."""
    clip, ds = cfg["clip"], cfg["dataset"]
    b, crop = cfg["train"]["samples_per_gpu"], ds["crop_size"]
    g = crop // clip["patch_size"]
    p, l = g * g, g * g + 1
    dt = _dt(cfg["precision"]["compute_dtype"])
    n_text = ds["num_classes"] - 1 + cfg["num_bg"]
    lens = [l] * b
    ops = patch_embed(clip, lens, dt)
    ops += vit_blocks(cfg, lens, dt, [True] * b, clip["vision_layers"] - 1)
    ops += gradcam(cfg, lens, mcs, n_text, dt)
    ops += chain([p] * b, mcs, [crop * crop] * b, cfg["par"])
    ops += heads(cfg, [p] * b, backward=True)
    if cfg["comer"]["enabled"]:
        ops += comer(cfg, [(crop, crop, p)] * b, backward=True)
    return ops


def eval_batch(cfg: dict, sizes: Sequence[Tuple[int, int]], with_cam: bool,
               mcs: Sequence[int]) -> List[Op]:
    """One msc-flip batch (``cfg``: the configuration's ``config_dict``) of
    images of original ``sizes`` (h, w): scale 1
    and its flip with the CAM chain on the unflipped half where
    ``with_cam`` (``mcs``: the classes each image holds), scale 0.75 and its flip, seg only."""
    clip, ev, ds = cfg["clip"], cfg["eval"], cfg["dataset"]
    patch, rl = clip["patch_size"], ev["resize_long"]
    s2 = ev["scales"][1]
    dt = _dt(cfg["precision"]["compute_dtype"])
    n_text = ds["num_classes"] - 1 + cfg["num_bg"]
    l1, l2, p1, p2, px = [], [], [], [], []
    hw1, hw2 = [], []
    for oh, ow in sizes:
        r = rl / max(oh, ow)
        h1, w1 = int(oh * r), int(ow * r)
        h2, w2 = int(h1 * s2), int(w1 * s2)
        g1 = (h1 // patch) * (w1 // patch)
        g2 = max(h2 // patch, 1) * max(w2 // patch, 1)
        l1.append(g1 + 1)
        l2.append(g2 + 1)
        p1.append(g1)
        p2.append(g2)
        px.append(oh * ow)
        hw1.append((h1, w1))
        hw2.append((h2, w2))
    ops = []
    for lens, ps, hw, export in ((l1, p1, hw1, with_cam), (l2, p2, hw2, False)):
        two = lens + lens
        ops += patch_embed(clip, two, dt)
        ops += vit_blocks(cfg, two, dt, [export] * len(lens) + [False] * len(lens),
                          clip["vision_layers"] - 1)
        ops += heads(cfg, ps + ps, backward=False)
        if cfg["comer"]["enabled"]:
            ops += comer(cfg, [(h, w, q) for (h, w), q in zip(hw, ps)] * 2,
                         backward=False)
    if with_cam:
        ops += gradcam(cfg, l1, mcs, n_text, dt)
        ops += chain(p1, mcs, px, cfg["par"])
    return ops
