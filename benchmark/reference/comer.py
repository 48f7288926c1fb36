"""ViT-CoMer branch: CNN pyramid, MRFP and CTI bidirectional cross-attention
(a frozen copy of the plain math of
weclip_tpu_torch/models/comer.py).

- CNN stem: strided convolutions giving C3/C4/C5 at 1/8, 1/16, 1/32;
- MRFP: per level, parallel dilated 3x3 convolutions, a 1x1 fuse, a group
  norm and a tanh-GELU residual;
- CTI: after selected frozen ViT blocks, cross-attention injects the ViT
  tokens into the pyramid tokens, then extracts the updated pyramid back
  into a token stream aligned with the ViT grid.

The branch's output is added to the fuse head's features; all of it trains
with the heads.  It runs at the backbone policy (bf16 in production) with
fp32 norms and softmax.  The convolutions are ``F.conv2d`` (the JAX package
runs them outside any Pallas kernel); the CTI attention core is the plain version
under autograd (the program's K6 and K3-rect are not used here).

Three numerics of JAX that PyTorch's defaults do not share: ``lax.conv``'s
"SAME" padding is asymmetric for stride 2 (pad (0, 1) on an even size),
``jax.image.resize(..., "nearest")`` uses half-pixel centres
(``nearest-exact``), and ``jax.nn.gelu`` is the tanh approximation.
The JAX package pads both token streams to multiples of 128 for TPU lanes;
padded rows are masked keys whose outputs are sliced off, so the port runs
at the true lengths.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from benchmark.reference import precision
from benchmark.reference.config import ComerConfig
from benchmark.reference.attention import cross_attention_core_plain

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _same_pad(size: int, k: int, stride: int, dilation: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, dilation: int = 1,
           policy: precision.Policy = precision.DEFAULT) -> torch.Tensor:
    """NCHW / OIHW convolution with ``lax.conv``'s "SAME" padding, in the
    compute dtype (fp32 accumulation, output in the compute dtype)."""
    cd = policy.compute_dtype
    k = w.shape[-1]
    top, bottom = _same_pad(x.shape[-2], k, stride, dilation)
    left, right = _same_pad(x.shape[-1], k, stride, dilation)
    x = F.pad(x.to(cd), (left, right, top, bottom))
    return precision.conv2d(x, w.to(cd), stride=stride, dilation=dilation)


def group_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """fp32 statistics over min(groups, C) groups, output in x's dtype."""
    y = F.group_norm(x.float(), min(groups, x.shape[1]), g.float(), b.float(), eps)
    return y.to(x.dtype)


def layer_norm_1d(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """fp32 statistics, output in x's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), g.float(), b.float(), eps)
    return y.to(x.dtype)


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, cd) -> torch.Tensor:
    """x @ w.T on compute-dtype inputs, fp32 accumulation, + b, cast to cd."""
    return (precision.matmul_f32(x, w.t(), cd) + b).to(cd)


def cross_attention(q: torch.Tensor, kv: torch.Tensor, p: Params, n_heads: int,
                    kv_valid: Optional[torch.Tensor] = None,
                    policy: precision.Policy = precision.DEFAULT) -> torch.Tensor:
    """Multi-head cross-attention (B, Lq, C) x (B, Lk, C) -> (B, Lq, C) in
    the compute dtype.  The head tensors live in the compute dtype, q
    pre-scaled there; the core is the plain version    under autograd."""
    cd = policy.compute_dtype
    b, lq, c = q.shape
    lk = kv.shape[1]
    hd = c // n_heads
    qp = _linear(q, p["q_w"], p["q_b"], cd) * torch.tensor(hd ** -0.5, dtype=cd)
    kp = _linear(kv, p["k_w"], p["k_b"], cd)
    vp = _linear(kv, p["v_w"], p["v_b"], cd)

    def heads(t, n):
        return t.reshape(b, n, n_heads, hd).permute(0, 2, 1, 3).contiguous()

    kvmask = (kv_valid.float() if kv_valid is not None
              else torch.ones((b, lk), device=q.device, dtype=torch.float32))
    qh, kh, vh = heads(qp, lq), heads(kp, lk), heads(vp, lk)
    o = cross_attention_core_plain(qh, kh, vh, kvmask)
    o = o.permute(0, 2, 1, 3).reshape(b, lq, c)
    return _linear(o, p["o_w"], p["o_b"], cd)


# ---------------------------------------------------------------------------
# init (the JAX package's schemes; random draws from ``gen``)
# ---------------------------------------------------------------------------

def _conv_init(gen, out_c, in_c, k):
    return torch.randn((out_c, in_c, k, k), generator=gen) * math.sqrt(2.0 / (in_c * k * k))


def _lin_init(gen, out_c, in_c):
    bound = 1.0 / math.sqrt(in_c)
    return (torch.rand((out_c, in_c), generator=gen) * 2 - 1) * bound


def _gn(c):
    return {"g": torch.ones(c), "b": torch.zeros(c)}


def _xattn_init(gen, c):
    return {
        "q_w": _lin_init(gen, c, c), "q_b": torch.zeros(c),
        "k_w": _lin_init(gen, c, c), "k_b": torch.zeros(c),
        "v_w": _lin_init(gen, c, c), "v_b": torch.zeros(c),
        # zero-init output projection: the branch starts as identity
        "o_w": torch.zeros((c, c)), "o_b": torch.zeros(c),
    }


def init_comer_params(gen: torch.Generator, cfg: ComerConfig, vit_width: int = 768,
                      embed: int = 256) -> Params:
    c3, c4, c5 = cfg.pyramid_dims
    sw = cfg.stem_width
    p: Params = {
        "stem": {
            "conv1_w": _conv_init(gen, sw, 3, 3), "gn1": _gn(sw),
            "conv2_w": _conv_init(gen, sw, sw, 3), "gn2": _gn(sw),
            "conv3_w": _conv_init(gen, c3, sw, 3), "gn3": _gn(c3),
            "conv4_w": _conv_init(gen, c4, c3, 3), "gn4": _gn(c4),
            "conv5_w": _conv_init(gen, c5, c4, 3), "gn5": _gn(c5),
        },
        "vit_proj_w": _lin_init(gen, embed, vit_width),
        "vit_proj_b": torch.zeros(embed),
        "mrfp": [],
        "cti": [],
        "out_gn": _gn(embed),
        # zero-init: the branch's contribution to the fuse features starts at 0
        "out_w": torch.zeros((embed, embed)),
        "out_b": torch.zeros(embed),
    }
    for name, c in (("c3", c3), ("c4", c4), ("c5", c5)):
        branch = {f"d{d}_w": _conv_init(gen, c, c, 3) for d in cfg.mrfp_dilations}
        branch["fuse_w"] = _conv_init(gen, c, c * len(cfg.mrfp_dilations), 1)
        branch["gn"] = _gn(c)
        p["mrfp"].append(branch)
        p[f"lvl_proj_{name}_w"] = _lin_init(gen, embed, c)
        p[f"lvl_proj_{name}_b"] = torch.zeros(embed)
    for _ in cfg.interaction_indexes:
        p["cti"].append({
            "inj": _xattn_init(gen, embed),
            "ext": _xattn_init(gen, embed),
            "ln_q": _gn(embed),
            "ln_kv": _gn(embed),
        })
    return p


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _mrfp(x: torch.Tensor, p: Params, dilations, policy) -> torch.Tensor:
    outs = [conv2d(x, p[f"d{d}_w"], dilation=d, policy=policy) for d in dilations]
    y = conv2d(torch.cat(outs, dim=1), p["fuse_w"], policy=policy)
    return x + F.gelu(group_norm(y, p["gn"]["g"], p["gn"]["b"]), approximate="tanh")


def comer_forward(
    p: Params,
    img: torch.Tensor,               # (B, 3, H, W) normalized (padded ok)
    vit_layer_tokens: torch.Tensor,  # (n_layers, B, P, D) frozen ViT patch tokens
    valid_p: torch.Tensor,           # (B, P) patch validity on the 1/16 grid
    cfg: ComerConfig,
    policy: precision.Policy = precision.DEFAULT,
) -> torch.Tensor:
    """Returns (B, P, embed) fp32 fusion features aligned to the ViT grid,
    zero at invalid patches.  The grid must be square."""
    b, pp = valid_p.shape
    g = math.isqrt(pp)
    if g * g != pp:
        raise ValueError(f"comer_forward: {pp} patches are not a square grid")
    cd = policy.compute_dtype
    s = p["stem"]

    def stage(x, i):
        y = conv2d(x, s[f"conv{i}_w"], 2, policy=policy)
        return F.gelu(group_norm(y, s[f"gn{i}"]["g"], s[f"gn{i}"]["b"]),
                      approximate="tanh")

    x = stage(stage(img, 1), 2)
    c3 = stage(x, 3)                                   # 1/8
    c4 = stage(c3, 4)                                  # 1/16
    c5 = stage(c4, 5)                                  # 1/32
    levels = {"c3": c3, "c4": c4, "c5": c5}
    for i, name in enumerate(levels):
        levels[name] = _mrfp(levels[name], p["mrfp"][i], cfg.mrfp_dilations, policy)

    # the multi-scale token stream and its validity, from the 1/16 grid
    # mask resized with half-pixel centres
    vg = valid_p.float().reshape(b, 1, g, g)
    toks, masks = [], []
    for name, lvl in levels.items():
        t = lvl.flatten(2).transpose(1, 2)
        toks.append(_linear(t, p[f"lvl_proj_{name}_w"], p[f"lvl_proj_{name}_b"], cd))
        m = F.interpolate(vg, size=lvl.shape[-2:], mode="nearest-exact")
        masks.append(m.reshape(b, -1) > 0.5)
    ms = torch.cat(toks, dim=1)
    ms_valid = torch.cat(masks, dim=1)

    # the ViT-aligned trainable stream; each stage adds its interaction
    # layer's projected tokens once
    n_layers = vit_layer_tokens.shape[0]
    v = torch.zeros((b, pp, p["vit_proj_b"].shape[0]), device=img.device, dtype=cd)
    for i, layer_idx in enumerate(cfg.interaction_indexes):
        cp = p["cti"][i]
        vt = _linear(vit_layer_tokens[min(layer_idx, n_layers - 1)],
                     p["vit_proj_w"], p["vit_proj_b"], cd)
        v = v + vt
        vq = layer_norm_1d(v, cp["ln_q"]["g"], cp["ln_q"]["b"])
        msn = layer_norm_1d(ms, cp["ln_kv"]["g"], cp["ln_kv"]["b"])
        # inject into the pyramid, then extract from the updated pyramid
        ms = ms + cross_attention(msn, vq, cp["inj"], cfg.cti_heads,
                                  kv_valid=valid_p, policy=policy)
        msn = layer_norm_1d(ms, cp["ln_kv"]["g"], cp["ln_kv"]["b"])
        v = v + cross_attention(vq, msn, cp["ext"], cfg.cti_heads,
                                kv_valid=ms_valid, policy=policy)

    out = precision.matmul_f32(v, p["out_w"].t(), cd) + p["out_b"]
    out = layer_norm_1d(out, p["out_gn"]["g"], p["out_gn"]["b"])
    return out.masked_fill(~valid_p.bool()[..., None], 0.0)
