"""OpenAI's CLIP image tower (a frozen copy of the plain math of
weclip_tpu_torch/models/clip/vit.py and its loader): a patch convolution
without bias, a class token, ``ln_pre``, pre-LN blocks with a fused QKV
projection and a 4x QuickGELU MLP, then ``ln_post`` and ``proj``."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from benchmark.reference import precision, vit
from benchmark.reference.attention import mha_with_weights

Params = vit.Params


def blocks(sd: Dict[str, torch.Tensor], layers: int) -> Params:
    """The stacked block tree of an OpenAI-layout state dict."""
    pre = "visual.transformer.resblocks"

    def stack(name):
        return torch.stack([sd[f"{pre}.{i}.{name}"].float() for i in range(layers)])

    return {
        "ln_1": {"g": stack("ln_1.weight"), "b": stack("ln_1.bias")},
        "attn": {"in_w": stack("attn.in_proj_weight"), "in_b": stack("attn.in_proj_bias"),
                 "out_w": stack("attn.out_proj.weight"), "out_b": stack("attn.out_proj.bias")},
        "ln_2": {"g": stack("ln_2.weight"), "b": stack("ln_2.bias")},
        "mlp": {"fc_w": stack("mlp.c_fc.weight"), "fc_b": stack("mlp.c_fc.bias"),
                "proj_w": stack("mlp.c_proj.weight"), "proj_b": stack("mlp.c_proj.bias")},
    }


def tree(sd: Dict[str, torch.Tensor], clip, published: Optional[dict]) -> Params:
    f = lambda k: sd[k].float()
    return {"conv1_w": f("visual.conv1.weight"), "class_embedding": f("visual.class_embedding"),
            "positional_embedding": f("visual.positional_embedding"),
            "ln_pre": {"g": f("visual.ln_pre.weight"), "b": f("visual.ln_pre.bias")},
            "blocks": blocks(sd, clip.vision_layers),
            "ln_post": {"g": f("visual.ln_post.weight"), "b": f("visual.ln_post.bias")},
            "proj": f("visual.proj")}


def embed(params: Params, img: torch.Tensor, pos_emb: torch.Tensor, valid: torch.Tensor,
          grid: Tuple[int, int], cfg, policy: precision.Policy) -> torch.Tensor:
    b = img.shape[0]
    x = vit.patchify(img, params["conv1_w"], cfg.patch_size, policy)
    cls = params["class_embedding"].float()[None, None, :].expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + pos_emb.float()
    x = vit.layer_norm(x, params["ln_pre"]["g"], params["ln_pre"]["b"])
    return x.masked_fill(~valid.bool()[..., None], 0.0)


def block_forward(p: Params, x: torch.Tensor, n_heads: int, valid: torch.Tensor,
                  grid: Tuple[int, int], policy: precision.Policy, want_attn: bool):
    """The pre-LN block, the same as the decoder's (``vit.block_forward``)."""
    x, attn_w, _ = vit.block_forward(p, x, n_heads, valid=valid, policy=policy,
                                     want_attn=want_attn)
    return x, attn_w


def tap(p: Params, x: torch.Tensor) -> torch.Tensor:
    """The ln_1 output."""
    return vit.layer_norm(x, p["ln_1"]["g"], p["ln_1"]["b"])


def block_from_tap(p: Params, x_in: torch.Tensor, a: torch.Tensor, n_heads: int,
                   valid: torch.Tensor, grid: Tuple[int, int], policy: precision.Policy):
    """The block with its ln_1 output ``a`` given: the attention is the
    plain formulation under autograd."""
    attn_out, attn_w = mha_with_weights(a, vit.mha_params(p), n_heads, valid=valid,
                                        policy=policy)
    x = x_in + attn_out
    x = x + vit.mlp_forward(p["mlp"], vit.layer_norm(x, p["ln_2"]["g"], p["ln_2"]["b"]),
                            policy)
    return x, attn_w


def out(params: Params, x: torch.Tensor, pool) -> torch.Tensor:
    """ln_post -> pool -> proj."""
    x = vit.layer_norm(x, params["ln_post"]["g"], params["ln_post"]["b"])
    return precision.matmul(pool(x), params["proj"].float())
