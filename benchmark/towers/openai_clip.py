"""OpenAI's CLIP image tower (arXiv:2103.00020; the ``ViT-B-16.pt`` and
``ViT-L-14.pt`` checkpoints): a patch convolution without bias, a class
token, a positional table for 224-pixel inputs, ``ln_pre``, pre-LN blocks
with a fused QKV projection with biases and a 4x QuickGELU MLP, then
``ln_post`` and ``proj``."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark import weights


def state_dict(seed: int, clip: dict, published: dict, device) -> Dict[str, torch.Tensor]:
    """The tower in OpenAI's key layout, fp32, with trained-like LayerNorms
    (gain about 1, bias about 0.1)."""
    w, layers, patch = clip["vision_width"], clip["vision_layers"], clip["patch_size"]
    embed, grid = clip["embed_dim"], 224 // clip["patch_size"]
    specs = [
        ("visual.class_embedding", (w,), 0.0, w ** -0.5),
        ("visual.positional_embedding", (grid * grid + 1, w), 0.0, w ** -0.5),
        ("visual.proj", (w, embed), 0.0, w ** -0.5),
        ("visual.conv1.weight", (w, 3, patch, patch), 0.0, (3 * patch * patch) ** -0.5),
        ("visual.ln_pre.weight", (w,), 1.0, 0.1), ("visual.ln_pre.bias", (w,), 0.0, 0.1),
        ("visual.ln_post.weight", (w,), 1.0, 0.1), ("visual.ln_post.bias", (w,), 0.0, 0.1),
    ]
    for i in range(layers):
        p = f"visual.transformer.resblocks.{i}."
        specs += [
            (p + "attn.in_proj_weight", (3 * w, w), 0.0, w ** -0.5),
            (p + "attn.in_proj_bias", (3 * w,), 0.0, 0.02),
            (p + "attn.out_proj.weight", (w, w), 0.0, w ** -0.5),
            (p + "attn.out_proj.bias", (w,), 0.0, 0.02),
            (p + "mlp.c_fc.weight", (4 * w, w), 0.0, w ** -0.5),
            (p + "mlp.c_fc.bias", (4 * w,), 0.0, 0.02),
            (p + "mlp.c_proj.weight", (w, 4 * w), 0.0, (4 * w) ** -0.5),
            (p + "mlp.c_proj.bias", (w,), 0.0, 0.02),
            (p + "ln_1.weight", (w,), 1.0, 0.1), (p + "ln_1.bias", (w,), 0.0, 0.1),
            (p + "ln_2.weight", (w,), 1.0, 0.1), (p + "ln_2.bias", (w,), 0.0, 0.1),
        ]
    return weights.flat_normal(weights.generator(seed, 1, device), specs, device)


def block_products(clip: dict, published: dict, rows: int,
                   length: int) -> List[Tuple[int, int, int]]:
    """The fused QKV projection, the attention's output projection and the
    MLP's two products."""
    d, m = clip["vision_width"], rows * length
    return [(m, d, 3 * d), (m, d, d), (m, d, 4 * d), (m, 4 * d, d)]
