"""A toy image tower for the benchmark's tests, added to a copy of the
benchmark as ``towers/toy_clip.py`` (``tiny.make_copy``): OpenAI's CLIP
tower without ``ln_pre``, its MLP ``published["mlp_ratio"]`` times the
width."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark import weights


def state_dict(seed: int, clip: dict, published: dict, device) -> Dict[str, torch.Tensor]:
    w, layers, patch = clip["vision_width"], clip["vision_layers"], clip["patch_size"]
    hidden, grid = published["mlp_ratio"] * w, 224 // patch
    specs = [
        ("visual.class_embedding", (w,), 0.0, w ** -0.5),
        ("visual.positional_embedding", (grid * grid + 1, w), 0.0, w ** -0.5),
        ("visual.proj", (w, clip["embed_dim"]), 0.0, w ** -0.5),
        ("visual.conv1.weight", (w, 3, patch, patch), 0.0, (3 * patch * patch) ** -0.5),
        ("visual.ln_post.weight", (w,), 1.0, 0.1), ("visual.ln_post.bias", (w,), 0.0, 0.1),
    ]
    for i in range(layers):
        p = f"visual.transformer.resblocks.{i}."
        specs += [
            (p + "attn.in_proj_weight", (3 * w, w), 0.0, w ** -0.5),
            (p + "attn.in_proj_bias", (3 * w,), 0.0, 0.02),
            (p + "attn.out_proj.weight", (w, w), 0.0, w ** -0.5),
            (p + "attn.out_proj.bias", (w,), 0.0, 0.02),
            (p + "mlp.c_fc.weight", (hidden, w), 0.0, w ** -0.5),
            (p + "mlp.c_fc.bias", (hidden,), 0.0, 0.02),
            (p + "mlp.c_proj.weight", (w, hidden), 0.0, hidden ** -0.5),
            (p + "mlp.c_proj.bias", (w,), 0.0, 0.02),
            (p + "ln_1.weight", (w,), 1.0, 0.1), (p + "ln_1.bias", (w,), 0.0, 0.1),
            (p + "ln_2.weight", (w,), 1.0, 0.1), (p + "ln_2.bias", (w,), 0.0, 0.1),
        ]
    return weights.flat_normal(weights.generator(seed, 1, device), specs, device)


def block_products(clip: dict, published: dict, rows: int,
                   length: int) -> List[Tuple[int, int, int]]:
    d, m = clip["vision_width"], rows * length
    hidden = published["mlp_ratio"] * d
    return [(m, d, 3 * d), (m, d, d), (m, d, hidden), (m, hidden, d)]
