"""The plain math of the toy tower (``draw.py``), added to a copy of the
benchmark as ``reference/towers/toy_clip.py``: OpenAI's tower without
``ln_pre``.  Its blocks and its output are OpenAI's (the MLP takes its width
from the weights)."""

from __future__ import annotations

import torch

from benchmark.reference import vit
from benchmark.reference.towers import openai_clip

block_forward, tap = openai_clip.block_forward, openai_clip.tap
block_from_tap, out = openai_clip.block_from_tap, openai_clip.out


def tree(sd, clip, published):
    f = lambda k: sd[k].float()
    return {"conv1_w": f("visual.conv1.weight"), "class_embedding": f("visual.class_embedding"),
            "positional_embedding": f("visual.positional_embedding"),
            "blocks": openai_clip.blocks(sd, clip.vision_layers),
            "ln_post": {"g": f("visual.ln_post.weight"), "b": f("visual.ln_post.bias")},
            "proj": f("visual.proj")}


def embed(params, img, pos_emb, valid, grid, cfg, policy):
    b = img.shape[0]
    x = vit.patchify(img, params["conv1_w"], cfg.patch_size, policy)
    cls = params["class_embedding"].float()[None, None, :].expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + pos_emb.float()
    return x.masked_fill(~valid.bool()[..., None], 0.0)
