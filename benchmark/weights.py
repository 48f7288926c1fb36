"""Seeded weights, made on the device in a few large draws.

- the CLIP vision tower, drawn by the configuration's tower
  (``towers/<tower>.py``) in its checkpoint's state-dict layout
  (``visual.*`` keys, fp32); the text tower is never run (the class
  features are seeded unit vectors), so it is a one-block stub of width 8
  that only fills the layout's text keys;
- unit-norm foreground and background class features;
- the trainable tree, one value per leaf of the shapes the port's
  ``init_trainable_params`` gives: norm gains 1 + 0.1 n, biases 0.02 n,
  weights n / sqrt(fan_in), with n standard normal.  CoMer's zero-started
  output projections get values too, or the branch would add exactly 0.

Each tree is drawn as one flat tensor and cut into views, so the draws are
a handful of kernel launches whatever the number of leaves.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark import towers

# background prompt-table sizes of the reference's class tables
NUM_BG = {"voc": 25, "coco": 23}


def flat_normal(gen: torch.Generator, specs: List[Tuple[str, tuple, float, float]],
                device) -> Dict[str, torch.Tensor]:
    """{name: mean + std * n} over one draw of sum(numel) normals."""
    sizes = [math.prod(s) for _, s, _, _ in specs]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (name, shape, mean, std), n in zip(specs, sizes):
        out[name] = flat[off:off + n].view(shape).mul_(std).add_(mean)
        off += n
    return out


def generator(seed: int, stream: int, device) -> torch.Generator:
    """The generator of one of the run's draws (``stream``: 1 the image
    tower, 2 the class features, 3 the trainable values)."""
    return torch.Generator(device=device).manual_seed(_seed(seed, stream))


def clip_state_dict(seed: int, clip: dict, device, tower: str = "openai_clip",
                    published: dict = None) -> Dict[str, torch.Tensor]:
    """The vision tower of ``clip`` (the configuration's ``clip`` sizes),
    drawn by the module of ``towers/`` named ``tower`` from the
    configuration's ``published`` sizes, plus a width-8 text stub in
    OpenAI's layout and the logit scale.  A caller that names no tower, as
    the port's patch-14 tests, gets OpenAI's, the one the port's loader
    reads."""
    sd = towers.load(tower).state_dict(seed, clip, published, device)
    embed = clip["embed_dim"]
    tw = 8
    stub = {"token_embedding.weight": (4, tw), "positional_embedding": (4, tw),
            "text_projection": (tw, embed), "ln_final.weight": (tw,),
            "ln_final.bias": (tw,)}
    p = "transformer.resblocks.0."
    stub.update({p + "attn.in_proj_weight": (3 * tw, tw), p + "attn.in_proj_bias": (3 * tw,),
                 p + "attn.out_proj.weight": (tw, tw), p + "attn.out_proj.bias": (tw,),
                 p + "mlp.c_fc.weight": (4 * tw, tw), p + "mlp.c_fc.bias": (4 * tw,),
                 p + "mlp.c_proj.weight": (tw, 4 * tw), p + "mlp.c_proj.bias": (tw,),
                 p + "ln_1.weight": (tw,), p + "ln_1.bias": (tw,),
                 p + "ln_2.weight": (tw,), p + "ln_2.bias": (tw,)})
    for k, s in stub.items():
        sd[k] = torch.zeros(s, device=device)
    sd["logit_scale"] = torch.tensor(math.log(1 / 0.07), device=device)
    return sd


def class_features(seed: int, num_fg: int, num_bg: int, embed: int, device):
    """(fg (num_fg, embed), bg (num_bg, embed)) unit-norm rows."""
    t = torch.randn((num_fg + num_bg, embed), generator=generator(seed, 2, device),
                    device=device)
    t = t / t.norm(dim=-1, keepdim=True)
    return t[:num_fg].contiguous(), t[num_fg:].contiguous()


def leaf_paths(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) of a nested dict/list tree, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in leaf_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in leaf_paths(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def _leaf_rule(path: str, shape: tuple) -> Tuple[float, float]:
    key = path.rsplit("/", 1)[-1]
    if key == "g":
        return 1.0, 0.1
    if key == "b" or key.endswith("_b") or len(shape) == 1:
        return 0.0, 0.02
    fan_in = math.prod(shape[-3:]) if len(shape) == 4 else shape[-1]
    return 0.0, fan_in ** -0.5


def trainable_values(seed: int, shapes: List[Tuple[str, tuple]], device
                     ) -> Dict[str, torch.Tensor]:
    """{path: value} for the trainable leaves ``shapes`` ((path, shape) in
    tree order), from one draw."""
    specs = [(p, tuple(s), *_leaf_rule(p, tuple(s))) for p, s in shapes]
    return flat_normal(generator(seed, 3, device), specs, device)


def fill_tree(tree, values: Dict[str, torch.Tensor], prefix: str = ""):
    """A copy of ``tree`` whose leaves are clones of ``values[path]``."""
    if isinstance(tree, dict):
        return {k: fill_tree(v, values, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [fill_tree(v, values, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return values[prefix.rstrip("/")].clone()


def _seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for one of the run's draws."""
    return (int(seed) * 1_000_003 + stream * 7919) % (2 ** 63)
