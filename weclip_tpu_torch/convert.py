"""Carry the JAX package's weights into the port.

``weclip_tpu`` keeps its parameters as nested dicts of arrays.  Given those
as nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray, t)``),
this module returns the port's trees of fp32 torch tensors:

- the CLIP ``visual`` tree, transformer blocks stacked on a leading axis
  and the attention weights already in torch layout (``in_w`` (3D, D),
  ``out_w`` (D, D));
- the frozen state: ``visual``, ``logit_scale``, ``fg_text``, ``bg_text``;
- the trainable ``head`` tree: the fuse projections stacked on a leading
  layer axis, the decoder blocks stacked like the ViT's;
- the trainable ``comer`` tree of the ViT-CoMer branch, whose ``mrfp``
  (one per pyramid level) and ``cti`` (one per interaction) entries are
  lists of dicts.

Both packages use the same key names and layouts, so the conversion checks
the structure and converts the leaves; ``to_numpy`` goes back.  The text
tower is not carried: the port takes the class text embeddings as inputs.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

Params = Dict[str, Any]

_LN = ("g", "b")
_MHA = ("in_w", "in_b", "out_w", "out_b")
_MLP = ("fc_w", "fc_b", "proj_w", "proj_b")
_BLOCK = {"ln_1": _LN, "attn": _MHA, "ln_2": _LN, "mlp": _MLP}
_VISUAL = {"conv1_w": None, "class_embedding": None,
           "positional_embedding": None, "ln_pre": _LN, "blocks": _BLOCK,
           "ln_post": _LN, "proj": None}
_FUSE = {k: None for k in ("proj1_w", "proj1_b", "proj2_w", "proj2_b",
                           "fuse_w", "fuse_b")}
_HEAD = {"fuse": _FUSE,
         "decoder": {"blocks": _BLOCK, "pred_w": None, "pred_b": None}}
_XATTN = tuple(f"{m}_{p}" for m in "qkvo" for p in "wb")
_CTI = {"inj": _XATTN, "ext": _XATTN, "ln_q": _LN, "ln_kv": _LN}
_COMER = {"stem": {**{f"conv{i}_w": None for i in range(1, 6)},
                   **{f"gn{i}": _LN for i in range(1, 6)}},
          "vit_proj_w": None, "vit_proj_b": None, "mrfp": None, "cti": None,
          "out_gn": _LN, "out_w": None, "out_b": None,
          **{f"lvl_proj_{n}_{p}": None for n in ("c3", "c4", "c5") for p in "wb"}}


def _select(tree: Mapping, spec, where: str):
    """The part of ``tree`` that ``spec`` names (a dict of sub-specs, a
    tuple of leaf keys, or None for a leaf); raises on a missing key."""
    if spec is None:
        return tree
    if not isinstance(tree, Mapping):
        raise TypeError(f"{where}: expected a dict, got {type(tree).__name__}")
    keys = spec if isinstance(spec, tuple) else tuple(spec)
    missing = [k for k in keys if k not in tree]
    if missing:
        raise KeyError(f"{where}: missing {missing}")
    if isinstance(spec, tuple):
        return {k: tree[k] for k in keys}
    return {k: _select(tree[k], spec[k], f"{where}.{k}") for k in keys}


def _tensors(tree, device, where: str):
    if isinstance(tree, Mapping):
        return {k: _tensors(v, device, f"{where}.{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, device, f"{where}[{i}]") for i, v in enumerate(tree)]
    arr = np.asarray(tree)
    if arr.dtype.kind in "biuOSU":
        raise TypeError(f"{where}: expected floating weights, got {arr.dtype}")
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device)


def _leaves(tree) -> Sequence:
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _check_stacked(blocks: Mapping, where: str) -> None:
    depths = {np.shape(x)[0] for x in _leaves(blocks)}
    if len(depths) != 1:
        raise ValueError(f"{where}: blocks stacked to unequal depths {sorted(depths)}")


def visual_from_jax(visual: Mapping, device="cpu") -> Params:
    """The CLIP vision tower (``clip_params["visual"]``)."""
    tree = _select(visual, _VISUAL, "visual")
    _check_stacked(tree["blocks"], "visual.blocks")
    return _tensors(tree, device, "visual")


def head_from_jax(head: Mapping, device="cpu") -> Params:
    """The fuse + decoder heads (``params["head"]``)."""
    tree = _select(head, _HEAD, "head")
    _check_stacked({k: v for k, v in tree["fuse"].items()
                    if k.startswith("proj")}, "head.fuse")
    _check_stacked(tree["decoder"]["blocks"], "head.decoder.blocks")
    return _tensors(tree, device, "head")


def frozen_from_jax(frozen: Mapping, device="cpu") -> Params:
    """The frozen state of ``weclip.build_frozen_state``."""
    _select(frozen, ("visual", "logit_scale", "fg_text", "bg_text"), "frozen")
    out = {"visual": visual_from_jax(frozen["visual"], device)}
    for k in ("logit_scale", "fg_text", "bg_text"):
        out[k] = _tensors(frozen[k], device, k)
    return out


def comer_from_jax(comer: Mapping, device="cpu") -> Params:
    """The ViT-CoMer branch (``params["comer"]``)."""
    tree = _select(comer, _COMER, "comer")
    if len(tree["mrfp"]) != 3:
        raise ValueError(f"comer.mrfp: expected 3 pyramid levels, got {len(tree['mrfp'])}")
    mrfp = []
    for i, branch in enumerate(tree["mrfp"]):
        convs = tuple(k for k in branch if k.startswith("d") and k.endswith("_w"))
        if not convs:
            raise KeyError(f"comer.mrfp[{i}]: no dilated convolutions")
        mrfp.append(_select(branch, {**{k: None for k in convs}, "fuse_w": None,
                                     "gn": _LN}, f"comer.mrfp[{i}]"))
    tree["mrfp"] = mrfp
    tree["cti"] = [_select(c, _CTI, f"comer.cti[{i}]") for i, c in enumerate(tree["cti"])]
    return _tensors(tree, device, "comer")


def params_from_jax(params: Mapping, device="cpu") -> Params:
    """The trainable parameters: ``{"head": ...}``, and ``"comer"`` where
    the JAX tree has the branch."""
    out = {"head": head_from_jax(params["head"], device)}
    if "comer" in params:
        out["comer"] = comer_from_jax(params["comer"], device)
    return out


def to_numpy(tree) -> Any:
    """A port tree back to nested dicts (and lists) of fp32 numpy arrays."""
    if isinstance(tree, Mapping):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return tree.detach().to("cpu", torch.float32).numpy()
