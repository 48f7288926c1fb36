"""Checkpoints with step metadata (port of weclip_tpu/train/checkpoint.py).

A checkpoint is a ``step_%08d`` directory under a base directory, as in the
JAX package.  The port writes one file into it, ``state.pt``: a
``torch.save`` of the parameter tree (on the CPU), the step and, for
resuming, the optimizer's and the lr scheduler's state dicts.  It is
written to a temporary name and renamed, so a checkpoint is whole or
absent.  ``restore`` also reads the JAX package's Orbax checkpoints (any
``step_N`` directory without ``state.pt``), params only, through
``convert.params_from_jax``; Orbax is imported only then.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from weclip_tpu_torch.models.clip import vit

STATE_FILE = "state.pt"


def _ckpt_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:08d}")


def save(base_dir: str, step: int, params: Dict[str, Any], optimizer=None,
         scheduler=None) -> str:
    """Write ``params`` (and the optimizer and scheduler state, where given)
    as step ``step``; returns the checkpoint's directory."""
    path = os.path.abspath(_ckpt_dir(base_dir, step))
    os.makedirs(path, exist_ok=True)
    ckpt = {"params": vit.tree_map(lambda t: t.detach().cpu().clone(), params),
            "step": int(step)}
    if optimizer is not None:
        ckpt["optimizer"] = optimizer.state_dict()
    if scheduler is not None:
        ckpt["scheduler"] = scheduler.state_dict()
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(ckpt, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def latest_step(base_dir: str) -> Optional[int]:
    if not os.path.isdir(base_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(base_dir) if d.startswith("step_")]
    return max(steps) if steps else None


def _resolve(base_dir: str, step: Optional[int]) -> Tuple[str, int]:
    """The checkpoint directory and its step: ``base_dir`` may itself be a
    ``step_N`` directory."""
    tail = os.path.basename(os.path.normpath(base_dir))
    if step is None and tail.startswith("step_") and os.path.isdir(base_dir):
        return os.path.abspath(base_dir), int(tail.split("_")[1])
    if step is None:
        step = latest_step(base_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {base_dir}")
    path = os.path.abspath(_ckpt_dir(base_dir, step))
    if not os.path.isdir(path) and tail.startswith("step_"):
        path = os.path.abspath(base_dir)
    return path, step


def _restore_orbax(path: str) -> Tuple[Dict[str, Any], int]:
    import orbax.checkpoint as ocp

    from weclip_tpu_torch import convert
    with ocp.PyTreeCheckpointer() as ckptr:
        ckpt = ckptr.restore(path)

    def to_np(tree):
        if isinstance(tree, dict):
            return {k: to_np(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [to_np(v) for v in tree]
        return np.asarray(tree)

    return convert.params_from_jax(to_np(ckpt["params"])), int(np.asarray(ckpt["step"]))


def restore(base_dir: str, step: Optional[int] = None, device="cpu"
            ) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]], int]:
    """(params on ``device``, the saved state or None, step) of step
    ``step`` under ``base_dir`` (default: the latest), or of the ``step_N``
    directory ``base_dir``.  The saved state holds ``optimizer`` and
    ``scheduler`` state dicts, where they were saved; an Orbax checkpoint
    of the JAX package gives params only."""
    path, step = _resolve(base_dir, step)
    state_file = os.path.join(path, STATE_FILE)
    if not os.path.exists(state_file):
        params, step = _restore_orbax(path)
        return vit.tree_map(lambda t: t.to(device), params), None, step
    ckpt = torch.load(state_file, map_location="cpu", weights_only=True)
    params = vit.tree_map(lambda t: t.to(device), ckpt["params"])
    state = {k: ckpt[k] for k in ("optimizer", "scheduler") if k in ckpt}
    return params, state or None, int(ckpt["step"])
