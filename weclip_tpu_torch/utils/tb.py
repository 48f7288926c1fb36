"""Scalar logging (port of weclip_tpu/utils/tb.py): every record goes to
``scalars.jsonl``, and to TensorBoard through ``torch.utils.tensorboard``
where ``use_tensorboard`` is set and it imports."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class ScalarWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def add_scalars(self, tag: str, values: Dict[str, float], step: int):
        """One record ``{"tag", "step", "time", **values}``."""
        rec = {"tag": tag, "step": step, "time": time.time(), **values}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(f"{tag}/{k}", v, step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
