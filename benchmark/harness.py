"""What every mix shares: the run's context, its record, the program's
set-up, and the checks that close a run."""

from __future__ import annotations

import copy
import os
import shutil
import subprocess
import sys
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from benchmark import work
from benchmark.spec import Spec
from benchmark.trace import Stretch

FORBIDDEN = ("jax", "jaxlib", "flax", "weclip_tpu")


@dataclass
class Context:
    spec: Spec
    cell_name: str
    cell: dict
    config: dict          # the configuration file
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float        # the process's start on the host clock
    log: object = None    # print function for the earlier lines (stderr)

    def cfg_dict(self) -> dict:
        """What the work functions read of the configuration
        (``work.config_dict``)."""
        return work.config_dict(self.config)


@dataclass
class Run:
    """A run's record: what the last line and the metric readers read."""
    e2e: Dict[str, float] = field(default_factory=dict)
    checks: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    numbers: Dict[str, float] = field(default_factory=dict)   # every number read
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    # the traced stretch (``--trace 1``), its units and their work
    stretch: Optional[Stretch] = None
    stretch_units: int = 0
    stretch_ops: List[work.Op] = field(default_factory=list)
    # the untraced part of the window: its seconds, steps or batches, and
    # their work (for mfu and the idle share)
    untraced_s: float = 0.0
    untraced_units: int = 0
    untraced_ops: List[work.Op] = field(default_factory=list)
    # the 95th percentile of the untraced steps' host-clock times (ms)
    step_p95_ms: Optional[float] = None
    # host spans of the window: name -> durations (s)
    host: Dict[str, List[float]] = field(default_factory=dict)
    spec: Optional[Spec] = None

    def kernel_s(self, layer: str) -> Optional[float]:
        if self.stretch is None:
            return None
        return self.stretch.matching_s(self.spec.kernel_patterns(layer))

    def roofline(self, layer: str) -> Optional[float]:
        """100 x the least time of the stretch's ``layer`` work over the
        device time of the layer's kernels; None where none ran."""
        t = self.kernel_s(layer)
        least = work.least_seconds(self.stretch_ops, layer) if self.stretch else 0.0
        if not t or not least:
            return None
        return 100.0 * least / t

    def mfu(self) -> Optional[float]:
        if not self.untraced_s or not self.untraced_ops:
            return None
        return 100.0 * work.product_seconds(self.untraced_ops) / self.untraced_s

    def idle(self) -> Optional[float]:
        """100 x (1 - the device's busy seconds a traced step or batch over
        the host seconds an untraced one takes): the profiler slows the
        host, so the traced stretch's own wall would count its overhead as
        idle."""
        if self.stretch is None or not self.stretch_units or not self.untraced_units:
            return None
        busy = self.stretch.busy_s() / self.stretch_units
        return 100.0 * (1.0 - busy / (self.untraced_s / self.untraced_units))


def scratch_dir(name: str) -> str:
    """A fresh directory under TMPDIR for this run's files."""
    return tempfile.mkdtemp(prefix=f"weclip_bench_{name}_")


def remove(path: str) -> None:
    shutil.rmtree(path, ignore_errors=True)


def program_config(ctx: Context, dataset: Dict[str, str]):
    """The port's Config for this run: the configuration's overlay, the
    synthetic tree's paths, and the seed as the training seed."""
    from weclip_tpu_torch.core.config import from_dict
    d = copy.deepcopy(ctx.config["config"])
    d.setdefault("dataset", {}).update(dataset)
    d.setdefault("train", {})["seed"] = ctx.seed
    return from_dict(d), d


def build_kernels(device: str) -> None:
    """Build or load every kernel library before anything is timed."""
    if device.startswith("cuda"):
        from weclip_tpu_torch import kernels
        kernels.build()
        for name in kernels.SIGNATURES:
            kernels.lib(name)


def _smi(query: str) -> str:
    try:
        return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def card_line() -> str:
    """The card's name and power limit."""
    return _smi("name,power.limit")


def clock_line() -> str:
    """SM and memory clocks, power draw, temperature and active throttle
    reasons, read as a window closes."""
    return _smi("clocks.sm,clocks.mem,power.draw,temperature.gpu,"
                "clocks_throttle_reasons.active")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def sync(dev: str) -> None:
    import torch
    if dev.startswith("cuda"):
        torch.cuda.synchronize()


def free(dev: str) -> None:
    """Return the freed blocks of the caching allocator to the card."""
    import torch
    if dev.startswith("cuda"):
        torch.cuda.empty_cache()


def peak_bytes(dev: str) -> int:
    """The process's peak of allocated device memory."""
    import torch
    return int(torch.cuda.max_memory_allocated()) if dev.startswith("cuda") else 0
