"""A bounded ``torch.profiler`` stretch, kept in memory, and its reductions.

``Stretch`` records the device activity (kernels, copies, sets) and the host
operations of a stretch of steady steps or batches.  The reductions: the
union of device spans (busy time), the idle gaps between them named by the
host operation that was running when each began, device time by kernel
name, the launches, and the time of the kernels a set of name patterns
matches.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Sequence, Tuple


def union_seconds(spans: Sequence[Tuple[float, float]]) -> float:
    """Total length of the union of (start, end) spans (same unit out)."""
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


class Stretch:
    """``start()`` ... ``stop()`` around the traced steps; then the
    reductions.  Times are seconds."""

    def __init__(self):
        self.prof = None
        self.wall_s = 0.0
        self.device: List[Tuple[str, float, float]] = []   # (name, start, end) us
        self.host: List[Tuple[str, float, float]] = []

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self.prof.stop()
        for e in self.prof.events():
            rng = (e.name, e.time_range.start, e.time_range.end)
            if e.device_type == torch.autograd.DeviceType.CUDA:
                # an annotation mirrored onto the device timeline is not work
                if not getattr(e, "is_user_annotation", False):
                    self.device.append(rng)
            elif e.cpu_parent is None:
                self.host.append(rng)
        self.prof = None

    # -- reductions ------------------------------------------------------
    def busy_s(self) -> float:
        return union_seconds([(s, e) for _, s, e in self.device]) / 1e6

    def launches(self) -> int:
        return len(self.device)

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, s, e in self.device:
            out[n] = out.get(n, 0.0) + (e - s) / 1e6
        return out

    def matching_s(self, patterns) -> Optional[float]:
        """Device seconds of the operations whose names match any pattern;
        None where none ran."""
        hits = [(e - s) / 1e6 for n, s, e in self.device
                if any(p.search(n) for p in patterns)]
        return sum(hits) if hits else None

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """The ``top`` longest gaps between device spans, each named by the
        top-level host operation running when it began."""
        spans = sorted((s, e) for _, s, e in self.device)
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        gaps = []
        for (s0, e0), (s1, _) in zip(merged, merged[1:]):
            i = bisect.bisect_right(starts, e0) - 1
            name = (host[i][0] if i >= 0 and host[i][2] >= e0
                    else "python outside torch operations")
            gaps.append((name, (s1 - e0) / 1e6))
        gaps.sort(key=lambda g: -g[1])
        return gaps[:top]

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in self.idle_gaps(top)]}
