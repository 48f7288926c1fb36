"""Running-average meter (port of weclip_tpu/utils/meters.py)."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict


class AverageMeter:
    def __init__(self, *names: str):
        self._sum: Dict[str, float] = defaultdict(float)
        self._cnt: Dict[str, int] = defaultdict(int)

    def add(self, values: Dict[str, float]) -> None:
        for k, v in values.items():
            self._sum[k] += float(v)
            self._cnt[k] += 1

    def get(self, key: str) -> float:
        return self._sum[key] / max(self._cnt[key], 1)

    def pop(self, key: str) -> float:
        v = self.get(key)
        self._sum[key] = 0.0
        self._cnt[key] = 0
        return v
