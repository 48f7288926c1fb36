"""On a card: one short run of each cell is correct and prints the
contract's last line.  Skips without a card; run on the card with
``python3 -m pytest --noconftest -m cuda benchmark/tests/test_bench_card.py``."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("cell", ["voc-train", "comer-train", "voc-eval"])
def test_a_short_run_is_correct(card, cell):
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell,
                           "--seed", "8589934597", "--seconds", "3", "--trace", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
    for name, m in line["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100, (name, m)
