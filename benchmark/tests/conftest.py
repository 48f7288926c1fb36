"""Fixtures of the benchmark's tests: a tiny copy of the benchmark (new
files only) for runs on the CPU, and the modules loaded from it."""

from __future__ import annotations

import sys

import pytest

from benchmark.tests import tiny


@pytest.fixture(scope="session")
def tiny_copy(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def tiny_bench(tiny_copy):
    """(spec, run module) of the tiny copy; this checkout's modules come
    back afterwards."""
    saved = {k: v for k, v in sys.modules.items()
             if k == "benchmark" or k.startswith("benchmark.")}
    spec, run_mod = tiny.load(tiny_copy)
    yield spec, run_mod
    for k in [m for m in sys.modules if m == "benchmark" or m.startswith("benchmark.")]:
        del sys.modules[k]
    sys.modules.update(saved)


def tiny_run(spec, run_mod, cell: str, trace: bool = False, seconds: float = 1.5,
             seed: int = 4_294_967_311):
    """One run of a tiny cell on the CPU, and its last line's object."""
    import time
    import torch
    torch.manual_seed(0)
    run, _ = run_mod.measure(spec, cell, seed, seconds, trace, device="cpu",
                             t_start=time.perf_counter())
    line = run_mod.result_line(spec, cell, run, trace, {"platform": "cpu", "kind": "cpu",
                                                        "count": 1,
                                                        "memory_peak_bytes": 0})
    return run, line
