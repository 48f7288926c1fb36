"""Each fault a cell can have, planted under the timed path of a tiny run on
the CPU (the harness's look for a card skipped), turns ``correct`` false."""

from __future__ import annotations

import pytest

from benchmark import faults
from benchmark.tests.conftest import tiny_run


def test_sound_runs_are_correct(tiny_bench):
    spec, run_mod = tiny_bench
    for cell in ("tiny-train", "tiny-comer-train", "tiny-eval", "tiny-eval-segonly"):
        _, line = tiny_run(spec, run_mod, cell)
        assert line["correct"], (cell, line["checks"])


@pytest.mark.parametrize("fault,cell,number", [
    ("unchanged", "tiny-train", "update"),
    ("unchanged", "tiny-comer-train", "update"),
    ("half_batch", "tiny-train", "loss"),
    ("half_batch", "tiny-comer-train", "loss"),
    ("altered_answer", "tiny-eval", "logits"),
    ("altered_answer", "tiny-eval-segonly", "logits"),
    ("half_hists", "tiny-eval", "hists"),
    ("half_hists", "tiny-eval-segonly", "hists"),
    ("gradcam_rows_shifted", "tiny-train", "cam"),
    ("gradcam_rows_shifted", "tiny-comer-train", "cam"),
    ("gradcam_rows_shifted", "tiny-eval", "cam"),
    ("map_transposed", "tiny-train", "attn_map"),
    ("map_transposed", "tiny-eval", "attn_map"),
    ("par_iteration_short", "tiny-train", "par"),
    ("par_iteration_short", "tiny-eval", "par"),
])
def test_a_planted_fault_is_not_correct(tiny_bench, fault, cell, number):
    spec, run_mod = tiny_bench
    with faults.FAULTS[fault]():
        _, line = tiny_run(spec, run_mod, cell)
    assert not line["correct"], line["checks"]
    assert line["checks"][number]["value"] > line["checks"][number]["limit"]
