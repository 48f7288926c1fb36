"""The control (the plain reference one precision step lower, in the
program's place) comes out not correct against the cells' limits, here at
a tiny size on the CPU; on the card it runs at the cells' own sizes
(``python3 -m benchmark.readings --control``)."""

from __future__ import annotations

import pytest


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-comer-train", "tiny-eval",
                                  "tiny-eval-segonly"])
def test_the_control_fails(tiny_bench, cell):
    spec, _ = tiny_bench
    from benchmark import readings
    limits = spec.workload(cell)["limits"]
    for seed in (11, 4_294_967_296 + 5):
        numbers = readings.control_numbers(spec, cell, seed, device="cpu")
        assert any(numbers[k] > limits[k] for k in limits if k in numbers), numbers
