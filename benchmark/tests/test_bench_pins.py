"""Pins of what the benchmark draws and counts for each configuration, on
the CPU: the seeded state dict (each key, its shape and its float64 sum, in
order) and the work of a training step and of an evaluation batch at fixed
sizes (each layer's operations, bytes and least time, and the products'
time at their peaks).  ``pins.json`` was recorded from the tree before the
vision tower moved into files of its own (``towers/``), so these hold the
configurations' weights and their ``mfu`` and roofline inputs where they
were."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark import weights, work
from benchmark.spec import Spec

PINS = json.loads((Path(__file__).resolve().parent / "pins.json").read_text())
CONFIGS = sorted(PINS["configs"])


def test_every_configuration_is_pinned():
    assert sorted(c["name"] for c in Spec().bench["configs"]) == CONFIGS


@pytest.mark.parametrize("name", CONFIGS)
def test_the_seeded_state_dict_is_unchanged(name):
    config = Spec().config(name)
    sd = weights.clip_state_dict(PINS["seed"], config["config"]["clip"], "cpu",
                                 config["tower"], config["published"])
    got = [[k, list(v.shape), float(np.sum(v.numpy(), dtype=np.float64))]
           for k, v in sd.items()]
    assert got == PINS["configs"][name]["state_dict"]


def _totals(ops):
    out = {}
    for layer in ("dense", "attention", "par"):
        sel = [o for o in ops if o.layer == layer]
        out[layer] = {"ops": len(sel), "flops": sum(o.flops for o in sel),
                      "bytes": sum(o.bytes for o in sel),
                      "least_s": work.least_seconds(sel)}
    out["product_s"] = work.product_seconds(ops)
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_the_work_counts_are_unchanged(name):
    d = work.config_dict(Spec().config(name))
    sizes, mcs = PINS["eval_sizes"], PINS["eval_mcs"]
    got = {"train_step": _totals(work.train_step(d, PINS["train_mcs"])),
           "eval_batch": _totals(work.eval_batch(d, sizes, True, mcs)),
           "eval_batch_segonly": _totals(work.eval_batch(d, sizes, False, mcs))}
    want = PINS["configs"][name]["work"]
    for call, layers in want.items():
        for layer, t in layers.items():
            if layer == "product_s":
                assert got[call][layer] == pytest.approx(t, rel=1e-12), (call, layer)
                continue
            # operations and bytes are whole numbers, exact in any order
            assert {k: got[call][layer][k] for k in ("ops", "flops", "bytes")} == {
                k: t[k] for k in ("ops", "flops", "bytes")}, (call, layer)
            assert got[call][layer]["least_s"] == pytest.approx(t["least_s"], rel=1e-12)
