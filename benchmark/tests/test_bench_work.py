"""The operation counts of ``benchmark/work.py`` against
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference, part
by part, at a tiny size on the CPU."""

from __future__ import annotations

from pathlib import Path

import pytest
import torch

from benchmark import work
from benchmark.reference import comer, drive, heads, precision
from benchmark.tests import tiny

# every tower of the benchmark, each counted against its own reference
TOWERS = sorted(p.stem for p in (Path(__file__).resolve().parents[1] / "towers").glob("*.py")
                if p.stem != "__init__")


def _sum(ops):
    return sum(o.flops for o in ops)


@pytest.mark.parametrize("tower", TOWERS)
@pytest.mark.parametrize("export", [True, False])
def test_vit_forward(tower, export):
    got, want = tiny.vit_flops(tower, export)
    assert got == want


def test_heads_forward_and_backward():
    d, cfg, frozen, params = tiny.reference_setup()
    b, p = 2, 16
    tokens = torch.randn(cfg.clip.vision_layers - 1, b, p, cfg.clip.vision_width)
    valid = torch.ones(b, p)
    hp = precision.make_policy("float32")

    def fwd():
        fused = heads.fuse_forward(params["head"]["fuse"], tokens, None, policy=hp)
        seg, _ = heads.decoder_forward(params["head"]["decoder"], fused, valid_p=valid,
                                       policy=hp)
        aff = drive.weclip.aff.gram_affinity(fused, valid)
        return seg.sum() + aff.sum()

    assert tiny.flops(fwd) == _sum(work.heads(d, [p] * b, backward=False))
    leaves = drive.step.param_leaves(params["head"])
    for t in leaves:
        t.requires_grad_(True)
    assert tiny.flops(lambda: fwd().backward()) == _sum(work.heads(d, [p] * b, backward=True))


@pytest.mark.parametrize("tower", TOWERS)
def test_gradcam_forward_and_backward(tower):
    got, want = tiny.gradcam_flops(tower)
    assert got == want


def test_comer_forward_and_backward():
    d, cfg, frozen, params = tiny.reference_setup(comer=True)
    b, g = 2, 4
    img = torch.randn(b, 3, g * 16, g * 16)
    tokens = torch.randn(cfg.clip.vision_layers - 1, b, g * g, cfg.clip.vision_width).bfloat16()
    valid = torch.ones(b, g * g, dtype=torch.bool)

    def fwd():
        return comer.comer_forward(params["comer"], img, tokens, valid, cfg.comer,
                                   precision.DEFAULT).float().sum()

    items = [(g * 16, g * 16, g * g)] * b
    assert tiny.flops(fwd) == _sum(work.comer(d, items, backward=False))
    for t in drive.step.param_leaves(params["comer"]):
        t.requires_grad_(True)
    assert tiny.flops(lambda: fwd().backward()) == _sum(work.comer(d, items, backward=True))


def test_least_time_takes_the_larger_bound():
    op = work.Op("attention", 989e12, 0.0, "bf16")
    assert op.least_s() == pytest.approx(1.0)
    op = work.Op("par", 0.0, 3.35e12, "fp32_fma")
    assert op.least_s() == pytest.approx(1.0)
    assert work.product_seconds([op]) == 0.0
