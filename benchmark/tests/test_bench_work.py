"""The operation counts of ``benchmark/work.py`` against
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference, part
by part, at a tiny size on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import weights, work
from benchmark.reference import comer, drive, gradcam, heads, precision, vit
from benchmark.tests import tiny


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _setup(comer_on: bool = False):
    cfg_file = tiny.tiny_config("t", comer_on)
    d = cfg_file["config"]
    d["num_bg"] = 4
    cfg = drive.from_dict(d)
    sd = weights.clip_state_dict(1, d["clip"], "cpu")
    fg, bg = weights.class_features(1, 5, 4, d["clip"]["embed_dim"], "cpu")
    shapes = [(p, tuple(t.shape)) for p, t in weights.leaf_paths(
        drive.weclip.init_trainable_params(torch.Generator().manual_seed(0), cfg, "cpu"))]
    params = drive.trainable(cfg, weights.trainable_values(1, shapes, "cpu"))
    return d, cfg, drive.frozen_state(sd, fg, bg, cfg), params


def _inputs(cfg, b: int, g: int):
    l = g * g + 1
    img = torch.randn(b, 3, g * 16, g * 16)
    pe = drive.vit.pos_emb_host(np.random.default_rng(0).standard_normal(
        (197, cfg.clip.vision_width)).astype(np.float32), g, g, g, g)
    return img, torch.from_numpy(pe)[None], torch.ones(b, l, dtype=torch.bool)


def _sum(ops):
    return sum(o.flops for o in ops)


@pytest.mark.parametrize("export", [True, False])
def test_vit_forward(export):
    d, cfg, frozen, _ = _setup()
    b, g = 2, 4
    img, pe, valid = _inputs(cfg, b, g)
    got = _flops(lambda: vit.vision_forward_frozen(frozen["visual"], img, pe, valid, cfg.clip,
                                                   precision.DEFAULT, with_attn=export))
    lens = [g * g + 1] * b
    want = _sum(work.patch_embed(d["clip"], lens, "bf16")
                + work.vit_blocks(d["clip"], lens, "bf16", [export] * b,
                                  d["clip"]["vision_layers"] - 1))
    assert got == want


def test_heads_forward_and_backward():
    d, cfg, frozen, params = _setup()
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

    assert _flops(fwd) == _sum(work.heads(d, [p] * b, backward=False))
    leaves = drive.step.param_leaves(params["head"])
    for t in leaves:
        t.requires_grad_(True)
    assert _flops(lambda: fwd().backward()) == _sum(work.heads(d, [p] * b, backward=True))


def test_gradcam_forward_and_backward():
    d, cfg, frozen, _ = _setup()
    b, g, mc = 2, 4, 3
    l = g * g + 1
    x11 = torch.randn(b, l, cfg.clip.vision_width).bfloat16()
    text = torch.cat([frozen["fg_text"], frozen["bg_text"]])
    mask = torch.ones(b, text.shape[0], dtype=torch.bool)
    got = _flops(lambda: gradcam.gradcam_batch(
        frozen["visual"], frozen["logit_scale"], x11, text, mask, torch.ones(b, l, dtype=torch.bool),
        5, cfg.clip, precision.DEFAULT, class_idx=torch.zeros(b, mc, dtype=torch.long)))
    want = _sum(work.gradcam(d["clip"], [l] * b, [mc] * b, text.shape[0], "bf16"))
    assert got == want


def test_comer_forward_and_backward():
    d, cfg, frozen, params = _setup(comer_on=True)
    b, g = 2, 4
    img = torch.randn(b, 3, g * 16, g * 16)
    tokens = torch.randn(cfg.clip.vision_layers - 1, b, g * g, cfg.clip.vision_width).bfloat16()
    valid = torch.ones(b, g * g, dtype=torch.bool)

    def fwd():
        return comer.comer_forward(params["comer"], img, tokens, valid, cfg.comer,
                                   precision.DEFAULT).float().sum()

    items = [(g * 16, g * 16, g * g)] * b
    assert _flops(fwd) == _sum(work.comer(d, items, backward=False))
    for t in drive.step.param_leaves(params["comer"]):
        t.requires_grad_(True)
    assert _flops(lambda: fwd().backward()) == _sum(work.comer(d, items, backward=True))


def test_least_time_takes_the_larger_bound():
    op = work.Op("attention", 989e12, 0.0, "bf16")
    assert op.least_s() == pytest.approx(1.0)
    op = work.Op("par", 0.0, 3.35e12, "fp32_fma")
    assert op.least_s() == pytest.approx(1.0)
    assert work.product_seconds([op]) == 0.0
