"""The frozen ViT block's fused passes (csrc/block_epilogue.cu) on the card:
each kernel against its plain twin (ops/block_epilogue.py) at
``vitl14-eval``'s two signatures (16 rows of 1370 and of 842 tokens at
width 1024) and ``voc-train``'s (4 x 401 at 768); the fused frozen forward
replayed from its CUDA graph bit-equal to its eager run, and no further
from the fp32 forward than the plain path; inputs the kernels refuse raise
and launch nothing.  These need a CUDA card with nvcc and skip elsewhere;
run them there with
``python -m pytest --noconftest -m cuda tests/test_torch_block_epilogue_cuda.py``."""

import pytest
import torch

from tests.torch_support import card  # noqa: F401
from weclip_tpu_torch import kernels
from weclip_tpu_torch.core import precision
from weclip_tpu_torch.core.config import ClipConfig
from weclip_tpu_torch.models.clip import graphs, vit
from weclip_tpu_torch.ops import block_epilogue as epi
from weclip_tpu_torch.utils import spans

pytestmark = pytest.mark.cuda

BF = torch.bfloat16
# (B, L, D, H): vitl14-eval's scale 1 and scale 2, voc-train's step
SHAPES = [(16, 1370, 1024, 16), (16, 842, 1024, 16), (4, 401, 768, 12)]


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def _randn(shape, gen, scale=1.0, dtype=BF):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _within_one_rounding(got, want):
    """Each element within one bf16 spacing at the larger magnitude of the
    two, beyond the fp32 arithmetic's own spread before the rounding
    (2^-20 of the largest value: the LayerNorm's statistics are summed in
    another order than torch's)."""
    a, b = got.float(), want.float()
    m = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    spacing = torch.exp2(torch.floor(torch.log2(m)) - 7)
    return bool(((a - b).abs() <= spacing + 2.0 ** -20 * b.abs().max()).all())


def _valid(b, l, gen):
    """Rows with a valid prefix of random length, as padded canvases give."""
    n = torch.randint(1, l + 1, (b,), generator=gen, device="cuda")
    return torch.arange(l, device="cuda")[None, :] < n[:, None]


@pytest.mark.parametrize("b,l,d,h", SHAPES)
def test_qkv_bias_split_matches_its_twin(card, b, l, d, h):
    gen = _gen(0)
    g, bias = _randn((b, l, 3 * d), gen), _randn((3 * d,), gen, 0.5)
    before = kernels.launches["qkv_bias_split"]
    got = epi.qkv_bias_split(g, bias, h)
    want = epi.qkv_bias_split_plain(g, bias, h)
    assert kernels.launches["qkv_bias_split"] == before + 1
    for x, y in zip(got, want):
        assert x.shape == (b, h, l, d // h) and torch.equal(x, y)


@pytest.mark.parametrize("b,l,d,h", SHAPES)
def test_residual_ln_matches_its_twin(card, b, l, d, h):
    gen = _gen(1)
    x, g = _randn((b, l, d), gen), _randn((b, l, d), gen)
    bias = _randn((d,), gen, 0.5)
    ln = (1.0 + _randn((d,), gen, 0.1, torch.float32), _randn((d,), gen, 0.1, torch.float32))
    valid = _valid(b, l, gen)
    out = torch.empty_like(x)
    before = kernels.launches["residual_ln"]
    cases = [  # after the out-projection, after the MLP, the last block, block 0
        dict(ln=ln, x=x, bias=bias, rowmask=valid),
        dict(ln=ln, x=x, bias=bias, out=out),
        dict(ln=None, x=x, bias=bias, out=out),
        dict(ln=ln)]
    for kw in cases:
        y, lo = epi.residual_ln(g, **kw)
        want_y, want_lo = epi.residual_ln_plain(g, **{k: v for k, v in kw.items()
                                                      if k != "out"})
        assert torch.equal(y, want_y), sorted(kw)
        assert (lo is None) == (want_lo is None)
        if lo is not None:
            assert _within_one_rounding(lo, want_lo), sorted(kw)
    assert kernels.launches["residual_ln"] == before + len(cases)


@pytest.mark.parametrize("b,l,d,h", SHAPES)
def test_bias_quick_gelu_matches_its_twin(card, b, l, d, h):
    gen = _gen(2)
    g, bias = _randn((b, l, 4 * d), gen, 3.0), _randn((4 * d,), gen, 0.5)
    want = epi.bias_quick_gelu_plain(g.clone(), bias)
    before = kernels.launches["bias_quick_gelu"]
    got = epi.bias_quick_gelu(g, bias)
    assert kernels.launches["bias_quick_gelu"] == before + 1
    assert got is g and _within_one_rounding(got, want)


def test_kernels_refuse_what_they_do_not_take(card):
    gen = _gen(3)
    before = dict(kernels.launches)
    g12 = _randn((2, 5, 36), gen)                   # D 12: not a multiple of 8
    with pytest.raises(ValueError):
        epi.qkv_bias_split(g12, _randn((36,), gen), 2)
    g = _randn((2, 5, 48), gen)
    with pytest.raises(ValueError):                 # fp32 product
        epi.qkv_bias_split(g.float(), _randn((48,), gen), 2)
    with pytest.raises(ValueError):                 # a bias of another width
        epi.bias_quick_gelu(g, _randn((40,), gen))
    with pytest.raises(ValueError):                 # not 16-byte aligned
        epi.bias_quick_gelu(_randn((2 * 48 + 1,), gen)[1:].view(2, 48), _randn((48,), gen))
    x = _randn((2, 5, 16), gen)
    ln = (torch.ones(16, device="cuda"), torch.zeros(16, device="cuda"))
    with pytest.raises(ValueError):                 # not contiguous
        epi.residual_ln(_randn((2, 16, 5), gen).transpose(1, 2), ln, x=x)
    with pytest.raises(ValueError):                 # bf16 gamma
        epi.residual_ln(x, (ln[0].to(BF), ln[1]))
    with pytest.raises(ValueError):                 # a float row mask
        epi.residual_ln(x, ln, x=x, rowmask=torch.ones((2, 5), device="cuda"))
    with pytest.raises(ValueError):                 # nothing to write
        epi.residual_ln(x, None)
    with pytest.raises(ValueError):                 # wider than a block holds
        epi.residual_ln(_randn((1, 32776), gen), None, bias=_randn((32776,), gen))
    assert dict(kernels.launches) == before


# -- the fused frozen forward -------------------------------------------------

@pytest.fixture(scope="module")
def vitl14():
    """CLIP ViT-L/14 at its published widths, seeded, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = ClipConfig(patch_size=14, vision_width=1024, vision_layers=24, vision_heads=16,
                     embed_dim=768)
    return cfg, vit.init_vision_params(torch.Generator().manual_seed(0), cfg, "cuda")


def _tower_inputs(cfg, b, side, seed):
    gen = _gen(seed)
    n = side // cfg.patch_size
    img = torch.randn((b, 3, side, side), generator=gen, device="cuda")
    pe = torch.randn((b, 1 + n * n, cfg.vision_width), generator=gen, device="cuda") * 0.02
    return img, pe, _valid(b, 1 + n * n, gen)


# (B, side, maps, attn_rows): vitl14-eval's scale 1 (1370 tokens, maps for 8
# rows) and scale 2 (842 tokens, no maps)
VITL14_SIGNATURES = [(16, 518, True, 8), (16, 406, False, None)]


def _counts(name):
    return dict(spans.RECORDER.totals.get(name, {}))


@pytest.mark.parametrize("b,side,with_attn,attn_rows", VITL14_SIGNATURES)
def test_fused_forward_replay_is_bit_equal_to_eager(card, vitl14, monkeypatch, b, side,
                                                    with_attn, attn_rows):
    cfg, params = vitl14
    name = f"test_fused_graph_{side}"
    monkeypatch.setattr(vit, "FROZEN_GRAPHS", graphs.ForwardGraphs(name))
    pol = precision.make_policy("bfloat16")
    k = attn_rows if attn_rows is not None else b
    before = _counts(vit.BLOCK_COUNTER)
    for call in range(3):
        img, pe, valid = _tower_inputs(cfg, b, side, seed=call)
        got = vit.vision_forward_frozen(params, img, pe, valid, cfg, policy=pol,
                                        with_attn=with_attn, attn_rows=attn_rows)
        want = vit._forward_frozen(params, img, pe, valid, cfg, pol, with_attn, k)
        torch.cuda.synchronize()
        assert torch.equal(got.layer_tokens, want.layer_tokens), call
        assert torch.equal(got.layer_attn, want.layer_attn), call
    assert _counts(name) == {"eager": 1, "capture": 1, "replay": 1}
    # each call counts its 23 blocks fused, the replay too
    after = _counts(vit.BLOCK_COUNTER)
    assert after.get(vit.FUSED, 0) - before.get(vit.FUSED, 0) == 6 * 23
    assert after.get(vit.PLAIN, 0) == before.get(vit.PLAIN, 0)


def test_fused_forward_is_no_further_from_fp32_than_the_plain_one(card, vitl14,
                                                                  monkeypatch):
    """vitl14-eval's scale 1: the tokens of the last frozen block and every
    block's maps, against the fp32 forward."""
    cfg, params = vitl14
    img, pe, valid = _tower_inputs(cfg, 16, 518, seed=7)
    pol = precision.make_policy("bfloat16")
    fused = vit._forward_frozen(params, img, pe, valid, cfg, pol, True, 8)
    with monkeypatch.context() as m:
        m.setattr(vit, "fused_path", lambda *a: False)
        plain = vit._forward_frozen(params, img, pe, valid, cfg, pol, True, 8)
        ref = vit._forward_frozen(params, img, pe, valid, cfg, precision.FP32, True, 8)

    def err(t, r):
        return float((t.float() - r.float()).abs().mean())

    for what in ("layer_tokens", "layer_attn"):
        f, p, r = (getattr(o, what)[-1] for o in (fused, plain, ref))
        assert err(f, r) <= 1.05 * err(p, r), what
