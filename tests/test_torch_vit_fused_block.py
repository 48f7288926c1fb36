"""The frozen ViT block's fused path on the CPU (``vit.frozen_block_forward``,
``ops/block_epilogue.py``'s plain twins, ``vit.FrozenWeightCache``).

Each twin against the unfused torch sequence of ``vit.block_forward``:
bit-equal.  ``vit._forward_frozen`` through the fused path (forced on the
CPU, where it runs the twins) against the path it replaces, with the
attention on the kernels' plain versions on both sides, as on the card:
bit-equal where both take the qkv product in one form and over the same
rows; within bf16 rounding of the products, and no further from the fp32
forward, where the plain path runs the map rows and the rest as two
products.  Against the JAX package's bf16 frozen forward on the same
weights and inputs: within bf16 spacings, and no further from it than the
plain bf16 path.  The path is chosen by device, dtype, gradient mode and
model group only; the heads, the text encoder and GradCAM keep ``block_forward``
(a spy and the ``backbone_block`` counter).  Card tests of the kernels:
``tests/test_torch_block_epilogue_cuda.py``."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_support  # noqa: F401
from weclip_tpu.core import config as jconfig
from weclip_tpu.core import precision as jprec
from weclip_tpu.models.clip import vit as jvit
from weclip_tpu_torch import convert
from weclip_tpu_torch.cam import gradcam
from weclip_tpu_torch.core import precision
from weclip_tpu_torch.core.config import ClipConfig
from weclip_tpu_torch.models import heads
from weclip_tpu_torch.models.clip import vit
from weclip_tpu_torch.ops import attention_kernels as ak
from weclip_tpu_torch.ops import block_epilogue as epi
from weclip_tpu_torch.parallel.mesh import Mesh
from weclip_tpu_torch.utils import spans

BF = torch.bfloat16
# (width, heads): ViT-B/16's and ViT-L/14's
WIDTHS = [(768, 12), (1024, 16)]


def _randn(shape, gen, scale=1.0):
    return torch.randn(shape, generator=gen) * scale


def tower(d, h, layers=4, seed=0):
    """A seeded tower at width ``d`` with biases and LayerNorm parameters
    away from their init (zero and one), so every term of every pass counts."""
    cfg = ClipConfig(vision_width=d, vision_heads=h, vision_layers=layers, patch_size=16)
    params = vit.init_vision_params(torch.Generator().manual_seed(seed), cfg)
    gen = torch.Generator().manual_seed(seed + 5)
    blocks = params["blocks"]
    for grp, key in (("attn", "in_b"), ("attn", "out_b"), ("mlp", "fc_b"),
                     ("mlp", "proj_b"), ("ln_1", "b"), ("ln_2", "b")):
        blocks[grp][key] = _randn(blocks[grp][key].shape, gen, 0.1)
    for grp in ("ln_1", "ln_2"):
        blocks[grp]["g"] = 1.0 + _randn(blocks[grp]["g"].shape, gen, 0.1)
    return cfg, params


def tower_inputs(cfg, n_valid, seed=1):
    """A batch on a 4 x 4 patch grid; row i has its first n_valid[i] tokens
    valid, the rest padding."""
    gen = torch.Generator().manual_seed(seed)
    b, side, l = len(n_valid), 4 * cfg.patch_size, 17
    img = _randn((b, 3, side, side), gen)
    pe = _randn((b, l, cfg.vision_width), gen, 0.02)
    valid = torch.zeros((b, l), dtype=torch.bool)
    for i, n in enumerate(n_valid):
        valid[i, :n] = True
    return img, pe, valid


def kernel_attention(x, p, n_heads, valid=None, policy=precision.DEFAULT,
                     want_weights=True, allow_kernel=True, attn_bias=None):
    """``mha_auto`` as it routes on the card: the forward kernels' wrapper
    (their plain versions here)."""
    assert allow_kernel and attn_bias is None
    return ak.mha_with_weights_kernel(x, p, n_heads, valid=valid, policy=policy,
                                      want_weights=want_weights)


def qkv_one_product(x, p, cd):
    """``qkv_project`` as one (B, L, D) x (D, 3D) product, the form the
    fused path takes."""
    g = torch.matmul(x.to(cd), p.in_w.to(cd).mT) + p.in_b.to(cd)
    return g.reshape(*x.shape[:-1], 3, x.shape[-1]).movedim(-2, 0)


def both_paths(monkeypatch, cfg, params, img, pe, valid, with_attn, k):
    """(plain, fused) ``_forward_frozen`` under the bf16 policy."""
    with monkeypatch.context() as m:
        m.setattr(vit, "mha_auto", kernel_attention)
        plain = vit._forward_frozen(params, img, pe, valid, cfg, precision.DEFAULT,
                                    with_attn, k)
    with monkeypatch.context() as m:
        m.setattr(vit, "fused_path", lambda *a: True)
        fused = vit._forward_frozen(params, img, pe, valid, cfg, precision.DEFAULT,
                                    with_attn, k)
    return plain, fused


def counts(name=vit.BLOCK_COUNTER):
    return dict(spans.RECORDER.totals.get(name, {}))


# -- each twin against the unfused sequence ----------------------------------

@pytest.mark.parametrize("d,h", WIDTHS)
def test_qkv_bias_split_twin_is_the_bias_add_and_head_copies(d, h):
    gen = torch.Generator().manual_seed(0)
    b, l = 3, 17
    g = _randn((b, l, 3 * d), gen).to(BF)
    in_b = _randn((3 * d,), gen, 0.5)
    q, k, v = epi.qkv_bias_split(g, in_b.to(BF), h)
    # qkv_project's (3, B, L, D) sum, then _heads' copies
    want = g.reshape(b, l, 3, d).movedim(2, 0) + in_b.reshape(3, d).to(BF)[:, None, None, :]
    for got, t in zip((q, k, v), want):
        assert got.shape == (b, h, l, d // h) and got.is_contiguous()
        assert torch.equal(got, ak._heads(t, h))


@pytest.mark.parametrize("d,h", WIDTHS)
def test_residual_ln_twin_is_the_masked_residual_add_and_layer_norm(d, h):
    gen = torch.Generator().manual_seed(1)
    x = _randn((3, 17, d), gen).to(BF)
    g = _randn((3, 17, d), gen).to(BF)
    bias = _randn((d,), gen, 0.5).to(BF)
    gamma, beta = 1.0 + _randn((d,), gen, 0.1), _randn((d,), gen, 0.1)
    valid = torch.rand((3, 17), generator=gen) > 0.3
    # after the out-projection: _out_project's bias and mask, the residual,
    # then ln_2
    attn_out = (g + bias).masked_fill(~valid[..., None], 0.0)
    want_y = x + attn_out
    out = torch.empty_like(x)
    y, ln = epi.residual_ln(g, (gamma, beta), x=x, bias=bias, rowmask=valid, out=out)
    assert y is out and torch.equal(y, want_y)
    assert torch.equal(ln, vit.layer_norm(want_y, gamma, beta))
    # after the MLP projection: no mask; the last frozen block writes no LN
    y, ln = epi.residual_ln(g, None, x=x, bias=bias)
    assert torch.equal(y, x + (g + bias)) and ln is None
    # block 0's ln_1: no residual, the stream itself
    y, ln = epi.residual_ln(x, (gamma, beta))
    assert y is x and torch.equal(ln, vit.layer_norm(x, gamma, beta))


@pytest.mark.parametrize("d,h", WIDTHS)
def test_bias_quick_gelu_twin_is_the_bias_add_and_quick_gelu(d, h):
    gen = torch.Generator().manual_seed(2)
    g = _randn((3, 17, 4 * d), gen, 3.0).to(BF)
    fc_b = _randn((4 * d,), gen, 0.5).to(BF)
    want = vit.quick_gelu(g + fc_b)
    got = epi.bias_quick_gelu(g, fc_b)
    assert got is g and torch.equal(got, want)


# -- the fused frozen forward against the plain one ---------------------------

@pytest.mark.parametrize("d,h", WIDTHS)
@pytest.mark.parametrize("with_attn", [True, False])
def test_fused_forward_is_bit_equal_with_the_products_taken_alike(monkeypatch, d, h,
                                                                  with_attn):
    """Padded rows; maps for every row, or none."""
    cfg, params = tower(d, h)
    img, pe, valid = tower_inputs(cfg, (17, 9, 5))
    monkeypatch.setattr(ak, "qkv_project", qkv_one_product)
    plain, fused = both_paths(monkeypatch, cfg, params, img, pe, valid, with_attn, 3)
    assert fused.layer_tokens.dtype == BF and fused.layer_tokens.shape == (3, 3, 17, d)
    assert torch.equal(fused.layer_tokens, plain.layer_tokens)
    assert fused.layer_attn.shape == plain.layer_attn.shape
    assert torch.equal(fused.layer_attn, plain.layer_attn)
    assert fused.valid is valid


@pytest.mark.parametrize("d,h", WIDTHS)
@pytest.mark.parametrize("with_attn,k", [(True, 1), (True, 3), (False, 3)])
def test_fused_forward_matches_the_plain_one(monkeypatch, d, h, with_attn, k):
    """With the products in their own forms (the plain path's qkv einsum;
    at k < B its two row groups), the two paths part only where a product's
    fp32 sum, taken in another order, rounds the other way: the tokens stay
    within one bf16 spacing of the largest token, the maps within 1e-3, and
    the fused path is no further from the fp32 forward than the plain one."""
    cfg, params = tower(d, h)
    img, pe, valid = tower_inputs(cfg, (17, 9, 5))
    plain, fused = both_paths(monkeypatch, cfg, params, img, pe, valid, with_attn, k)
    ref = vit._forward_frozen(params, img, pe, valid, cfg, precision.FP32, with_attn, k)
    got, want = fused.layer_tokens.float(), plain.layer_tokens.float()
    spacing = 2.0 ** (math.floor(math.log2(float(want.abs().max()))) - 7)
    assert float((got - want).abs().max()) <= spacing
    err_fused = float((got - ref.layer_tokens).abs().mean())
    err_plain = float((want - ref.layer_tokens).abs().mean())
    assert err_fused <= 1.02 * err_plain
    assert fused.layer_attn.shape == plain.layer_attn.shape
    if with_attn:
        assert float((fused.layer_attn - plain.layer_attn).abs().max()) <= 1e-3
        # padded query rows of the maps are zero on both paths
        assert not fused.layer_attn[:, ~valid[:k]].any()


def _spacing(t):
    """One bf16 spacing at the largest magnitude in ``t``."""
    return 2.0 ** (math.floor(math.log2(float(t.abs().max()))) - 7)


@pytest.mark.parametrize("d,h", WIDTHS)
@pytest.mark.parametrize("with_attn,k", [(True, 1), (True, 3), (False, 3)])
def test_fused_forward_matches_the_jax_package(monkeypatch, d, h, with_attn, k):
    """Against ``weclip_tpu``'s frozen forward under its bf16 policy, on the
    same weights and inputs (padded rows; maps for k <= B rows).  The two
    packages round at the same points but sum each product in their own
    order, so a block's output may differ by a rounding that the next
    blocks carry: over these three blocks the tokens stay within two bf16
    spacings of the largest token and the maps within one spacing of the
    largest map value.  The fused path is no further from the JAX package,
    on the mean, than the plain bf16 path is (2% for the products' other
    sum orders, as against the fp32 forward)."""
    cfg, params = tower(d, h)
    img, pe, valid = tower_inputs(cfg, (17, 9, 5))
    plain, fused = both_paths(monkeypatch, cfg, params, img, pe, valid, with_attn, k)
    jcfg = jconfig.ClipConfig(vision_width=d, vision_heads=h,
                              vision_layers=cfg.vision_layers, patch_size=cfg.patch_size)
    ref = jvit.vision_forward_frozen(
        jax.tree_util.tree_map(jnp.asarray, convert.to_numpy(params)),
        jnp.asarray(img.numpy()), jnp.asarray(pe.numpy()), jnp.asarray(valid.numpy()),
        jcfg, policy=jprec.DEFAULT, with_attn=with_attn, attn_rows=k)
    # the JAX stream is padded to its kernel's alignment: keep the first L
    l = valid.shape[1]
    ref_tokens = torch.from_numpy(np.array(ref.layer_tokens, np.float32)[:, :, :l])
    ref_attn = torch.from_numpy(np.array(ref.layer_attn)[:, :, :l, :l])
    pairs = [(fused.layer_tokens.float(), plain.layer_tokens.float(), ref_tokens, 2)]
    if with_attn:
        pairs.append((fused.layer_attn, plain.layer_attn, ref_attn, 1))
    else:
        assert fused.layer_attn.shape[:2] == ref.layer_attn.shape[:2] == (0, 3)
    for got, base, want, n_spacings in pairs:
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= n_spacings * _spacing(want)
        err_fused = float((got - want).abs().mean())
        assert err_fused <= 1.02 * float((base - want).abs().mean())


def test_forward_counts_each_frozen_block_by_path(monkeypatch):
    cfg, params = tower(64, 2, layers=5)
    img, pe, valid = tower_inputs(cfg, (17, 11))
    before = counts()
    vit.vision_forward_frozen(params, img, pe, valid, cfg, attn_rows=1)
    assert counts().get(vit.PLAIN, 0) - before.get(vit.PLAIN, 0) == 4
    monkeypatch.setattr(vit, "fused_path", lambda *a: True)
    vit.vision_forward_frozen(params, img, pe, valid, cfg, attn_rows=1)
    after = counts()
    assert after.get(vit.FUSED, 0) - before.get(vit.FUSED, 0) == 4
    assert after.get(vit.PLAIN, 0) - before.get(vit.PLAIN, 0) == 4


def test_path_is_chosen_by_device_dtype_gradient_and_model_group(monkeypatch):
    cfg, params = tower(64, 2, layers=3)
    bf16 = precision.DEFAULT
    assert not vit.fused_path(params, torch.zeros((2, 5, 64), dtype=BF), bf16)
    split = dict(params, blocks=dict(params["blocks"], mlp=dict(
        params["blocks"]["mlp"], tp=Mesh(data=1, rank=0, model=2))))

    class Card(torch.Tensor):
        """A tensor that reports a CUDA device, for the predicate alone."""
        @property
        def is_cuda(self):
            return True

    card = torch.zeros((2, 5, 64)).as_subclass(Card)
    assert vit.fused_path(params, card, bf16)
    assert not vit.fused_path(params, card, precision.FP32)
    assert not vit.fused_path(split, card, bf16)
    # gradient mode: the forward asks the predicate under no_grad only
    asked, real = [], vit.fused_path
    monkeypatch.setattr(vit, "fused_path",
                        lambda *a: asked.append(torch.is_grad_enabled()) or real(*a))
    img, pe, valid = tower_inputs(cfg, (17, 11))
    vit.vision_forward_frozen(params, img, pe, valid, cfg, attn_rows=1)
    assert torch.is_grad_enabled() and asked == [False]


def test_heads_text_encoder_and_gradcam_keep_block_forward(monkeypatch):
    """With the fused path open, as on the card, none of them reaches
    ``frozen_block_forward`` or the frozen forward's counter."""
    monkeypatch.setattr(vit, "fused_path", lambda *a: True)
    calls = {"block_forward": 0, "frozen_block_forward": 0}

    def spy(name):
        real = getattr(vit, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        monkeypatch.setattr(vit, name, wrapped)

    calls["block_forward_from_ln1"] = 0
    for name in calls:
        spy(name)
    before = counts()
    gen = torch.Generator().manual_seed(3)
    # the decoder, gradient-free and with gradients
    hp = heads.init_head_params(gen, n_layers=2, in_dim=64, embed=32, dec_layers=2,
                                num_classes=4)
    fts = _randn((2, 9, 32), gen)
    with torch.no_grad():
        heads.decoder_forward(hp["decoder"], fts, n_heads=2, policy=precision.FP32,
                              allow_kernel=True)
    heads.decoder_forward(hp["decoder"], fts.requires_grad_(True), n_heads=2,
                          policy=precision.DEFAULT)
    n_dec = hp["decoder"]["blocks"]["ln_1"]["g"].shape[0]
    # the text encoder
    cfg = ClipConfig(vision_width=64, vision_heads=2, vision_layers=3, patch_size=16,
                     embed_dim=32, context_length=8, vocab_size=64,
                     transformer_width=32, transformer_heads=2, transformer_layers=2)
    clip = vit.init_clip_params(gen, cfg)
    tokens = torch.randint(1, 63, (3, 8), generator=gen)
    vit.encode_text(clip["text"], tokens, cfg)
    # GradCAM's last block
    b, l = 2, 5
    x11 = _randn((b, l, 64), gen).to(BF)
    text = torch.nn.functional.normalize(_randn((4, 32), gen), dim=-1)
    gradcam.acts_and_grads(clip["visual"], clip["logit_scale"], x11, text,
                           torch.ones((b, 4), dtype=torch.bool),
                           torch.ones((b, l), dtype=torch.bool),
                           torch.tensor([[0, 1], [2, 0]]), cfg, precision.DEFAULT)
    assert calls == {"block_forward": 2 * n_dec + 2, "frozen_block_forward": 0,
                     "block_forward_from_ln1": 1}
    assert counts() == before


# -- the bf16 weights, made once a frozen state ---------------------------------

def test_weight_cache_serves_one_cast_per_frozen_state():
    cfg, params = tower(64, 2, layers=4)
    cache = vit.FrozenWeightCache()
    w = cache.get(params["blocks"], 3)
    assert cache.get(params["blocks"], 3) is w
    assert w.in_w.dtype == BF and w.in_w.shape == (3, 192, 64)
    assert w.ln1_g.dtype == torch.float32 and w.ln1_g.shape == (3, 64)
    src = params["blocks"]
    assert torch.equal(w.fc_w, src["mlp"]["fc_w"][:3].to(BF))
    assert torch.equal(w.out_b, src["attn"]["out_b"][:3].to(BF))
    assert torch.equal(w.ln2_b, src["ln_2"]["b"][:3])
    assert w.ln2_b.data_ptr() != src["ln_2"]["b"].data_ptr()
    # two states are kept, the least recently used evicted
    fresh = [vit.tree_map(lambda t: t.clone(), src) for _ in range(2)]
    cache.get(fresh[0], 3)
    assert cache.get(src, 3) is w
    cache.get(fresh[1], 3)          # evicts fresh[0]
    cache.get(fresh[0], 3)          # evicts src
    assert cache.get(src, 3) is not w
    # other tensors over the same storage (as a tree reusing freed
    # addresses would be) get casts of their own
    w = cache.get(src, 3)
    views = vit.tree_map(lambda t: t.view(t.shape), src)
    assert cache.get(views, 3) is not w


def test_weight_cache_drops_a_state_when_its_tree_is_freed():
    cfg, params = tower(64, 2, layers=4)
    cache = vit.FrozenWeightCache()
    src = params["blocks"]
    kept = cache.get(src, 3)
    fresh = vit.tree_map(lambda t: t.clone(), src)
    cache.get(fresh, 3)
    assert len(cache._entries) == 2
    del fresh
    assert len(cache._entries) == 1 and cache.get(src, 3) is kept
    # a second tree over the same storage replaces the entry under its key;
    # freeing the tensors of the first leaves the second's entry in place
    views = vit.tree_map(lambda t: t.view(t.shape), src)
    mine = cache.get(views, 3)
    del src, params, kept
    assert cache.get(views, 3) is mine
    del views
    assert not cache._entries


def test_graph_key_follows_the_weight_copies(monkeypatch):
    cfg, params = tower(64, 2, layers=3)
    img, pe, valid = tower_inputs(cfg, (17, 9))
    args = (img, pe, valid, cfg, precision.DEFAULT, True, 2)
    plain_key = vit.graph_key(params, *args)
    monkeypatch.setattr(vit, "fused_path", lambda *a: True)
    monkeypatch.setattr(vit, "FROZEN_WEIGHTS", vit.FrozenWeightCache())
    key = vit.graph_key(params, *args)
    assert key != plain_key and key == vit.graph_key(params, *args)
    monkeypatch.setattr(vit, "FROZEN_WEIGHTS", vit.FrozenWeightCache())
    assert vit.graph_key(params, *args) != key
