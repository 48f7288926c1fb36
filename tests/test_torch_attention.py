"""The port's attention (weclip_tpu_torch/ops/attention*.py) against the JAX
package: the plain versions of kernels K1-K3 against the Pallas kernels in
interpret mode, and the plain MHA against the XLA formulation.

Inputs come from numpy seeds and go to both packages.  Tolerances: 2e-5
for fp32 forwards and 5e-4 for gradients (the calibration of
tests/test_pallas_attention.py), 2e-2 where both sides round to bf16
(one bf16 ulp at |x| <= 2 is 1.6e-2)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_support  # noqa: F401
from weclip_tpu.core import precision as jprec
from weclip_tpu.ops import attention as jattn
from weclip_tpu.ops import pallas_attention as jpal
from weclip_tpu_torch.core import precision as tprec
from weclip_tpu_torch.ops import attention as tattn
from weclip_tpu_torch.ops import attention_kernels as tak

F32_TOL = 2e-5
GRAD_TOL = 5e-4
BF16_TOL = 2e-2
# the kernels' compiled widths (16, 32, 64, 128), widths between them,
# which run the next one up with zero lanes, and widths above 128, which run
# as slices of 128 columns
HEAD_DIMS = [8, 16, 20, 32, 48, 64, 80, 128, 160, 256]


def _qkv_mask(seed, b, h, l, dh, n_valid):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, l, dh)).astype(np.float32)
               for _ in range(3))
    kmask = np.zeros((b, l), np.float32)
    for i, nv in enumerate(n_valid):
        kmask[i, :nv] = 1.0
    return q, k, v, kmask


def _mha_params(seed, d):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) * 0.1
            for s in ((3 * d, d), (3 * d,), (d, d), (d,))]
    return (jattn.MhaParams(*map(jnp.asarray, arrs)),
            tattn.MhaParams(*map(torch.from_numpy, arrs)))


@pytest.mark.parametrize("export", [True, False])
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_attention_core_plain_matches_pallas(export, dh):
    """(a) K1/K2's plain version vs attention_core_pallas(interpret=True),
    ragged L with masked keys and one all-masked row."""
    b, h, l = 3, 2, 40
    q, k, v, kmask = _qkv_mask(0, b, h, l, dh, n_valid=(40, 23, 0))
    ref_out, ref_map = jpal.attention_core_pallas(
        *map(jnp.asarray, (q, k, v, kmask)), h, interpret=True,
        score_dtype=jnp.float32, export_weights=export)
    out, amap = tak.attention_core(*map(torch.from_numpy, (q, k, v, kmask)),
                                   export_weights=export)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               rtol=F32_TOL, atol=F32_TOL)
    if export:
        np.testing.assert_allclose(amap.numpy(), np.asarray(ref_map),
                                   rtol=F32_TOL, atol=F32_TOL)
    else:
        assert amap is None and ref_map is None


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_attention_core_plain_matches_pallas_bf16(dh):
    """(a) the bf16 score path: both round q*scale, P (or exp) to bf16 at
    the same points, so they differ by bf16 rounding of the output only."""
    b, h, l = 2, 2, 40
    q, k, v, kmask = _qkv_mask(1, b, h, l, dh, n_valid=(40, 17))
    for export in (True, False):
        ref_out, _ = jpal.attention_core_pallas(
            *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
            jnp.asarray(kmask), h, interpret=True, score_dtype=jnp.bfloat16,
            export_weights=export, out_dtype=jnp.bfloat16)
        out, _ = tak.attention_core(
            *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
            torch.from_numpy(kmask), export_weights=export)
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref_out, np.float32),
                                   rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_attention_bwd_plain_matches_pallas(dh):
    """(b) K3's plain version vs attention_bwd_pallas(interpret=True)."""
    b, h, l = 2, 2, 36
    q, k, v, kmask = _qkv_mask(2, b, h, l, dh, n_valid=(36, 20))
    do = np.random.default_rng(3).standard_normal((b, h, l, dh)).astype(np.float32)
    qs = q * dh ** -0.5
    ref = jpal.attention_bwd_pallas(*map(jnp.asarray, (qs, k, v, do, kmask)),
                                    interpret=True, score_dtype=jnp.float32)
    got = tak.attention_bwd(*map(torch.from_numpy, (qs, k, v, do, kmask)),
                            score_dtype=torch.float32)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def test_mha_fused_grad_matches_jax_vjp():
    """(b) the autograd.Function (plain forward/backward on CPU) inside the
    fused MHA vs the JAX vjp of mha_with_weights_fused in interpret mode."""
    b, l, d, h = 2, 24, 32, 2
    jp, tp = _mha_params(4, d)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, l, d)).astype(np.float32)
    valid = np.ones((b, l), bool)
    valid[1, 15:] = False
    cot = rng.standard_normal((b, l, d)).astype(np.float32)

    def jfn(xx):
        out, attn = jpal.mha_with_weights_fused(
            xx, jp, h, valid=jnp.asarray(valid), policy=jprec.FP32,
            interpret=True)
        return out, attn

    (ref_out, ref_attn), pull = jax.vjp(jfn, jnp.asarray(x))
    (ref_dx,) = pull((jnp.asarray(cot), jnp.zeros_like(ref_attn)))

    xt = torch.from_numpy(x).requires_grad_(True)
    out, attn = tak.mha_with_weights_fused(xt, tp, h, valid=torch.from_numpy(valid),
                                           policy=tprec.FP32)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(ref_attn),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


def test_attention_core_fn_matches_plain_autograd():
    """(b) AttentionCoreFn's backward (the K3 formulation) vs autograd
    through the plain forward, fp32, with masked keys."""
    b, h, l, dh = 2, 2, 30, 32
    q, k, v, kmask = _qkv_mask(6, b, h, l, dh, n_valid=(30, 11))
    do = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (b, h, l, dh)).astype(np.float32))
    km = torch.from_numpy(kmask)
    ins = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out, amap = tak.AttentionCoreFn.apply(*ins, km)
    assert not amap.requires_grad
    g_fn = torch.autograd.grad(out, ins, do)
    ins2 = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out2, _ = tak.attention_core_plain(*ins2, km, export_weights=True)
    g_pl = torch.autograd.grad(out2, ins2, do)
    for a, r in zip(g_fn, g_pl):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("want_weights", [True, False])
def test_mha_with_weights_matches_xla(want_weights):
    """The plain MHA (and mha_auto on CPU) vs the JAX XLA formulation."""
    b, l, d, h = 2, 33, 32, 4
    jp, tp = _mha_params(8, d)
    x = np.random.default_rng(9).standard_normal((b, l, d)).astype(np.float32)
    valid = np.ones((b, l), bool)
    valid[0, 20:] = False
    ref_out, ref_attn = jattn.mha_with_weights(
        jnp.asarray(x), jp, h, valid=jnp.asarray(valid), policy=jprec.FP32)
    out, attn = tattn.mha_auto(torch.from_numpy(x), tp, h,
                               valid=torch.from_numpy(valid), policy=tprec.FP32,
                               want_weights=want_weights)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               rtol=F32_TOL, atol=F32_TOL)
    if want_weights:
        np.testing.assert_allclose(attn.numpy(), np.asarray(ref_attn),
                                   rtol=F32_TOL, atol=F32_TOL)
    else:
        assert attn is None


def test_kernel_mha_matches_plain_mha_on_cpu():
    """mha_with_weights_kernel (the CUDA route's projections and masking,
    with the plain core on CPU) agrees with the plain MHA."""
    b, l, d, h = 2, 33, 32, 2
    _, tp = _mha_params(10, d)
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (b, l, d)).astype(np.float32))
    valid = torch.ones((b, l), dtype=torch.bool)
    valid[1, 9:] = False
    ref_out, ref_attn = tattn.mha_with_weights(x, tp, h, valid=valid,
                                               policy=tprec.FP32)
    out, attn = tak.mha_with_weights_kernel(x, tp, h, valid=valid,
                                            policy=tprec.FP32)
    np.testing.assert_allclose(out.numpy(), ref_out.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(attn.numpy(), ref_attn.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("score_dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_takes_unscaled_q_with_its_scale(score_dtype):
    """attention_bwd(q, ..., q_scale=s) is attention_bwd(q * s, ...): the
    form in which AttentionCoreFn hands the kernel its unscaled query."""
    b, h, l, dh = 2, 2, 20, 32
    q, k, v, kmask = _qkv_mask(12, b, h, l, dh, n_valid=(20, 7))
    do = np.random.default_rng(13).standard_normal((b, h, l, dh)).astype(np.float32)
    q, k, v, do, km = map(torch.from_numpy, (q, k, v, do, kmask))
    s = dh ** -0.5
    got = tak.attention_bwd(q.to(score_dtype), k.to(score_dtype), v.to(score_dtype),
                            do.to(score_dtype), km, score_dtype, q_scale=s)
    want = tak.attention_bwd(q.to(score_dtype).float() * s, k, v, do.to(score_dtype),
                             km, score_dtype)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def test_padded_key_bias_masks_the_padding():
    """The key-tiled kernels stage the bias in whole 64-key tiles: the
    padding is -1e30, like a masked key."""
    km = torch.tensor([[1.0] * 70, [1.0] * 30 + [0.0] * 40])
    bias = tak._padded_key_bias(km)
    assert bias.shape == (2, 128) and bias.dtype == torch.float32
    assert torch.equal(bias[:, :70], tak._key_bias(km))
    assert bool((bias[:, 70:] == -1e30).all())
    assert tak._padded_key_bias(torch.ones((1, 64))).shape == (1, 64)


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("score_dtype", [torch.float32, torch.bfloat16])
def test_k1_row_stats_and_map_plain_compose_to_the_map(score_dtype, dh):
    """K1's two launches, as their plain versions: the row statistics, then
    the head-summed map from them, equal attention_core_plain's map (1e-6)
    and the Pallas export kernel's in interpret mode (2e-5); L 70 is not a
    whole number of 64-key tiles, one image has masked keys and one has no
    valid key (its map is exactly 0)."""
    b, h, l = 3, 2, 70
    q, k, v, kmask = _qkv_mask(14, b, h, l, dh, n_valid=(70, 33, 0))
    qt, kt, vt = (torch.from_numpy(x).to(score_dtype) for x in (q, k, v))
    km = torch.from_numpy(kmask)
    stats = tak.attention_row_stats_plain(qt, kt, km)
    amap = tak.attention_map_plain(qt, kt, km, stats)
    _, ref = tak.attention_core_plain(qt, kt, vt, km, export_weights=True)
    assert stats.shape == (b, h, l, 2) and stats.dtype == torch.float32
    np.testing.assert_allclose(amap.numpy(), ref.numpy(), rtol=0, atol=1e-6)
    assert not amap[2].any()
    jdt = jnp.float32 if score_dtype == torch.float32 else jnp.bfloat16
    _, jmap = jpal.attention_core_pallas(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(kmask), h,
        interpret=True, score_dtype=jdt, export_weights=True, out_dtype=jdt)
    np.testing.assert_allclose(amap.numpy(), np.asarray(jmap, np.float32),
                               rtol=0, atol=F32_TOL)


def test_attention_core_writes_stats_only_from_the_bf16_map_kernel():
    """``stats`` is an output of K1 on CUDA (bf16 and, since the fp32 K1
    took the same two-launch form, fp32); elsewhere it is refused rather
    than left unwritten."""
    q, k, v, kmask = map(torch.from_numpy, _qkv_mask(15, 1, 2, 8, 32, n_valid=(8,)))
    with pytest.raises(ValueError):
        tak.attention_core(q, k, v, kmask, stats=torch.empty((1, 2, 8, 2)))


@pytest.mark.parametrize("dh", [0, 129, 256])
def test_head_widths_past_the_kernels_are_refused(dh):
    """Every width the Pallas kernels take passes the wrappers' check (no
    upper limit: above 128 the kernels run slices of 128 columns), and
    there the plain version matches the Pallas kernel; Dh 0 raises a
    ValueError before any launch."""
    if dh == 0:
        with pytest.raises(ValueError, match="head dim 0"):
            tak._check_head_dim("attention_core", dh)
        return
    tak._check_head_dim("attention_core", dh)
    b, h, l = 2, 2, 24
    q, k, v, kmask = _qkv_mask(16, b, h, l, dh, n_valid=(24, 9))
    ref_out, ref_map = jpal.attention_core_pallas(
        *map(jnp.asarray, (q, k, v, kmask)), h, interpret=True,
        score_dtype=jnp.float32, export_weights=True)
    out, amap = tak.attention_core(*map(torch.from_numpy, (q, k, v, kmask)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(amap.numpy(), np.asarray(ref_map), rtol=F32_TOL, atol=F32_TOL)


def _tf32(x):
    """cvt.rna.tf32.f32: fp32 rounded to 10 explicit mantissa bits, to
    nearest, ties away from zero (adding half a tf32 ulp to the magnitude's
    bits, then truncating), low 13 bits zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _toward_zero(x64):
    """float64 -> fp32 rounded toward zero: the tensor cores truncate as
    they accumulate (modelled on each product's exact 8-term sum plus the
    accumulator)."""
    f = x64.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x64)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _split_tf32_product(a, b, group, small_apart):
    """a @ b as csrc/cross_attention.cu takes it: each operand split into hi
    = tf32(x) and lo = tf32(x - hi); per k-step of 8 (one m16n8k8 product)
    lo b_hi, hi b_hi and hi b_lo, each addition truncated, the small terms
    in an accumulator of their own where ``small_apart`` (the score
    product); every ``group`` columns of the k-loop the accumulators are
    added to the running fp32 sum, rounded to nearest (32 columns for the
    score product, one key tile for the value product)."""
    f64 = lambda x: x.astype(np.float64)
    ah = _tf32(a)
    al = _tf32(a - ah)
    bh = _tf32(b)
    bl = _tf32(b - bh)
    shape = a.shape[:-1] + b.shape[-1:]
    out = np.zeros(shape, np.float32)
    for g0 in range(0, a.shape[-1], group):
        big, small = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
        for k0 in range(g0, min(g0 + group, a.shape[-1]), 8):
            ks = slice(k0, k0 + 8)
            for x, y, is_small in ((al, bh, True), (ah, bh, False), (ah, bl, True)):
                term = f64(x[..., ks]) @ f64(y[..., ks, :])
                if is_small and small_apart:
                    small = _toward_zero(f64(small) + term)
                else:
                    big = _toward_zero(f64(big) + term)
        out = (out + (big + small)).astype(np.float32)
    return out


@pytest.mark.parametrize("dh", [8, 16, 20, 32, 48, 64, 80, 128, 160, 256])
def test_split_tf32_product_error(dh):
    """The fp32 kernels' products (three TF32 products of split operands,
    the lo lo term dropped, the tensor cores' truncating accumulation
    modelled) against float64: the score product q K^T at (B, H, L, Dh)
    and the value product P V over 512 keys in tiles of 64, each at most
    10 times strict fp32's own distance from float64 (measured over seeds
    up to 2.6x for the scores, 7.1x for the values where numpy's own sum
    lands unusually close), and at most a tenth of the card's 2e-5
    tolerance against the strict fp32 plain version."""
    # the emulated conversion rounds to nearest, ties away from zero
    tie = np.float32(1 + 2.0 ** -11)
    assert _tf32(tie) == np.float32(1 + 2.0 ** -10)
    assert _tf32(-tie) == -np.float32(1 + 2.0 ** -10)
    assert _tf32(np.float32(1 + 2.0 ** -11 - 2.0 ** -23)) == 1.0
    rng = np.random.default_rng(dh)
    b, h, l, lk = 2, 2, 24, 512
    q = (rng.standard_normal((b, h, l, dh)) * dh ** -0.5).astype(np.float32)
    k = rng.standard_normal((b, h, l, dh)).astype(np.float32)
    v = rng.standard_normal((b, h, lk, dh)).astype(np.float32)
    e = rng.standard_normal((b, h, l, lk))
    ex = np.exp(e - e.max(-1, keepdims=True))
    p = (ex / ex.sum(-1, keepdims=True)).astype(np.float32)
    for a, bm, group, apart in ((q, np.swapaxes(k, -1, -2), 32, True), (p, v, 64, False)):
        exact = np.matmul(a.astype(np.float64), bm.astype(np.float64))
        strict = np.abs(np.matmul(a, bm) - exact).max()
        three = np.abs(_split_tf32_product(a, bm, group, apart) - exact).max()
        assert three <= 10 * strict, (three, strict)
        assert three <= 2e-6, three
