"""The port's CUDA kernels (K1-K7, K3-rect) against their plain versions on
the card.  These need a CUDA card with nvcc and skip elsewhere; run them there
with ``python -m pytest tests/test_torch_kernels_cuda.py -m cuda``.
``chip_smoke.py`` holds the same kernels at the full inference shapes."""

import numpy as np
import pytest
import torch

from tests.torch_support import card  # noqa: F401
from weclip_tpu_torch import kernels
from weclip_tpu_torch.core.config import ParConfig
from weclip_tpu_torch.ops import attention_kernels as ak
from weclip_tpu_torch.refine import par as par_plain
from weclip_tpu_torch.refine import par_kernels as pk

pytestmark = pytest.mark.cuda

# every head width the kernels take runs a compiled instance (16, 32, 64,
# 128), the next one up with zero lanes, or (above 128) slices of 128
# columns, the last one partly zero lanes
WIDTHS = [8, 16, 20, 32, 48, 64, 80, 128, 129, 192, 256, 320]
# the compiled instances
COMPILED = [16, 32, 64, 128]


def _qkv(card, b, h, l, dh, dtype, n_valid):
    g = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn((b, h, l, dh), generator=g, device=card).to(dtype)
               for _ in range(3))
    km = torch.zeros((b, l), device=card)
    for i, n in enumerate(n_valid):
        km[i, :n] = 1.0
    return q, k, v, km


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("dh", WIDTHS)
@pytest.mark.parametrize("export", [True, False])
@pytest.mark.parametrize("l", [77, 626, 1025])
def test_attention_fwd_kernel_matches_plain(card, dtype, tol, dh, export, l):
    """K1 / K2 with all keys, half the keys and no key valid (a fully
    masked image)."""
    q, k, v, km = _qkv(card, 3, 2, l, dh, dtype, (l, l // 2, 0))
    before = dict(kernels.launches)
    out, amap = ak.attention_core(q, k, v, km, export_weights=export)
    ref, ref_map = ak.attention_core_plain(q, k, v, km, export_weights=export)
    name = "attention_fwd_export" if export else "attention_fwd"
    assert kernels.launches[name] == before[name] + 1
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if export:
        torch.testing.assert_close(amap, ref_map, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_attention_fwd_no_map_takes_long_sequences(card, dtype, tol):
    """K2 keeps no whole score row, so L is not bounded by shared memory."""
    q, k, v, km = _qkv(card, 2, 2, 4096, 64, dtype, (4096, 1500))
    out, _ = ak.attention_core(q, k, v, km, export_weights=False)
    ref, _ = ak.attention_core_plain(q, k, v, km, export_weights=False)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("l,dh", [(70, 64), (77, 64), (626, 64), (1025, 64)]
                         + [(77, dh) for dh in WIDTHS if dh != 64])
def test_attention_bwd_kernel_matches_plain(card, dtype, tol, l, dh):
    q, k, v, km = _qkv(card, 3, 2, l, dh, dtype, (l, l // 2, 0))
    do = torch.randn(q.shape, device=card)
    qs = q.float() * dh ** -0.5
    before = kernels.launches["attention_bwd"]
    got = ak.attention_bwd(qs, k, v, do, km, dtype)
    ref = ak.attention_bwd_plain(qs, k, v, do, km, dtype)
    assert kernels.launches["attention_bwd"] == before + 1
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=tol, atol=tol)


@pytest.mark.parametrize("l", [77, 1025])
def test_attention_bwd_kernel_takes_bf16_as_autograd_hands_it(card, l):
    """K3 fed what AttentionCoreFn gives it (bf16 q unscaled with its scale,
    bf16 k, v and dO) equals K3 fed the pre-scaled fp32 q: the kernel
    rounds bf16(float(q) * scale) as it stages q."""
    q, k, v, km = _qkv(card, 3, 2, l, 64, torch.bfloat16, (l, l // 2, 0))
    do = torch.randn(q.shape, device=card).to(torch.bfloat16)
    scale = 64 ** -0.5
    got = ak.attention_bwd(q, k, v, do, km, torch.bfloat16, q_scale=scale)
    want = ak.attention_bwd(q.float() * scale, k, v, do.float(), km, torch.bfloat16)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    ref = ak.attention_bwd_plain(q.float() * scale, k, v, do, km, torch.bfloat16)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=0, atol=2.0 ** -8 * float(r.abs().max()))


def _rect(card, lq, lk, dtype, dh=64):
    """q (pre-scaled), k, v at (3, 2, L, dh); key masks: all valid, a third
    valid, none valid (a fully masked key row)."""
    g = torch.Generator(device=card).manual_seed(1)
    b, h = 3, 2
    q = (torch.randn((b, h, lq, dh), generator=g, device=card) * dh ** -0.5).to(dtype)
    k, v = (torch.randn((b, h, lk, dh), generator=g, device=card).to(dtype)
            for _ in range(2))
    km = torch.zeros((b, lk), device=card)
    km[0] = 1.0
    km[1, :lk // 3] = 1.0
    return q, k, v, km


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk,dh", [(130, 5376, 64), (2100, 77, 64), (77, 2100, 64)]
                         + [(77, 2100, dh) for dh in WIDTHS if dh != 64])
def test_cross_attention_kernel_matches_plain(card, dtype, lq, lk, dh):
    """K6 at key lengths past what a whole-row design keeps in shared
    memory, and at every head width; fp32 (split-TF32 products) to 2e-5,
    bf16 to one bf16 ulp of the largest output."""
    q, k, v, km = _rect(card, lq, lk, dtype, dh)
    before = kernels.launches["cross_attention"]
    out = ak.cross_attention_core(q, k, v, km)
    ref = ak.cross_attention_core_plain(q, k, v, km)
    assert kernels.launches["cross_attention"] == before + 1
    assert out.dtype == torch.float32 and not out[2].any()
    tol = 2e-5 if dtype == torch.float32 else _bf16_ulp(float(ref.abs().max()))
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("dh", WIDTHS)
@pytest.mark.parametrize("lq,lk", [(3294, 625), (625, 3294)])
def test_cross_attention_wgmma_kernel_at_ragged_lengths(card, dh, lq, lk):
    """K6 under bf16 where neither length is a whole number of 64-row
    tiles, at every head width: up to 128 the wgmma kernel, with the
    swizzles of its tensor maps (128-byte for Dh 64 and 128, two boxes a
    row at 128; 64-byte for 32; 32-byte for 16), zero lanes from TMA for
    widths between them, a zero-padded copy for a width that is not a
    multiple of 8 (20); above 128 cross_attention.cu's slices of 128
    columns; one bf16 ulp of the largest output, and exactly 0 for the
    image with no valid key."""
    q, k, v, km = _rect(card, lq, lk, torch.bfloat16, dh)
    before = kernels.launches["cross_attention"]
    out = ak.cross_attention_core(q, k, v, km)
    ref = ak.cross_attention_core_plain(q, k, v, km)
    assert kernels.launches["cross_attention"] == before + 1
    assert out.dtype == torch.float32 and not out[2].any()
    torch.testing.assert_close(out, ref, rtol=0, atol=_bf16_ulp(float(ref.abs().max())))


def test_attention_fwd_export_takes_long_sequences_bf16(card):
    """K1 under bf16 keeps no whole score row: L 4096 runs, and its two
    launches (statistics, then map) each match their plain versions."""
    q, k, v, km = _qkv(card, 2, 2, 4096, 64, torch.bfloat16, (4096, 1500))
    before = kernels.launches["attention_fwd_export"]
    stats = torch.empty((2, 2, 4096, 2), device=card)
    out, amap = ak.attention_core(q, k, v, km, export_weights=True, stats=stats)
    assert kernels.launches["attention_fwd_export"] == before + 1
    ref, ref_map = ak.attention_core_plain(q, k, v, km, export_weights=True)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=_bf16_ulp(float(ref.float().abs().max())))
    torch.testing.assert_close(amap, ref_map, rtol=0, atol=2e-5)
    want = ak.attention_row_stats_plain(q, k, km)
    torch.testing.assert_close(stats, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(amap, ak.attention_map_plain(q, k, km, stats), rtol=0,
                               atol=2e-5)


def test_attention_fwd_export_map_is_deterministic(card):
    """K1's map is summed over heads in registers, in head order, without
    atomics: two calls give the same bits."""
    q, k, v, km = _qkv(card, 3, 12, 1025, 64, torch.bfloat16, (1025, 600, 0))
    before = kernels.launches["attention_fwd_export"]
    out1, map1 = ak.attention_core(q, k, v, km, export_weights=True)
    out2, map2 = ak.attention_core(q, k, v, km, export_weights=True)
    assert kernels.launches["attention_fwd_export"] == before + 2
    assert torch.equal(map1, map2) and torch.equal(out1, out2)
    assert not map1[2].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk,dh", [(2100, 400, 64), (400, 2100, 64), (64, 5376, 64)]
                         + [(2100, 400, dh) for dh in WIDTHS if dh != 64])
def test_attention_bwd_rect_kernel_matches_plain(card, dtype, lq, lk, dh):
    """K3-rect: each gradient against its own largest magnitude, fp32 to
    1e-5 of it, bf16 to one bf16 ulp (2^-8) of it (a P or dS element at a
    rounding midpoint may round either way); at every head width (128:
    CTI's at the tiny config)."""
    q, k, v, km = _rect(card, lq, lk, dtype, dh)
    do = torch.randn(q.shape, device=card)
    before = kernels.launches["attention_bwd_rect"]
    got = ak.attention_bwd(q.float(), k, v, do, km, dtype)
    ref = ak.attention_bwd_plain(q.float(), k, v, do, km, dtype)
    assert kernels.launches["attention_bwd_rect"] == before + 1
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=0, atol=rel * float(r.abs().max()))


@pytest.mark.parametrize("b,c,h,w", [
    (2, 5, 40, 56),       # one tile column, cut rows
    (3, 5, 77, 131),      # tiles cut at both edges; rows not 16-byte aligned
    (1, 21, 20, 28),      # dilation 24 exceeds H and W; four channel chunks
    (1, 1, 512, 512),     # whole tiles, one channel
])
def test_par_kernels_match_plain(card, b, c, h, w):
    """K4 and K5 on 2-D tiles at the full dilations, 3 iterations, against
    the plain versions at 2e-5; one K5 call counts num_iter launches and
    leaves the caller's masks untouched."""
    cfg = ParConfig(num_iter=3)
    g = torch.Generator(device=card).manual_seed(0)
    imgs = torch.randn((b, 3, h, w), generator=g, device=card)
    aff = pk.par_affinity(imgs, cfg)
    torch.testing.assert_close(aff, par_plain.par_affinity(imgs, cfg),
                               rtol=2e-5, atol=2e-5)
    masks = torch.rand((b, c, h, w), generator=g, device=card)
    before, kept = kernels.launches["par_propagate"], masks.clone()
    got = pk.par_propagate(masks, aff, cfg)
    assert kernels.launches["par_propagate"] == before + cfg.num_iter
    torch.testing.assert_close(got, par_plain.par_propagate(masks, aff, cfg),
                               rtol=2e-5, atol=2e-5)
    assert torch.equal(masks, kept)


@pytest.mark.parametrize("c", [7, 33, 81])
def test_par_propagate_any_channel_count(card, c):
    """K5 past one chunk of 6 channels: 7 (two chunks), 33 (six) and 81
    (COCO's background plus 80 classes: fourteen, the last of 3) against
    the plain version at 2e-5, 20 iterations, full dilations."""
    cfg = ParConfig()
    g = torch.Generator(device=card).manual_seed(c)
    imgs = torch.randn((1, 3, 96, 136), generator=g, device=card)
    masks = torch.rand((1, c, 96, 136), generator=g, device=card)
    aff = pk.par_affinity(imgs, cfg)
    torch.testing.assert_close(pk.par_propagate(masks, aff, cfg),
                               par_plain.par_propagate(masks, aff, cfg),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("num_iter", [0, 1, 2])
def test_par_propagate_iteration_counts(card, num_iter):
    """The C loop leaves the result in the returned buffer for any count:
    0 returns the masks, 1 needs no scratch buffer, 2 ends in it after
    one swap."""
    cfg = ParConfig(dilations=(1, 2, 4), num_iter=num_iter)
    g = torch.Generator(device=card).manual_seed(1)
    imgs = torch.randn((2, 3, 24, 72), generator=g, device=card)
    masks = torch.rand((2, 3, 24, 72), generator=g, device=card)
    aff = pk.par_affinity(imgs, cfg)
    torch.testing.assert_close(pk.par_propagate(masks, aff, cfg),
                               par_plain.par_propagate(masks, aff, cfg),
                               rtol=2e-5, atol=2e-5)


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    q, k, v, km = _qkv(card, 1, 2, 16, 0, torch.float32, (16,))
    with pytest.raises(ValueError, match="head dim 0"):
        ak.attention_core(q, k, v, km)                       # Dh 0
    with pytest.raises(ValueError, match="head dim 0"):
        ak.cross_attention_core(q, k, v, km)
    q, k, v, km = _qkv(card, 1, 2, 16, 64, torch.float16, (16,))
    with pytest.raises(ValueError):
        ak.attention_core(q, k, v, km)                       # fp16
    with pytest.raises(ValueError):
        pk.par_affinity(torch.zeros((1, 3, 8, 8), device=card, dtype=torch.float64),
                        ParConfig())
    with pytest.raises(ValueError):
        ak.cross_attention_core(q, k[:, :, :8], v[:, :, :8], km[:, :8])   # fp16
    with pytest.raises(ValueError):                          # no dilation
        pk.par_affinity(torch.zeros((1, 3, 8, 8), device=card), ParConfig(dilations=()))
    # the refused requests leave no error behind for the next launch
    assert np.isfinite(ak.attention_core(*_qkv(card, 1, 2, 16, 64, torch.float32,
                                               (16,)))[0].cpu().numpy()).all()


@pytest.mark.parametrize("dh", COMPILED)
@pytest.mark.parametrize("l", [2048, 4096])
def test_attention_fwd_export_fp32_takes_long_sequences(card, l, dh):
    """K1 under fp32 is a key-tiled forward with row statistics and a map
    kernel: L past the old whole-row limit (about 1650) runs at every
    compiled width, output and map within 2e-5 of the plain version, an
    image with masked keys, and the statistics written to the caller's
    buffer."""
    q, k, v, km = _qkv(card, 2, 3, l, dh, torch.float32, (l, l // 3))
    stats = torch.empty((2, 3, l, 2), device=card)
    before = kernels.launches["attention_fwd_export"]
    out, amap = ak.attention_core(q, k, v, km, export_weights=True, stats=stats)
    assert kernels.launches["attention_fwd_export"] == before + 1
    ref, ref_map = ak.attention_core_plain(q, k, v, km, export_weights=True)
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-5)
    torch.testing.assert_close(amap, ref_map, rtol=0, atol=2e-5)
    want = ak.attention_row_stats_plain(q, k, km)
    torch.testing.assert_close(stats, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("far", [None, True])
@pytest.mark.parametrize("dil", [(1, 2, 4, 8, 12, 24, 32, 48), (5,), (1, 2, 64),
                                 (1, 2, 4, 8, 12, 24)])
@pytest.mark.parametrize("b,c,h,w", [(1, 5, 20, 28), (2, 7, 130, 200)])
def test_par_kernels_any_dilation_set(card, dil, b, c, h, w, far):
    """K4 and K5 at dilation sets past the packed form (more than 6, above
    the staged halo of 24, past the image), at one small dilation and at
    the shipped set, K5 in the form its wrapper picks and in the far form
    asked for, against the plain versions at 2e-5."""
    cfg = ParConfig(dilations=dil, num_iter=5)
    g = torch.Generator(device=card).manual_seed(2)
    imgs = torch.randn((b, 3, h, w), generator=g, device=card)
    aff = pk.par_affinity(imgs, cfg)
    torch.testing.assert_close(aff, par_plain.par_affinity(imgs, cfg), rtol=2e-5, atol=2e-5)
    masks = torch.rand((b, c, h, w), generator=g, device=card)
    torch.testing.assert_close(pk.par_propagate(masks, aff, cfg, far=far),
                               par_plain.par_propagate(masks, aff, cfg),
                               rtol=2e-5, atol=2e-5)


# K7's tiles are 8 rows x 32 columns and its instances hold 1, 2, 3, 4, 6,
# 8, 11 or 16 tiles of 8 channel columns (the ones column included), 127
# channels a block: channel counts at and past those edges, grids that are
# not whole tiles, r 0 and r past the grid
@pytest.mark.parametrize("b, c, hs, ws, r", [
    (2, 21, 40, 36, 8), (1, 81, 33, 47, 5), (3, 1, 12, 12, 13), (2, 40, 20, 20, 0),
    (2, 7, 19, 45, 3), (1, 8, 9, 70, 0), (2, 9, 17, 33, 20), (1, 81, 70, 41, 32),
    (1, 100, 26, 35, 7), (1, 1, 5, 3, 9), (1, 7, 13, 11, 0), (1, 200, 11, 38, 4)])
def test_crf_window_kernel_matches_plain(card, b, c, hs, ws, r):
    """K7 against its plain twin: the message and the normalizer within
    1e-5 of each output's largest, the reference's wrap rule at the edges
    (r larger than the grid included), and the normalizer-only call."""
    from weclip_tpu_torch.refine import crf_kernels as ck
    g = torch.Generator(device=card).manual_seed(0)
    q = torch.rand((b, c, hs, ws), generator=g, device=card)
    img = torch.rand((b, 3, hs, ws), generator=g, device=card) * 4
    before = kernels.launches["crf_window"]
    acc, norm = ck.window_message(q, img, 2.5, r)
    _, norm_only = ck.window_message(None, img, 2.5, r)
    assert kernels.launches["crf_window"] == before + 2
    ref_acc, ref_norm = ck.window_message_plain(q, img, 2.5, r)
    for got, ref in ((acc, ref_acc), (norm, ref_norm), (norm_only, ref_norm)):
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("dtype,dh", [(torch.float32, d) for d in (8, 48, 80, 128, 160, 320)]
                         + [(torch.bfloat16, d) for d in (160, 320)])
@pytest.mark.parametrize("l", [1025, 333])
def test_attention_map_kernel_matches_plain(card, dtype, dh, l):
    """K1's map kernel (csrc/attention.cu: fp32 at every width, bf16 above
    128) against the plain version, each within 2e-5: the whole call's map,
    and the map from the kernel's own row statistics
    (``attention_map_plain``), at L 1025 and a ragged L, an image with
    masked keys and one with none valid; each row of a valid image sums to
    1."""
    q, k, v, km = _qkv(card, 3, 4, l, dh, dtype, (l, l // 3, 0))
    stats = torch.empty((3, 4, l, 2), device=card)
    before = kernels.launches["attention_fwd_export"]
    _, amap = ak.attention_core(q, k, v, km, export_weights=True, stats=stats)
    assert kernels.launches["attention_fwd_export"] == before + 1
    _, ref_map = ak.attention_core_plain(q, k, v, km, export_weights=True)
    torch.testing.assert_close(amap, ref_map, rtol=0, atol=2e-5)
    torch.testing.assert_close(amap, ak.attention_map_plain(q, k, km, stats), rtol=0,
                               atol=2e-5)
    torch.testing.assert_close(amap[:2].sum(-1), torch.ones((2, l), device=card), rtol=0,
                               atol=1e-4)
    assert not amap[2].any()
