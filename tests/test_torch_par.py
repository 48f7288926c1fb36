"""The port's PAR (weclip_tpu_torch/refine/par*.py) and resize against the
JAX package: the plain versions of kernels K4 (affinity) and K5
(propagation) against the Pallas kernels in interpret mode, and the
resize helpers against the JAX ones.  Inputs come from numpy seeds; fp32
tolerance 2e-5, the calibration of tests/test_pallas_par.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_support  # noqa: F401
from weclip_tpu.core.config import ParConfig as JParConfig
from weclip_tpu.ops import resize as jresize
from weclip_tpu.refine import par as jpar
from weclip_tpu.refine import pallas_par as jpal
from weclip_tpu_torch.core.config import ParConfig
from weclip_tpu_torch.ops import resize as tresize
from weclip_tpu_torch.refine import par as tpar
from weclip_tpu_torch.refine import par_kernels as tpk

TOL = 2e-5


@pytest.mark.parametrize("b,h,w,dil", [(2, 32, 40, (1, 2)),
                                       (1, 48, 40, (1, 2, 4, 8, 12, 24))])
def test_par_affinity_matches_pallas(b, h, w, dil):
    """(c) K4's plain version vs par_affinity_pallas in the reference
    neighbour order (identity permutation: dilation-major over _OFFSETS)."""
    imgs = np.random.default_rng(0).standard_normal((b, 3, h, w)).astype(np.float32)
    n = 8 * len(dil)
    ref = np.asarray(jpal.par_affinity_pallas(
        jnp.asarray(imgs), JParConfig(dilations=dil), order=tuple(range(n)),
        w_out=jpal._round_up(w, 128), interpret=True))[..., :w]
    got = tpk.par_affinity(torch.from_numpy(imgs), ParConfig(dilations=dil))
    assert got.shape == (b, n, h, w)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dil,iters,img_hw", [((1, 2, 4), 4, (16, 16)),
                                              ((1, 2), 3, (32, 32))])
def test_par_refine_matches_pallas(dil, iters, img_hw):
    """(c) K5's plain version (through par_refine, with the align_corners
    image resize) vs par_refine_pallas in interpret mode; par_refine_auto
    takes the same plain steps on CPU tensors."""
    rng = np.random.default_rng(1)
    imgs = rng.standard_normal((2, 3) + img_hw).astype(np.float32)
    masks = rng.uniform(0, 1, (2, 5, 32, 32)).astype(np.float32)
    jcfg = JParConfig(dilations=dil, num_iter=iters)
    tcfg = ParConfig(dilations=dil, num_iter=iters)
    ref = np.asarray(jpal.par_refine_pallas(jnp.asarray(imgs), jnp.asarray(masks),
                                            jcfg, interpret=True))
    got = tpar.par_refine(torch.from_numpy(imgs), torch.from_numpy(masks), tcfg)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    auto = tpar.par_refine_auto(torch.from_numpy(imgs), torch.from_numpy(masks), tcfg)
    np.testing.assert_array_equal(auto.numpy(), got.numpy())


@pytest.mark.parametrize("b,c,h,w,dil,iters", [
    (1, 21, 20, 28, (1, 2, 4, 8, 12, 24), 2),   # the clamp reaches past the image
    (2, 5, 37, 45, (1, 2, 4), 3),                 # ragged
    (1, 81, 24, 40, (1, 2, 4, 8, 12, 24), 2),    # COCO without class ids
    # sets past the packed form's 6 dilations of at most 24 (the far form)
    (1, 5, 20, 28, (1, 2, 4, 8, 12, 24, 32, 48), 2),
    (1, 5, 20, 28, (5,), 2),
    (1, 5, 20, 28, (1, 2, 64), 2),
])
def test_par_refine_matches_jax_at_tile_edges(b, c, h, w, dil, iters):
    """The plain par_refine (K4 and K5's oracle) against the JAX XLA
    par_refine at shapes the tiled kernels must get right: an image smaller
    than the largest dilation, and sizes that cut tiles at both edges.  The
    Pallas kernel needs h % 8 == 0, so the XLA formulation is the reference
    here."""
    rng = np.random.default_rng(4)
    imgs = rng.standard_normal((b, 3, h, w)).astype(np.float32)
    masks = rng.uniform(0, 1, (b, c, h, w)).astype(np.float32)
    ref = np.asarray(jpar.par_refine(jnp.asarray(imgs), jnp.asarray(masks),
                                     JParConfig(dilations=dil, num_iter=iters)))
    tcfg = ParConfig(dilations=dil, num_iter=iters)
    got = tpar.par_refine(torch.from_numpy(imgs), torch.from_numpy(masks), tcfg)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    auto = tpar.par_refine_auto(torch.from_numpy(imgs), torch.from_numpy(masks), tcfg)
    np.testing.assert_array_equal(auto.numpy(), got.numpy())


def test_pos_weights_are_computed_once_per_config():
    """K4's wrapper keeps the positional term per config, and its device
    copy per config and device, instead of rebuilding it and copying it to
    the card on every call."""
    cfg = ParConfig()
    first = tpk._pos_weights(cfg.dilations, cfg.w1, cfg.w2)
    np.testing.assert_array_equal(np.asarray(first, np.float32),
                                  tpar.pos_weights(cfg).numpy())
    assert tpk._pos_weights(cfg.dilations, cfg.w1, cfg.w2) is first
    assert len(tpk._pos_weights((1, 2), cfg.w1, cfg.w2)) == 16
    cpu = torch.device("cpu")
    copy = tpk._on_device(tuple(first), torch.float32, cpu)
    np.testing.assert_array_equal(copy.numpy(), tpar.pos_weights(cfg).numpy())
    assert tpk._on_device(tuple(first), torch.float32, cpu) is copy


def test_pos_weights_match_reference():
    """The host positional term of K4 equals the JAX softmax of the
    dilation-scaled offset kernel."""
    cfg = ParConfig()
    pos = jpar._pos_kernel(cfg.dilations)
    np.testing.assert_array_equal(tpar._pos_kernel(cfg.dilations), pos)
    pos_std = float(np.std(pos, ddof=1))
    ref = cfg.w2 * np.asarray(jax.nn.softmax(
        jnp.asarray(-((pos / (pos_std + 1e-8) / cfg.w1) ** 2))))
    np.testing.assert_allclose(tpar.pos_weights(cfg).numpy(), ref,
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("hw_in,hw_out", [((7, 9), (16, 12)), ((20, 20), (5, 3))])
def test_resize_bilinear_matches_jax(align, hw_in, hw_out):
    x = np.random.default_rng(2).standard_normal((2, 3) + hw_in).astype(np.float32)
    ref = np.asarray(jresize.resize_bilinear(jnp.asarray(x), *hw_out,
                                             align_corners=align))
    got = tresize.resize_bilinear(torch.from_numpy(x), *hw_out, align_corners=align)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("hw_in,hw_out", [((7, 9), (16, 12)), ((20, 20), (5, 3)),
                                          ((5, 5), (5, 5))])
def test_resize_nearest_matches_jax(dtype, hw_in, hw_out):
    """Torch's nearest rule, index for index (exact, any dtype)."""
    x = (np.random.default_rng(4).standard_normal((2, 3) + hw_in) * 50).astype(dtype)
    ref = np.asarray(jresize.resize_nearest(jnp.asarray(x), *hw_out))
    got = tresize.resize_nearest(torch.from_numpy(x), *hw_out)
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), ref)


def test_upsample_pos_emb_matches_jax():
    pe = np.random.default_rng(3).standard_normal((1 + 14 * 14, 8)).astype(np.float32)
    ref = np.asarray(jresize.upsample_pos_emb(jnp.asarray(pe), 6, 9))
    got = tresize.upsample_pos_emb(torch.from_numpy(pe), 6, 9)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_par_kernel_wrappers_reject_bad_config():
    """The kernels take any non-empty set of dilations >= 1 (more than 6,
    and wider than the staged halo of 24, run the far form); an empty set
    or a dilation below 1 is refused."""
    with pytest.raises(ValueError):
        tpk.effective_dilations((), 20, 28)
    with pytest.raises(ValueError):
        tpk.effective_dilations((1, 0), 20, 28)
    assert tpk.effective_dilations(tuple(range(1, 8)), 512, 512) == tuple(range(1, 8))
    assert tpk.effective_dilations((1, 2, 64), 20, 28) == (1, 2, 27)
    assert tpk.effective_dilations((3,), 1, 1) == (1,)
    # the packed form takes at most 6 dilations of at most 24, the far form the rest
    assert tpk.packed((1, 2, 4, 8, 12, 24)) and tpk.packed((5,))
    assert not tpk.packed(tuple(range(1, 8))) and not tpk.packed((1, 2, 27))


@pytest.mark.parametrize("dil,h,w", [((1, 2, 64), 20, 28), ((5, 48), 9, 3), ((2,), 1, 1)])
def test_effective_dilations_read_the_same_neighbours(dil, h, w):
    """The wrappers hand the kernels min(d, max(H, W) - 1): on the plain
    versions, affinities (positional term off: it is computed from the true
    dilations) and propagation are bit-equal with either set."""
    rng = np.random.default_rng(7)
    imgs = torch.from_numpy(rng.standard_normal((1, 3, h, w)).astype(np.float32))
    masks = torch.from_numpy(rng.uniform(0, 1, (1, 4, h, w)).astype(np.float32))
    eff = tpk.effective_dilations(dil, h, w)
    cfgs = [ParConfig(dilations=d, w2=0.0, num_iter=2) for d in (dil, eff)]
    aff = [tpar.par_affinity(imgs, c) for c in cfgs]
    assert torch.equal(aff[0], aff[1])
    assert torch.equal(tpar.par_propagate(masks, aff[0], cfgs[0]),
                       tpar.par_propagate(masks, aff[0], cfgs[1]))


def _fma32(a, b, c):
    """float32 fma(a, b, c), rounded once: a * b is exact in float64, the
    sum is made exact by TwoSum and rounded to odd, from which the float32
    rounding is the correct one (53 >= 24 + 2 bits)."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((err != 0) & even, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def _div_by(x, y, r):
    """csrc/par.cu's div_by: q = x * r, then one fma correction step."""
    q = x * r
    return _fma32(_fma32(-q, y, x), r, q)


def test_fma32_emulation_is_exact():
    # (1 + 2^-23)(1 - 2^-24) - 1: rounding the product first gives 0;
    # (1 + 2^-12)^2 + 2^-80 lies just above a float32 midpoint, which
    # rounding the float64 sum first lands on and then rounds to even, down
    a = np.array([1 + 2 ** -23, 1 + 2 ** -12], np.float32)
    b = np.array([1 - 2 ** -24, 1 + 2 ** -12], np.float32)
    c = np.array([-1, 2 ** -80], np.float32)
    want = np.array([2 ** -24 - 2 ** -47, 1 + 2 ** -11 + 2 ** -23], np.float32)
    assert float(want[0]) == 2 ** -24 - 2 ** -47
    np.testing.assert_array_equal(_fma32(a, b, c), want)


def test_par_affinity_division_rounds_as_ieee():
    """K4 divides by 3 (the RGB mean of the logits) and by the softmax sum
    (in [1, 48]; the dividend, one of its terms, in (0, sum]) as div_by,
    from the correctly rounded reciprocal: the quotient must be the IEEE
    x / y.  By 3: every float32 mantissa of one binade (the quotient's
    mantissa does not depend on x's exponent while it stays normal); by the
    sum: random pairs over every binade of [1, 64)."""
    y3 = np.float32(3)
    r3 = np.float32(1) / y3
    mant = np.arange(1 << 23, dtype=np.int64)
    for part in np.array_split(mant, 4):
        x = -((part + (127 << 23)).astype(np.int32).view(np.float32))   # [-2, -1)
        np.testing.assert_array_equal(_div_by(x, y3, r3), x / y3)
    rng = np.random.default_rng(0)
    for _ in range(4):
        y = (2.0 ** rng.integers(0, 6, 1 << 20)
             * rng.uniform(1, 2, 1 << 20)).astype(np.float32)
        y = np.minimum(y, np.float32(48))
        x = (y * np.exp2(-rng.uniform(0, 100, y.size))).astype(np.float32)
        r = np.float32(1) / y
        np.testing.assert_array_equal(_div_by(x, y, r), x / y)
