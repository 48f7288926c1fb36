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


def test_upsample_pos_emb_matches_jax():
    pe = np.random.default_rng(3).standard_normal((1 + 14 * 14, 8)).astype(np.float32)
    ref = np.asarray(jresize.upsample_pos_emb(jnp.asarray(pe), 6, 9))
    got = tresize.upsample_pos_emb(torch.from_numpy(pe), 6, 9)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_par_kernel_wrappers_reject_bad_config():
    with pytest.raises(ValueError):
        tpk._dilations(ParConfig(dilations=tuple(range(1, 8))))
