"""The port's CoMer branch (weclip_tpu_torch/models/comer.py) and its
attention kernels' plain versions (K6, K3-rect) against the JAX package, on
numpy-seeded inputs with weights carried by weclip_tpu_torch.convert.

Tolerances: 2e-5 for fp32 attention outputs and, relative to each
gradient's own largest magnitude, for the rectangular backward (the
calibration of tests/test_torch_attention.py); one bf16 ulp of the largest
magnitude where both sides round P to bf16; 1e-4 for the multi-layer CoMer
forward under the fp32 policy; 5e-4 for gradients through it."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_support  # noqa: F401
from weclip_tpu.core import precision as jprec
from weclip_tpu.core.config import ComerConfig
from weclip_tpu.models import comer as jcomer
from weclip_tpu.ops import pallas_attention as jpal
from weclip_tpu_torch import convert
from weclip_tpu_torch.core import config as tconfig
from weclip_tpu_torch.core import precision as tprec
from weclip_tpu_torch.models import comer as tcomer
from weclip_tpu_torch.ops import attention_kernels as tak

F32_TOL = 2e-5
FWD_TOL = 1e-4
GRAD_TOL = 5e-4


def small_comer_cfg():
    return ComerConfig(enabled=True, stem_width=8, pyramid_dims=(16, 16, 16),
                       mrfp_dilations=(1, 2), cti_heads=2,
                       interaction_indexes=(2, 5))


def bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _rect(seed, b, h, lq, lk, dh, n_valid):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, lq, dh)).astype(np.float32) * dh ** -0.5
    k, v = (rng.standard_normal((b, h, lk, dh)).astype(np.float32) for _ in range(2))
    kmask = np.zeros((b, lk), np.float32)
    for i, n in enumerate(n_valid):
        kmask[i, :n] = 1.0
    return q, k, v, kmask


# CTI's head width at tests/tiny.py's config is 256 / 2 = 128; the rest are
# the kernels' other compiled widths and widths between them
HEAD_DIMS = [8, 20, 32, 48, 80, 128]


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("lq,lk", [(40, 23), (19, 70)])
def test_cross_attention_core_plain_matches_pallas(lq, lk, dh):
    """(1) K6's plain version vs cross_attention_core_pallas(interpret=True),
    Lq != Lk, partly masked keys and one all-masked key row, fp32 and
    bf16."""
    q, k, v, kmask = _rect(0, 3, 2, lq, lk, dh, (lk, lk // 2, 0))
    ref = jpal.cross_attention_core_pallas(*map(jnp.asarray, (q, k, v, kmask)),
                                           interpret=True, score_dtype=jnp.float32)
    got = tak.cross_attention_core(*map(torch.from_numpy, (q, k, v, kmask)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=F32_TOL, atol=F32_TOL)
    assert not got[2].any()

    bf = [np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in (q, k, v)]
    ref = np.asarray(jpal.cross_attention_core_pallas(
        *map(jnp.asarray, bf), jnp.asarray(kmask), interpret=True,
        score_dtype=jnp.bfloat16))
    got = tak.cross_attention_core(
        *(torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16) for x in bf),
        torch.from_numpy(kmask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=bf16_ulp(np.abs(ref).max()))


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("lq,lk", [(52, 18), (18, 52)])
def test_attention_bwd_rect_plain_matches_pallas(lq, lk, dh):
    """(2) the rectangular attention_bwd_plain vs
    attention_bwd_pallas(interpret=True) in both directions, each gradient
    to 2e-5 of its own largest magnitude."""
    q, k, v, kmask = _rect(1, 2, 2, lq, lk, dh, (lk, lk - 7))
    do = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    ref = jpal.attention_bwd_pallas(*map(jnp.asarray, (q, k, v, do, kmask)),
                                    interpret=True, score_dtype=jnp.float32)
    got = tak.attention_bwd(*map(torch.from_numpy, (q, k, v, do, kmask)),
                            score_dtype=torch.float32)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=F32_TOL * np.abs(r).max(), err_msg=name)


def test_cross_attention_core_fn_matches_plain_autograd():
    """(3) CrossAttentionCoreFn's CPU route (plain forward, the K3-rect
    formulation as backward) vs autograd through the plain forward, fp32;
    cotangents come back in the primal dtypes."""
    q, k, v, kmask = _rect(3, 2, 2, 30, 13, 16, (13, 5))
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        q.shape).astype(np.float32))
    km = torch.from_numpy(kmask)
    ins = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = tak.CrossAttentionCoreFn.apply(*ins, km)
    g_fn = torch.autograd.grad(out, ins, g)
    ins2 = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    g_pl = torch.autograd.grad(tak.cross_attention_core_plain(*ins2, km), ins2, g)
    for a, r in zip(g_fn, g_pl):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL)
    bins = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True) for x in (q, k, v)]
    out = tak.CrossAttentionCoreFn.apply(*bins, km)
    assert out.dtype == torch.float32
    assert all(t.dtype == torch.bfloat16
               for t in torch.autograd.grad(out, bins, g))


def open_gates(p, seed):
    """The zero-init output projections set to random values, so the branch
    contributes (at init it outputs exactly 0 whatever it computes)."""
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(np.asarray, p)
    rnd = lambda a: (rng.standard_normal(a.shape) * 0.2).astype(np.float32)
    for stage in p["cti"]:
        for d in ("inj", "ext"):
            stage[d]["o_w"] = rnd(stage[d]["o_w"])
            stage[d]["o_b"] = rnd(stage[d]["o_b"])
    p["out_w"] = rnd(p["out_w"])
    return p


def _comer_inputs(seed, b=2, g=4, width=32):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((b, 3, 16 * g, 16 * g)).astype(np.float32)
    tokens = rng.standard_normal((6, b, g * g, width)).astype(np.float32)
    grid = np.zeros((b, g, g), np.float32)
    grid[0] = 1.0
    grid[1, :3, :2] = 1.0                    # a partly invalid grid
    return img, tokens, grid.reshape(b, -1)


def test_comer_forward_matches_jax():
    """(3) comer_forward vs JAX under the fp32 policy, gates opened, a
    partly invalid grid: pins the stride-2 SAME padding, the half-pixel
    nearest level masks and the tanh GELU."""
    cfg = small_comer_cfg()
    p = open_gates(jcomer.init_comer_params(jax.random.PRNGKey(0), cfg,
                                            vit_width=32, embed=16), 5)
    img, tokens, valid = _comer_inputs(6)
    ref = np.asarray(jax.jit(lambda pp: jcomer.comer_forward(
        pp, jnp.asarray(img), jnp.asarray(tokens), jnp.asarray(valid), cfg,
        jprec.FP32))(jax.tree_util.tree_map(jnp.asarray, p)))
    tcfg = tconfig.ComerConfig(**dataclasses.asdict(cfg))
    got = tcomer.comer_forward(convert.comer_from_jax(p), torch.from_numpy(img),
                               torch.from_numpy(tokens), torch.from_numpy(valid),
                               tcfg, tprec.FP32)
    np.testing.assert_allclose(got.numpy(), ref, rtol=FWD_TOL, atol=FWD_TOL)
    assert np.abs(ref[1, valid[1] > 0]).max() > 0.1
    assert not got[1, valid[1] == 0].any()


def test_comer_grad_matches_jax():
    """(3) the gradient of a projection of comer_forward with respect to
    every branch parameter, fp32, gates opened, vs jax.grad."""
    cfg = small_comer_cfg()
    p = open_gates(jcomer.init_comer_params(jax.random.PRNGKey(1), cfg,
                                            vit_width=32, embed=16), 7)
    img, tokens, valid = _comer_inputs(8)
    proj = np.random.default_rng(9).standard_normal((2, 16, 16)).astype(np.float32)

    def jloss(pp):
        out = jcomer.comer_forward(pp, jnp.asarray(img), jnp.asarray(tokens),
                                   jnp.asarray(valid), cfg, jprec.FP32)
        return jnp.sum(out * proj)

    ref = jax.jit(jax.grad(jloss))(jax.tree_util.tree_map(jnp.asarray, p))
    tp = convert.comer_from_jax(p)
    leaves = [t.requires_grad_(True) for t in _leaves(tp)]
    out = tcomer.comer_forward(tp, torch.from_numpy(img), torch.from_numpy(tokens),
                               torch.from_numpy(valid),
                               tconfig.ComerConfig(**dataclasses.asdict(cfg)),
                               tprec.FP32)
    grads = torch.autograd.grad((out * torch.from_numpy(proj)).sum(), leaves)
    ref_leaves = _leaves(convert.to_numpy(convert.comer_from_jax(
        jax.tree_util.tree_map(np.asarray, ref))))
    for g, r in zip(grads, ref_leaves):
        np.testing.assert_allclose(g.numpy(), r, rtol=GRAD_TOL, atol=GRAD_TOL)
    assert all(float(g.abs().max()) > 0 for g in grads)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_eval_with_comer_matches_jax():
    """The msc-flip evaluation programs with the CoMer branch enabled
    (gates opened), fp32, against the JAX package's Evaluator: grid logits
    of both scales within 1e-4 and the pseudo labels exactly."""
    from tests import tiny
    from tests.test_torch_pipeline import SIZES, _examples
    from weclip_tpu.evalx import runner as jrunner
    from weclip_tpu.models import weclip as jweclip
    from weclip_tpu_torch.evalx import runner as trunner

    cfg = tiny.tiny_config(num_classes=6)
    cfg = dataclasses.replace(
        cfg, clip=dataclasses.replace(tiny.tiny_clip_config(layers=4), embedding_dim=32),
        comer=dataclasses.replace(small_comer_cfg(), interaction_indexes=(1, 2)),
        eval=dataclasses.replace(cfg.eval, resize_long=96))
    tcfg = tconfig.from_dict(dataclasses.asdict(cfg))
    frozen, _ = tiny.tiny_frozen(cfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    jweclip.init_trainable_params(jax.random.PRNGKey(4), cfg))
    params["comer"] = open_gates(params["comer"], 11)
    tfrozen = convert.frozen_from_jax(jax.tree_util.tree_map(np.asarray, frozen))
    tparams = convert.params_from_jax(params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    pe = np.asarray(frozen["visual"]["positional_embedding"])
    max_ori = max(max(s) for s in SIZES)
    jev = jrunner.Evaluator(cfg, jrunner.make_prep(cfg, max_ori, 96), pe, policy=jprec.FP32)
    tev = trunner.Evaluator(tcfg, trunner.make_prep(tcfg, max_ori, 96), pe,
                            policy=tprec.FP32, device="cpu")
    examples = _examples(cfg)
    sb1, sb2, sizes, _, pres, idx, act = jev.build_batch(examples)
    j1 = jev.scale1_for(idx.shape[1])(jparams, frozen, sb1, pres, sizes, idx, act)
    j2 = jev.scale2(jparams, frozen, sb2, pres, sizes)
    tsb1, tsb2, tsizes, _, tpres, tidx, tact = tev.build_batch(examples)
    t1 = tev.scale1_for(tidx.shape[1])(tparams, tfrozen, tsb1, tpres, tsizes, tidx, tact)
    t2 = tev.scale2(tparams, tfrozen, tsb2, tpres, tsizes)
    for name, a, r in (("seg_single", t1[0], j1[0]), ("seg_avg", t1[1], j1[1]),
                       ("scale2", t2, j2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=FWD_TOL, atol=FWD_TOL,
                                   err_msg=name)
    np.testing.assert_array_equal(t1[2].numpy(), np.asarray(j1[2]))
    # the branch contributes: the logits differ from those without it
    t0 = tev.scale1_for(tidx.shape[1])({"head": tparams["head"]}, tfrozen, tsb1, tpres,
                                       tsizes, tidx, tact)
    assert float((t0[0] - t1[0]).abs().max()) > 1e-3
