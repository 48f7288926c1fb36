"""The port's CAM engines against the JAX package at a tiny size (width 64,
2 heads, 4 layers), the same weights (``convert.py``) and numpy-seeded
inputs (LayerNorm parameters drawn like a trained checkpoint's), fp32 on
the CPU: every method of ``cam_single`` (the perturbation
pair at ``top_channels=8``, and both at every channel), ``make_cam_program``
and ``WeCLIPPipeline.cam``, and the targets' seeds.

Tolerances: CAM maps within 1e-4; the eigen pair's projections before the
ReLU within 1e-4 up to each map's sign (a singular vector's sign is
arbitrary), and their final maps equal to the port's own finish of that
projection; seeds within 1e-6."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import tiny
from tests.test_torch_pipeline import _valid
from weclip_tpu.cam import highres as jhighres
from weclip_tpu.cam import targets as jtargets
from weclip_tpu.cam import variants as jvar
from weclip_tpu.core import precision as jprec
from weclip_tpu.evalx import runner as jrunner
from weclip_tpu.models import weclip as jweclip
from weclip_tpu_torch import convert
from weclip_tpu_torch.cam import highres as thighres
from weclip_tpu_torch.cam import targets as ttargets
from weclip_tpu_torch.cam import variants as tvar
from weclip_tpu_torch.core import config as tconfig
from weclip_tpu_torch.core import precision as tprec
from weclip_tpu_torch.evalx import runner as trunner

CAM_TOL = 1e-4
SIZES = [(40, 56), (56, 36)]


@pytest.fixture(scope="module")
def models():
    cfg = tiny.tiny_config(num_classes=6)
    cfg = dataclasses.replace(
        cfg, clip=tiny.tiny_clip_config(layers=4),
        eval=dataclasses.replace(cfg.eval, resize_long=96, batch_images=2))
    tcfg = tconfig.from_dict(dataclasses.asdict(cfg))
    frozen, _ = tiny.tiny_frozen(cfg)
    frozen = dict(frozen, visual=_trained_layer_norms(frozen["visual"]))
    params = jweclip.init_trainable_params(jax.random.PRNGKey(1), cfg)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return (cfg, tcfg, frozen, params, convert.frozen_from_jax(np_tree(frozen)),
            convert.params_from_jax(np_tree(params)))


def _trained_layer_norms(visual, seed: int = 9):
    """The vision tower with LayerNorm gains 1 + N(0, 0.1) and biases
    N(0, 0.1), as a trained checkpoint has.  At CLIP's init (gain 1, bias
    0) every token's ln_1 channels sum to zero, so ScoreCAM at every
    channel (near-uniform softmax weights) sums terms that cancel to
    rounding, and its min-max map is ill-conditioned in both packages."""
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map(np.asarray, visual)

    def redraw(ln):
        return {"g": (1.0 + 0.1 * rng.standard_normal(ln["g"].shape)).astype(np.float32),
                "b": (0.1 * rng.standard_normal(ln["b"].shape)).astype(np.float32)}

    for name in ("ln_pre", "ln_post"):
        out[name] = redraw(out[name])
    for name in ("ln_1", "ln_2"):
        out["blocks"][name] = redraw(out["blocks"][name])
    return jax.tree_util.tree_map(jnp.asarray, out)


@pytest.fixture(scope="module")
def image_inputs(models):
    """One image's block-11 input tokens on a 4 x 4 grid with a 3 x 4 valid
    region, the text rows [fg ; bg], its mask and the classes."""
    frozen = models[2]
    g = 4
    rng = np.random.default_rng(3)
    valid = _valid(1, g, [(3, 4)])[0]
    x11 = rng.standard_normal((1 + g * g, 64)).astype(np.float32) * valid[:, None]
    text = np.concatenate([np.asarray(frozen["fg_text"]), np.asarray(frozen["bg_text"])])
    tmask = np.ones(text.shape[0], bool)
    tmask[1] = False
    ci = np.array([0, 2, 4], np.int32)
    return x11, text, tmask, valid, ci


def _both(models, image_inputs, method, **kw):
    """(port's maps, JAX's maps) of ``method`` on the fixture image."""
    cfg, tcfg, frozen, _, tfrozen, _ = models
    x11, text, tmask, valid, ci = image_inputs
    if method in ("score_cam", "ablation_cam"):
        ref = getattr(jvar, method)(frozen["visual"], frozen["logit_scale"],
                                    jnp.asarray(x11), jnp.asarray(text), jnp.asarray(tmask),
                                    jnp.asarray(valid), jnp.asarray(ci), cfg.clip,
                                    jprec.FP32, **kw)
    else:
        ref = jvar.cam_single(method, frozen["visual"], frozen["logit_scale"],
                              jnp.asarray(x11), jnp.asarray(text), jnp.asarray(tmask),
                              jnp.asarray(valid), jnp.asarray(ci), cfg.clip, jprec.FP32)
    got = tvar.cam_single(method, tfrozen["visual"], tfrozen["logit_scale"],
                          torch.from_numpy(x11), torch.from_numpy(text),
                          torch.from_numpy(tmask), torch.from_numpy(valid),
                          torch.from_numpy(ci).long(), tcfg.clip, tprec.FP32, **kw)
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("method", ["grad_cam", "grad_cam_pp", "xgrad_cam", "layer_cam"])
def test_gradient_cams_match_jax(models, image_inputs, method):
    got, ref = _both(models, image_inputs, method)
    assert got.shape == (3, 16)
    np.testing.assert_allclose(got, ref, rtol=CAM_TOL, atol=CAM_TOL)
    assert got.min() >= 0.0 and got.max() <= 1.0 + 1e-6


@pytest.mark.parametrize("method", ["eigen_cam", "eigen_grad_cam"])
def test_eigen_cams_match_jax_up_to_sign(models, image_inputs, method):
    """The projections before the ReLU agree up to each map's sign; the
    port's final map is its own projection finished."""
    cfg, tcfg, frozen, _, tfrozen, _ = models
    x11, text, tmask, valid, ci = image_inputs
    acts, grads, _ = jvar._acts_and_grads(
        frozen["visual"], frozen["logit_scale"], jnp.asarray(x11), jnp.asarray(text),
        jnp.asarray(tmask), jnp.asarray(valid), jnp.asarray(ci), cfg.clip, jprec.FP32)
    ref = np.asarray(getattr(jvar, method)(acts, grads, jnp.asarray(valid)))
    args = (tfrozen["visual"], tfrozen["logit_scale"], torch.from_numpy(x11),
            torch.from_numpy(text), torch.from_numpy(tmask), torch.from_numpy(valid),
            torch.from_numpy(ci).long(), tcfg.clip, tprec.FP32)
    raw = tvar.raw_maps(method, *args)
    got = raw.numpy()
    assert got.shape == ref.shape == (3, 16)
    for g, r in zip(got, ref):
        sign = np.sign(np.dot(g, r))
        np.testing.assert_allclose(sign * g, r, rtol=CAM_TOL, atol=CAM_TOL)
    final = tvar.cam_single(method, *args)
    np.testing.assert_array_equal(final.numpy(),
                                  tvar._finish(raw, torch.from_numpy(valid)).numpy())


@pytest.mark.parametrize("method,top", [("score_cam", 8), ("ablation_cam", 8),
                                        ("score_cam", None), ("ablation_cam", None)])
def test_perturbation_cams_match_jax(models, image_inputs, method, top):
    got, ref = _both(models, image_inputs, method, top_channels=top)
    np.testing.assert_allclose(got, ref, rtol=CAM_TOL, atol=CAM_TOL)


@pytest.mark.parametrize("method", ["score_cam", "ablation_cam", "grad_cam_pp"])
def test_cams_run_under_the_bf16_policy(models, image_inputs, method):
    """Under the default (bf16) policy the activations are bf16: the
    perturbation masks are built in fp32 as JAX's promotion does, and the
    maps stay finite and in [0, 1]."""
    _, tcfg, _, _, tfrozen, _ = models
    x11, text, tmask, valid, ci = image_inputs
    got = tvar.cam_single(method, tfrozen["visual"], tfrozen["logit_scale"],
                          torch.from_numpy(x11).bfloat16(), torch.from_numpy(text),
                          torch.from_numpy(tmask), torch.from_numpy(valid),
                          torch.from_numpy(ci).long(), tcfg.clip, tprec.DEFAULT,
                          top_channels=8)
    assert got.dtype == torch.float32 and got.shape == (3, 16)
    assert torch.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0 + 1e-6


def test_cam_single_refuses_unknown_method(models, image_inputs):
    _, tcfg, _, _, tfrozen, _ = models
    x11, text, tmask, valid, ci = image_inputs
    with pytest.raises(ValueError, match="unknown CAM method"):
        tvar.cam_single("full_cam", tfrozen["visual"], tfrozen["logit_scale"],
                        torch.from_numpy(x11), torch.from_numpy(text),
                        torch.from_numpy(tmask), torch.from_numpy(valid),
                        torch.from_numpy(ci).long(), tcfg.clip)


def _examples(num_fg):
    rng = np.random.default_rng(5)
    out = []
    for i, (oh, ow) in enumerate(SIZES):
        present = np.zeros(num_fg, bool)
        present[[i, 3]] = True
        out.append({"name": f"im{i}", "img_raw": rng.integers(0, 256, (oh, ow, 3)).astype(
            np.uint8), "label": np.zeros((oh, ow), np.int32), "present_mask": present})
    return out


@pytest.mark.parametrize("method", ["grad_cam", "layer_cam", "score_cam"])
def test_make_cam_program_matches_jax(models, method):
    """Two images of different sizes in one batch: every class's refined
    map on the output canvas within 1e-4."""
    cfg, tcfg, frozen, _, tfrozen, _ = models
    examples = _examples(5)
    pe = np.asarray(frozen["visual"]["positional_embedding"])
    jev = jrunner.Evaluator(cfg, jrunner.make_prep(cfg, 56, 96), pe, policy=jprec.FP32,
                            with_cam=True, msc=False)
    tev = trunner.Evaluator(tcfg, trunner.make_prep(tcfg, 56, 96), pe, policy=tprec.FP32,
                            with_cam=True, msc=False, device="cpu")
    jsb, _, jsizes, _, jpres, _, _ = jev.build_batch(examples)
    ref = np.asarray(jhighres.make_cam_program(cfg, jev.prep, jprec.FP32, method=method)(
        frozen, jsb, jpres, jsizes))
    tsb, _, tsizes, _, tpres, _, _ = tev.build_batch(examples)
    got = thighres.make_cam_program(tcfg, tev.prep, tprec.FP32, method=method)(
        tfrozen, tsb, tpres, tsizes).numpy()
    assert got.shape == ref.shape == (2, 5, 56, 56)
    np.testing.assert_allclose(got, ref, rtol=CAM_TOL, atol=CAM_TOL)
    with pytest.raises(ValueError):
        thighres.make_cam_program(tcfg, tev.prep, tprec.FP32, method="full_cam")


def test_pipeline_cam_matches_jax(models, monkeypatch):
    """``WeCLIPPipeline.cam`` on the same frozen state: (C, H, W) in [0, 1]
    in the order of ``class_ids`` within 1e-4 of JAX's, one program per
    (canvas, method)."""
    from weclip_tpu import api as japi
    from weclip_tpu_torch.api import WeCLIPPipeline
    cfg, tcfg, frozen, params, tfrozen, tparams = models
    im = _examples(5)[1]["img_raw"]
    jpipe = japi.WeCLIPPipeline.__new__(japi.WeCLIPPipeline)
    jpipe.cfg, jpipe.policy, jpipe.frozen, jpipe.params = cfg, jprec.FP32, frozen, params
    jpipe.clip_params = {"visual": frozen["visual"]}
    jpipe._evaluators, jpipe._cam_programs = {}, {}
    tpipe = WeCLIPPipeline(tcfg, precision_name="float32", device="cpu",
                           weights={"params": tparams, "frozen": tfrozen})
    for ids, method in ((None, "grad_cam"), ([3, 0], "grad_cam"), ([2], "xgrad_cam")):
        ref = jpipe.cam(im, class_ids=ids, method=method)
        got = tpipe.cam(im, class_ids=ids, method=method)
        assert got.dtype == np.float32 and got.shape == ref.shape
        assert got.shape == ((5 if ids is None else len(ids)),) + im.shape[:2]
        np.testing.assert_allclose(got, ref, rtol=CAM_TOL, atol=CAM_TOL)
        assert got.min() >= 0.0 and got.max() <= 1.0 + 1e-6
    assert len(tpipe._cam_programs) == 2
    with pytest.raises(ValueError):
        tpipe.cam(im, class_ids=[5])


def test_target_seeds_match_jax():
    """One-hot, softmax-Jacobian and segmentation-mask seeds; the softmax
    target refuses a seed without logits."""
    logits = np.random.default_rng(0).standard_normal((2, 7)).astype(np.float32)
    jt, tt = jtargets.ClassifierOutputTarget(3), ttargets.ClassifierOutputTarget(3)
    np.testing.assert_array_equal(tt.seed(7).numpy(), np.asarray(jt.seed(7)))
    np.testing.assert_array_equal(tt(torch.from_numpy(logits)).numpy(),
                                  np.asarray(jt(jnp.asarray(logits))))
    js, ts = jtargets.ClassifierOutputSoftmaxTarget(2), ttargets.ClassifierOutputSoftmaxTarget(2)
    np.testing.assert_allclose(ts.seed(7, logits=torch.from_numpy(logits)).numpy(),
                               np.asarray(js.seed(7, logits=jnp.asarray(logits))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts(torch.from_numpy(logits[0])).numpy(),
                               np.asarray(js(jnp.asarray(logits[0]))), rtol=1e-6)
    with pytest.raises(ValueError, match="logits"):
        ts.seed(7)
    mask = (np.arange(12).reshape(3, 4) % 2).astype(np.float32)
    jm, tm = jtargets.SemanticSegmentationTarget(1, mask), ttargets.SemanticSegmentationTarget(
        1, mask)
    np.testing.assert_array_equal(tm.seed_fn((3, 3, 4)).numpy(),
                                  np.asarray(jm.seed_fn((3, 3, 4))))
    out = np.random.default_rng(1).standard_normal((3, 3, 4)).astype(np.float32)
    np.testing.assert_allclose(float(tm(torch.from_numpy(out))), float(jm(jnp.asarray(out))),
                               rtol=1e-6)
