"""The port's model and evaluation path against the JAX package at a tiny
size (width 64, 2 heads, 4 layers, PAR dilations (1, 2) with 4 iterations),
both packages running the same weights (carried by weclip_tpu_torch.convert)
on the same numpy-seeded inputs under the fp32 policy.

Tolerances: 1e-4 for the multi-layer forwards and the evaluation logits
(at this size they also agree within 1e-5 on the CPU), 5e-4
for GradCAM (a gradient), 1e-5 for the walk and fusion, and exact equality
for box masks and pseudo labels (integer outputs)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import tiny
from weclip_tpu.cam import gradcam as jcam
from weclip_tpu.core import precision as jprec
from weclip_tpu.evalx import runner as jrunner
from weclip_tpu.models import weclip as jweclip
from weclip_tpu.models.clip import vit as jvit
from weclip_tpu.refine import affinity as jaff
from weclip_tpu.refine import bbox as jbbox
from weclip_tpu_torch import convert
from weclip_tpu_torch.api import WeCLIPPipeline
from weclip_tpu_torch.cam import gradcam as tcam
from weclip_tpu_torch.core import config as tconfig
from weclip_tpu_torch.core import precision as tprec
from weclip_tpu_torch.evalx import runner as trunner
from weclip_tpu_torch.models.clip import vit as tvit
from weclip_tpu_torch.refine import affinity as taff
from weclip_tpu_torch.refine import bbox as tbbox

FWD_TOL = 1e-4
GRAD_TOL = 5e-4
WALK_TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    """(jax cfg, port cfg, jax frozen, jax params, port frozen, port params)."""
    cfg = tiny.tiny_config(num_classes=6)
    cfg = dataclasses.replace(
        cfg, clip=tiny.tiny_clip_config(layers=4),
        eval=dataclasses.replace(cfg.eval, resize_long=96))
    tcfg = tconfig.from_dict(dataclasses.asdict(cfg))
    frozen, _ = tiny.tiny_frozen(cfg)
    params = jweclip.init_trainable_params(jax.random.PRNGKey(1), cfg)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return (cfg, tcfg, frozen, params,
            convert.frozen_from_jax(np_tree(frozen)),
            convert.params_from_jax(np_tree(params)))


def _valid(b, g, regions):
    valid = np.zeros((b, 1 + g * g), bool)
    for i, (gh, gw) in enumerate(regions):
        grid = np.zeros((g, g), bool)
        grid[:gh, :gw] = True
        valid[i, 0] = True
        valid[i, 1:] = grid.reshape(-1)
    return valid


def test_config_copy_matches_reference(models):
    cfg, tcfg = models[0], models[1]
    assert tcfg.clip == tconfig.ClipConfig(**dataclasses.asdict(cfg.clip))
    assert dataclasses.asdict(tconfig.Config().par) == dataclasses.asdict(
        type(cfg.par)())


def test_vision_forward_frozen_attn_rows(models):
    """(d) frozen 3-block forward with padded grids; the first 2 rows
    export maps (K1's route), the other 2 do not (K2's route)."""
    cfg, tcfg, frozen, _, tfrozen, _ = models
    b, g = 4, 4
    rng = np.random.default_rng(0)
    img = rng.standard_normal((b, 3, 64, 64)).astype(np.float32)
    pe_table = np.asarray(frozen["visual"]["positional_embedding"])
    pe = np.stack([jvit.pos_emb_host(pe_table, gh, gw, g, g)
                   for gh, gw in [(4, 4), (3, 4), (4, 2), (4, 4)]])
    np.testing.assert_allclose(
        tvit.pos_emb_host(pe_table, 3, 4, g, g), pe[1], rtol=0, atol=0)
    valid = _valid(b, g, [(4, 4), (3, 4), (4, 2), (4, 4)])
    ref = jvit.vision_forward_frozen(frozen["visual"], jnp.asarray(img),
                                     jnp.asarray(pe), jnp.asarray(valid),
                                     cfg.clip, policy=jprec.FP32, attn_rows=2)
    got = tvit.vision_forward_frozen(tfrozen["visual"], torch.from_numpy(img),
                                     torch.from_numpy(pe), torch.from_numpy(valid),
                                     tcfg.clip, policy=tprec.FP32, attn_rows=2)
    l = valid.shape[1]
    assert got.layer_attn.shape == (3, 2, l, l)
    np.testing.assert_allclose(got.layer_tokens.numpy(),
                               np.asarray(ref.layer_tokens)[:, :, :l],
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(got.layer_attn.numpy(),
                               np.asarray(ref.layer_attn)[:, :, :l, :l],
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("gh,gw,pad", [(4, 4, None), (3, 5, (6, 6)), (7, 2, (7, 4))])
def test_build_pos_emb_matches_jax(models, gh, gw, pad):
    frozen, tfrozen = models[2], models[4]
    pad_gh, pad_gw = pad or (None, None)
    ref = jvit.build_pos_emb(frozen["visual"], gh, gw, pad_gh, pad_gw)
    got = tvit.build_pos_emb(tfrozen["visual"], gh, gw, pad_gh, pad_gw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_head_forward_matches_jax(models):
    """The fuse head and the decoder in one call (fp32, no dropout), on a
    partly invalid grid."""
    from weclip_tpu.models import heads as jheads
    from weclip_tpu_torch.models import heads as theads
    params, tparams = models[3], models[5]
    rng = np.random.default_rng(7)
    tokens = rng.standard_normal((3, 2, 16, 64)).astype(np.float32)
    valid = np.ones((2, 16), bool)
    valid[1, 10:] = False
    ref = jheads.head_forward(params["head"], jnp.asarray(tokens),
                              valid_p=jnp.asarray(valid), policy=jprec.FP32)
    got = theads.head_forward(tparams["head"], torch.from_numpy(tokens),
                              valid_p=torch.from_numpy(valid), policy=tprec.FP32)
    for name, a, r in zip(("seg", "fused", "attn"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=FWD_TOL, atol=FWD_TOL,
                                   err_msg=name)


def test_gradcam_batch_matches_jax(models):
    """(d) GradCAM over a class bucket: the port expands the ln_1 output
    over the bucket and runs one backward; JAX vmaps its pullback."""
    cfg, tcfg, frozen, _, tfrozen, _ = models
    b, g = 2, 4
    rng = np.random.default_rng(1)
    valid = _valid(b, g, [(4, 4), (3, 2)])
    x11 = rng.standard_normal((b, 1 + g * g, 64)).astype(np.float32)
    x11 *= valid[..., None]
    text = np.concatenate([np.asarray(frozen["fg_text"]),
                           np.asarray(frozen["bg_text"])])
    text_mask = np.ones((b, text.shape[0]), bool)
    text_mask[0, 1:3] = False
    cls_idx = np.array([[0, 3, 4], [2, 1, 0]], np.int32)
    jfn = jax.jit(lambda vis, ls, x, t, tm, v, ci: jcam.gradcam_batch(
        vis, ls, x, t, tm, v, 5, cfg.clip, jprec.FP32, class_idx=ci))
    ref = jfn(frozen["visual"], frozen["logit_scale"], jnp.asarray(x11),
              jnp.asarray(text), jnp.asarray(text_mask), jnp.asarray(valid),
              jnp.asarray(cls_idx))
    got = tcam.gradcam_batch(tfrozen["visual"], tfrozen["logit_scale"],
                             torch.from_numpy(x11), torch.from_numpy(text),
                             torch.from_numpy(text_mask), torch.from_numpy(valid),
                             5, tcfg.clip, tprec.FP32,
                             class_idx=torch.from_numpy(cls_idx).long())
    for name in ("cams", "attn_last", "probs"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)


def test_gradcam_single_matches_jax(models):
    """(d) one image's GradCAM: JAX linearizes once and vmaps the pullback
    over the requested classes."""
    cfg, tcfg, frozen, _, tfrozen, _ = models
    g = 4
    rng = np.random.default_rng(6)
    valid = _valid(1, g, [(3, 4)])[0]
    x11 = rng.standard_normal((1 + g * g, 64)).astype(np.float32) * valid[:, None]
    text = np.concatenate([np.asarray(frozen["fg_text"]),
                           np.asarray(frozen["bg_text"])])
    text_mask = np.ones(text.shape[0], bool)
    text_mask[2] = False
    cls_idx = np.array([1, 4], np.int32)
    ref = jcam.gradcam_single(frozen["visual"], frozen["logit_scale"],
                              jnp.asarray(x11), jnp.asarray(text),
                              jnp.asarray(text_mask), jnp.asarray(valid),
                              jnp.asarray(cls_idx), cfg.clip, jprec.FP32)
    got = tcam.gradcam_single(tfrozen["visual"], tfrozen["logit_scale"],
                              torch.from_numpy(x11), torch.from_numpy(text),
                              torch.from_numpy(text_mask), torch.from_numpy(valid),
                              torch.from_numpy(cls_idx).long(), tcfg.clip, tprec.FP32)
    for name, a, r in zip(("cams", "attn_last", "probs"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


def test_scoremap_box_mask_matches_jax():
    """(d) cv2-exact box masks, batched, against the JAX per-map version."""
    rng = np.random.default_rng(2)
    n, g0, g1 = 12, 6, 7
    cams = rng.uniform(0, 1, (n, g0, g1)).astype(np.float32)
    gh = rng.integers(2, g0 + 1, n)
    gw = rng.integers(2, g1 + 1, n)
    valid = np.zeros((n, g0, g1), bool)
    for i in range(n):
        valid[i, :gh[i], :gw[i]] = True
    cams = cams * valid
    cams[0] = 0.0                                    # no component at all
    ref = jax.vmap(lambda c, v, h, w: jbbox.scoremap_box_mask(c, v, h, w, 0.4))(
        jnp.asarray(cams), jnp.asarray(valid), jnp.asarray(gh, jnp.int32),
        jnp.asarray(gw, jnp.int32))
    got = tbbox.scoremap_box_mask(torch.from_numpy(cams), torch.from_numpy(valid),
                                  torch.from_numpy(gh), torch.from_numpy(gw), 0.4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    binary = torch.from_numpy(cams > 0.5)
    ref_cc = jax.vmap(jbbox.connected_components)(jnp.asarray(cams > 0.5))
    np.testing.assert_array_equal(tbbox.connected_components(binary).numpy(),
                                  np.asarray(ref_cc))


def test_box_iou_matches_jax():
    """Pairwise IoU of integer boxes, degenerate pairs included (exact)."""
    rng = np.random.default_rng(5)
    xy = rng.integers(0, 20, (9, 2))
    a = np.concatenate([xy, xy + rng.integers(-2, 8, (9, 2))], axis=1)
    b = np.concatenate([xy[:6] + 1, xy[:6] + rng.integers(-3, 6, (6, 2))], axis=1)
    a[0] = (5, 5, 3, 3)                  # an empty box against every other
    b[0] = (5, 5, 2, 3)                  # zero union with a[0]
    got = tbbox.box_iou(a, b)
    assert got.shape == (9, 6) and got.dtype == np.float64
    np.testing.assert_array_equal(got, jbbox.box_iou(a, b))


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("in_size,out_size,canvas,src_pad",
                         [(7, 13, 16, 8), (20, 15, 15, 20), (5, 1, 4, 6), (1, 9, 12, 3)])
def test_host_resize_matrices_match_jax(in_size, out_size, canvas, src_pad, align):
    """The host matrices of evalx/operators.py against the JAX package's
    (exact) and against the port's device versions, which form the source
    coordinates in fp32 (within 1e-5 at these sizes)."""
    from weclip_tpu.evalx import operators as jops
    from weclip_tpu_torch.evalx import operators as tops
    got = tops.clamp_resize_matrix(in_size, out_size, canvas, src_pad, align)
    np.testing.assert_array_equal(
        got, jops.clamp_resize_matrix(in_size, out_size, canvas, src_pad, align))
    dev = tops.device_resize_matrix(torch.tensor([in_size]), torch.tensor([out_size]),
                                    canvas, src_pad, align)[0]
    np.testing.assert_allclose(got, dev.numpy(), rtol=0, atol=1e-5)
    for scale in (0.75, 1.5):
        out = max(int(in_size * scale), 1)
        np.testing.assert_array_equal(tops.scale_factor_matrix(in_size, out, scale),
                                      jops.scale_factor_matrix(in_size, out, scale))


def test_resize_by_scale_matches_jax():
    from weclip_tpu.evalx import operators as jops
    from weclip_tpu_torch.evalx import operators as tops
    img = np.random.default_rng(6).uniform(0, 255, (3, 37, 50)).astype(np.float32)
    for scale in (0.75, 0.5, 1.25):
        hw = (int(37 * scale), int(50 * scale))
        np.testing.assert_array_equal(tops.resize_by_scale(img, hw, scale),
                                      jops.resize_by_scale(img, hw, scale))


def test_sinkhorn_walk_and_fusion_match_jax():
    """(d) Sinkhorn transition, box-masked random walk, both fusions and
    the Gram affinity against their JAX functions."""
    rng = np.random.default_rng(3)
    b, g, c, k = 2, 4, 3, 4
    p = g * g
    valid = _valid(b, g, [(4, 4), (3, 3)])
    vp = valid[:, 1:]
    layer_attn = rng.uniform(0, 1, (k, b, p + 1, p + 1)).astype(np.float32)
    attn_last = rng.uniform(0, 1, (b, p + 1, p + 1)).astype(np.float32)
    fts = rng.standard_normal((b, p, 8)).astype(np.float32)
    vpf = vp.astype(np.float32)
    seg_attn = np.array(jaff.gram_affinity(jnp.asarray(fts), jnp.asarray(vpf)))
    np.testing.assert_allclose(
        taff.gram_affinity(torch.from_numpy(fts), torch.from_numpy(vpf)).numpy(),
        seg_attn, rtol=WALK_TOL, atol=WALK_TOL)

    ref_plain = jaff.fuse_attention_plain(jnp.asarray(layer_attn),
                                          jnp.asarray(attn_last), 3)
    got_plain = taff.fuse_attention_plain(torch.from_numpy(layer_attn),
                                          torch.from_numpy(attn_last), 3)
    np.testing.assert_allclose(got_plain.numpy(), np.asarray(ref_plain),
                               rtol=WALK_TOL, atol=WALK_TOL)
    ref_g = jaff.fuse_attention_gated(jnp.asarray(layer_attn), jnp.asarray(attn_last),
                                      jnp.asarray(seg_attn), 3, jnp.asarray(vpf))
    got_g = taff.fuse_attention_gated(torch.from_numpy(layer_attn),
                                      torch.from_numpy(attn_last),
                                      torch.from_numpy(seg_attn), 3,
                                      torch.from_numpy(vpf))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(ref_g),
                               rtol=WALK_TOL, atol=WALK_TOL)

    ref_t = jax.vmap(lambda a, v: jaff.sinkhorn_transition(a, v, rounds=3))(
        ref_g, jnp.asarray(vp))
    got_t = taff.sinkhorn_transition(got_g, torch.from_numpy(vp), rounds=3)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t),
                               rtol=WALK_TOL, atol=WALK_TOL)

    cams = rng.uniform(0, 1, (b, c, p)).astype(np.float32) * vpf[:, None]
    gh, gw = np.array([4, 3]), np.array([4, 3])
    ref_w = jax.vmap(lambda cc, t, v, h, w: jaff.random_walk_cams(
        cc, t, v.reshape(g, g), h, w, 0.4))(
        jnp.asarray(cams), ref_t, jnp.asarray(vp), jnp.asarray(gh), jnp.asarray(gw))
    got_w = taff.random_walk_cams(torch.from_numpy(cams), got_t,
                                  torch.from_numpy(vp).reshape(b, g, g),
                                  torch.from_numpy(gh), torch.from_numpy(gw), 0.4)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(ref_w),
                               rtol=WALK_TOL, atol=WALK_TOL)


SIZES = [(40, 56), (56, 36), (30, 50)]
SCALE_FIELDS = ("img", "pos_emb", "valid", "gh", "gw", "w_px")
PRESENT = [(0, 4), (1,), (2, 3, 4)]


def _examples(cfg):
    rng = np.random.default_rng(4)
    nfg = cfg.dataset.num_classes - 1
    out = []
    for (oh, ow), ids in zip(SIZES, PRESENT):
        present = np.zeros(nfg, bool)
        present[list(ids)] = True
        out.append({"img_raw": rng.integers(0, 256, (oh, ow, 3)).astype(np.uint8),
                    "label": np.zeros((oh, ow), np.int32),
                    "present_mask": present})
    return out


@pytest.fixture(scope="module")
def eval_runs(models):
    """Both packages' Evaluators on the same three examples."""
    cfg, tcfg, frozen, params, tfrozen, tparams = models
    pe_table = np.asarray(frozen["visual"]["positional_embedding"])
    max_ori = max(max(s) for s in SIZES)
    jev = jrunner.Evaluator(cfg, jrunner.make_prep(cfg, max_ori, 96), pe_table,
                            policy=jprec.FP32)
    tev = trunner.Evaluator(tcfg, trunner.make_prep(tcfg, max_ori, 96), pe_table,
                            policy=tprec.FP32, device="cpu")
    examples = _examples(cfg)
    jb, tb = jev.build_batch(examples), tev.build_batch(examples)
    sb1, sb2, sizes, _, presents, cls_idx, cls_active = jb
    j1 = jev.scale1_for(cls_idx.shape[1])(params, frozen, sb1, presents, sizes,
                                          cls_idx, cls_active)
    j2 = jev.scale2(params, frozen, sb2, presents, sizes)
    jl = jev.msc_logits(j1[1], j2, sizes)
    tsb1, tsb2, tsizes, _, tpres, tidx, tact = tb
    t1 = tev.scale1_for(tidx.shape[1])(tparams, tfrozen, tsb1, tpres, tsizes,
                                       tidx, tact)
    t2 = tev.scale2(tparams, tfrozen, tsb2, tpres, tsizes)
    tl = tev.msc_logits(t1[1], t2, tsizes)
    return {"jax": (jb, j1, j2, jl), "torch": (tb, t1, t2, tl), "tev": tev}


def test_build_batch_matches_jax(eval_runs):
    """(e) the two runners stage the same batch."""
    jb, tb = eval_runs["jax"][0], eval_runs["torch"][0]
    for jsb, tsb in ((jb[0], tb[0]), (jb[1], tb[1])):
        for name in SCALE_FIELDS:
            np.testing.assert_array_equal(getattr(tsb, name).numpy(),
                                          np.asarray(getattr(jsb, name)), err_msg=name)
    for a, r in zip(tb[2], jb[2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    for i in (3, 4, 5, 6):
        np.testing.assert_array_equal(tb[i].numpy(), np.asarray(jb[i]))



def test_eval_scale1_with_cam_matches_jax(eval_runs):
    """(e) scale 1 with the CAM chain: grid logits at 1e-4 and the pseudo
    labels exactly."""
    (_, j1, _, _), (_, t1, _, _) = eval_runs["jax"], eval_runs["torch"]
    for name, a, r in zip(("seg_single", "seg_avg"), t1[:2], j1[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=name)
    np.testing.assert_array_equal(t1[2].numpy(), np.asarray(j1[2]))
    assert len(np.unique(t1[2].numpy())) > 1


def test_eval_scale2_and_msc_logits_match_jax(eval_runs):
    """(e) the seg-only second scale and the original-resolution logits."""
    (_, _, j2, jl), (_, _, t2, tl) = eval_runs["jax"], eval_runs["torch"]
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=FWD_TOL, atol=FWD_TOL)


def test_eval_scale1_without_cam_matches_with_cam(models, eval_runs):
    """(e) the seg-only scale-1 program (no map export, no CAM chain)
    gives the logits of the CAM program and all-zero labels."""
    tcfg, tfrozen, tparams = models[1], models[4], models[5]
    tev = eval_runs["tev"]
    (tsb1, _, tsizes, _, tpres, tidx, tact), t1 = eval_runs["torch"][:2]
    run = trunner.make_eval_scale1(tcfg, tprec.FP32, with_cam=False, prep=tev.prep)
    seg_u, seg_avg, labels = run(tparams, tfrozen, tsb1, tpres, tsizes, tidx, tact)
    np.testing.assert_array_equal(seg_u.numpy(), t1[0].numpy())
    np.testing.assert_array_equal(seg_avg.numpy(), t1[1].numpy())
    assert not labels.any()


def test_pipeline_matches_engine_and_defaults_to_cuda(models, eval_runs):
    """The API crops the engine's canvas outputs per image; without an
    explicit device it asks for the card (and fails on a CPU-only host)."""
    tcfg, tfrozen, tparams = models[1], models[4], models[5]
    pipe = WeCLIPPipeline(tcfg, precision_name="float32", device="cpu",
                          weights={"params": tparams, "frozen": tfrozen})
    examples = _examples(models[0])
    ims = [ex["img_raw"] for ex in examples]
    labels = pipe.pseudo_label_batch(ims, class_ids=[list(p) for p in PRESENT])
    cam_labels = eval_runs["torch"][1][2].numpy()
    for i, (oh, ow) in enumerate(SIZES):
        np.testing.assert_array_equal(labels[i], cam_labels[i, :oh, :ow])
    seg = pipe.segment(ims[0])
    logits = eval_runs["torch"][3].numpy()
    np.testing.assert_array_equal(seg, logits[0].argmax(0)[:40, :56])
    assert seg.dtype == np.int32 and labels[0].dtype == np.int32
    with pytest.raises(FileNotFoundError):
        WeCLIPPipeline(tcfg, device="cpu", model_path="no-such-checkpoint-dir")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            WeCLIPPipeline(tcfg)
