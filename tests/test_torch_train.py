"""The port's training side (weclip_tpu_torch/train/*, models/weclip.py's
training forward, the config copy) against the JAX package at a tiny size
(width 64, 2 heads, 4 layers, decoder and CoMer width 32, PAR dilations
(1, 2) with 4 iterations), the same weights (carried by convert.py, the
CoMer gates opened) on the same numpy-seeded inputs under the fp32 policy.

Tolerances: 1e-5 for the losses on given inputs, 1e-6 relative for three
AdamW updates against optax, 1e-4 for the forward (seg logits, the learned
affinity, refined CAMs) and the per-step losses, 5e-4 for gradients and
for parameters after three steps, 1e-3 relative (L2, per leaf) for the
update of three steps, exact equality for pseudo labels."""

import dataclasses
import logging

import numpy as np
import pytest
import torch
# torch.optim imports torch._dynamo at the first optimizer it builds, and
# that import looks up the specs of optional packages such as sklearn; a
# module stub without a spec that another test file leaves in sys.modules
# (tests/test_utils_extra.py) then makes it raise.  Importing it here, when
# the test files are collected, keeps every later optimizer clear of that.
import torch._dynamo  # noqa: F401

import jax
import jax.numpy as jnp

from tests import tiny
from tests import torch_support  # noqa: F401
from tests.test_torch_comer import open_gates
from weclip_tpu.core import config as jconfig
from weclip_tpu.core import precision as jprec
from weclip_tpu.models import weclip as jweclip
from weclip_tpu.ops.resize import resize_bilinear as jresize
from weclip_tpu.train import losses as jlosses
from weclip_tpu.train import optimizer as joptim
from weclip_tpu.train import seg_step as jseg
from weclip_tpu.train import step as jstep
from weclip_tpu.train import trainer as jtrainer
from weclip_tpu_torch import convert
from weclip_tpu_torch.core import config as tconfig
from weclip_tpu_torch.core import precision as tprec
from weclip_tpu_torch.models import weclip as tweclip
from weclip_tpu_torch.train import losses as tlosses
from weclip_tpu_torch.train import optimizer as toptim
from weclip_tpu_torch.train import seg_step as tseg
from weclip_tpu_torch.train import step as tstep
from weclip_tpu_torch.train import trainer as ttrainer

LOSS_TOL = 1e-5
FWD_TOL = 1e-4
GRAD_TOL = 5e-4
UPDATE_TOL = 1e-3


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def setup():
    """(jax cfg, port cfg, jax frozen, jax params, jax batch, port frozen,
    port params, port batch)."""
    cfg = tiny.tiny_config(num_classes=6)
    cfg = dataclasses.replace(
        cfg, clip=dataclasses.replace(tiny.tiny_clip_config(layers=4), embedding_dim=32),
        comer=jconfig.ComerConfig(enabled=True, stem_width=8, pyramid_dims=(16, 16, 16),
                                  mrfp_dilations=(1, 2), cti_heads=2,
                                  interaction_indexes=(1, 2)),
        optimizer=dataclasses.replace(cfg.optimizer, learning_rate=5e-5, warmup_iter=0),
        train=dataclasses.replace(cfg.train, max_iters=3))
    tcfg = tconfig.from_dict(dataclasses.asdict(cfg))
    frozen, clip_params = tiny.tiny_frozen(cfg)
    params = jweclip.init_trainable_params(jax.random.PRNGKey(1), cfg)
    params = dict(_np(params), comer=open_gates(params["comer"], 3))
    batch = tiny.tiny_batch(cfg, clip_params, batch=2)
    tbatch = tweclip.Batch(*(torch.from_numpy(np.array(x)) for x in batch))
    return (cfg, tcfg, frozen, params, batch, convert.frozen_from_jax(_np(frozen)),
            convert.params_from_jax(params), tbatch)


def test_config_matches_jax():
    """(6) the port's config reads configs/voc_comer.yaml into the JAX
    package's fields, the ``mesh`` section included."""
    ref = dataclasses.asdict(jconfig.load_config("configs/voc_comer.yaml"))
    got = dataclasses.asdict(tconfig.load_config("configs/voc_comer.yaml"))
    assert got == ref
    assert got["mesh"] == {"data_axis": "data", "model_axis": "model",
                           "data_parallel": -1, "model_parallel": 1}
    assert got["comer"]["enabled"] and got["comer"]["interaction_indexes"] == (2, 5, 8, 10)


def test_losses_match_jax():
    """(4) seg_loss (with an all-ignored batch), cams_to_affinity_label and
    aff_loss against the JAX functions on the same inputs."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 6, 32, 32)).astype(np.float32)
    label = rng.integers(0, 6, (2, 32, 32)).astype(np.int32)
    label[0, :8] = 255
    label[1, :, :5] = 0
    for lab in (label, np.full_like(label, 255)):
        ref = jlosses.seg_loss(jnp.asarray(logits), jnp.asarray(lab))
        got = tlosses.seg_loss(torch.from_numpy(logits), torch.from_numpy(lab).long())
        np.testing.assert_allclose(float(got), float(ref), rtol=LOSS_TOL, atol=LOSS_TOL)
    assert float(got) == 0.0

    rmask = tlosses.radius_mask(4, 4, 1)
    np.testing.assert_array_equal(rmask, jlosses.radius_mask(4, 4, 1))
    cam = rng.integers(0, 3, (2, 64, 64)).astype(np.int32)
    cam[0, 16:32, 0:16] = 255
    ref = jlosses.cams_to_affinity_label(jnp.asarray(cam), jnp.asarray(rmask))
    got = tlosses.cams_to_affinity_label(torch.from_numpy(cam).long(),
                                         torch.from_numpy(rmask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got == 255).any() and (got == 1).any() and (got == 0).any()
    pred = rng.uniform(0, 1, got.shape).astype(np.float32)
    for a, r in zip(tlosses.aff_loss(torch.from_numpy(pred), got),
                    jlosses.aff_loss(jnp.asarray(pred), ref)):
        np.testing.assert_allclose(float(a), float(r), rtol=LOSS_TOL)


def test_adamw_matches_optax():
    """(4) three poly-warmup AdamW updates against optax on the same
    gradients: warmup at step 0, poly at 1, and step 2 past max_iters (the
    schedule holds its last value)."""
    ocfg = jconfig.OptimizerConfig(learning_rate=1e-3, warmup_iter=1, weight_decay=0.05)
    tcfg = tconfig.OptimizerConfig(**dataclasses.asdict(ocfg))
    rng = np.random.default_rng(1)
    p0 = {"a": rng.standard_normal((5, 7)).astype(np.float32),
          "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    tx = joptim.make_optimizer(ocfg, max_iters=2)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(jp)
    tp = [torch.from_numpy(p0[k].copy()).requires_grad_(True) for k in ("a", "b")]
    opt, sched = toptim.make_optimizer(tp, tcfg, max_iters=2)
    mult = toptim.poly_warmup_multiplier(tcfg, 2)
    assert [mult(t) for t in range(4)] == pytest.approx([1e-6, 0.5, 0.5, 0.5])
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, upd)
        for t, k in zip(tp, ("a", "b")):
            t.grad = torch.from_numpy(g[k])
        opt.step()
        sched.step()
        for t, k in zip(tp, ("a", "b")):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
    assert not np.allclose(tp[0].detach().numpy(), p0["a"], atol=1e-4)


def test_forward_train_matches_jax(setup):
    """(5) forward_train with CoMer, dropout off, fp32: seg logits and the
    learned affinity within 1e-4, pseudo labels exactly, before the
    seg-trans iteration (plain fusion) and after it (gated by the learned
    affinity)."""
    cfg, tcfg, frozen, params, batch, tfrozen, tparams, tbatch = setup

    @jax.jit
    def jfwd(p):
        feats, head_out, attn, _ = jweclip.backbone_and_heads(p, frozen, batch, cfg,
                                                              None, jprec.FP32)
        return head_out.seg, attn, [jweclip.pseudo_labels(
            frozen, feats, attn, batch, cfg, jnp.bool_(gate), (64, 64), jprec.FP32)
            for gate in (False, True)]

    seg, attn, labels = jfwd(jax.tree_util.tree_map(jnp.asarray, params))
    got = tweclip.forward_train(tparams, tfrozen, tbatch, tcfg, False, None, tprec.FP32)
    for name, ref in (("seg", seg), ("attn_pred", attn), ("cams_refined", labels[0][1])):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(), np.asarray(ref),
                                   rtol=FWD_TOL, atol=FWD_TOL, err_msg=name)
    np.testing.assert_array_equal(got.cam_labels.numpy(), np.asarray(labels[0][0]))
    assert len(np.unique(got.cam_labels.numpy())) > 1

    feats, _, attn_t, _ = tweclip.backbone_and_heads(tparams, tfrozen, tbatch, tcfg,
                                                     tprec.FP32)
    tl, tr = tweclip.pseudo_labels(tfrozen, feats, attn_t.detach(), tbatch, tcfg, True,
                                   (64, 64), tprec.FP32)
    np.testing.assert_allclose(tr.numpy(), np.asarray(labels[1][1]), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(labels[1][0]))


def _jax_loss(cfg, frozen, batch):
    """The JAX step's loss (weclip_tpu/train/step.py::loss_fn), dropout off."""
    g = cfg.dataset.crop_size // cfg.clip.patch_size
    rmask = jnp.asarray(jlosses.radius_mask(g, g, cfg.train.radius))

    def loss(p):
        out = jweclip.forward_train(p, frozen, batch, cfg, jnp.bool_(False), None,
                                    jprec.FP32)
        seg = out.seg.reshape(batch.img.shape[0], g, g, -1).transpose(0, 3, 1, 2)
        seg_hw = jresize(seg, cfg.dataset.crop_size, cfg.dataset.crop_size)
        pseudo = jax.lax.stop_gradient(out.cam_labels)
        aff_label = jlosses.cams_to_affinity_label(pseudo, rmask)
        return (jlosses.seg_loss(seg_hw, pseudo)
                + cfg.train.attn_loss_weight * jlosses.aff_loss(out.attn_pred, aff_label)[0])
    return loss


def test_loss_gradients_match_jax(setup):
    """(5) the gradient of the training loss with respect to every head
    and CoMer leaf, gates open, against jax.grad."""
    cfg, tcfg, frozen, params, batch, tfrozen, tparams, tbatch = setup
    ref_loss, ref = jax.jit(jax.value_and_grad(_jax_loss(cfg, frozen, batch)))(
        jax.tree_util.tree_map(jnp.asarray, params))
    state = tstep.create_train_state(None, tcfg, "cpu", params=tparams)
    loss, _ = tstep.make_loss_fn(tcfg, tprec.FP32)(state.params, tfrozen, tbatch,
                                                   False, None, None, None)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=FWD_TOL, atol=FWD_TOL)
    ref_t = convert.params_from_jax(_np(ref))
    got = tstep.param_leaves(state.params)
    want = tstep.param_leaves(ref_t)
    assert len(got) == len(want)
    for t, r in zip(got, want):
        np.testing.assert_allclose(t.grad.numpy(), r.numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
    assert all(float(t.grad.abs().max()) > 0 for t in tstep.param_leaves(state.params["comer"]))


def _named(tree, prefix=""):
    """(path, tensor) of a parameter tree, in ``step.param_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _named(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _named(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _not_key_bias(name, t):
    """Elements of a leaf that are not attention key biases.  The softmax
    cancels a key bias's gradient, so it is rounding in either package, and
    AdamW scales that rounding to a full step of either sign: every CTI
    ``k_b`` and the key third of the decoder's packed ``in_b``."""
    keep = torch.ones(t.shape, dtype=torch.bool)
    if name.startswith("/comer/cti/") and name.endswith("/k_b"):
        keep[...] = False
    if name == "/head/decoder/blocks/attn/in_b":
        d = t.shape[-1] // 3
        keep[..., d:2 * d] = False
    return keep


def test_train_steps_in_lockstep_with_jax(setup):
    """(5) three make_train_step steps against JAX's: each step's loss
    within 1e-4, the parameters after the third within 5e-4, and the
    update of the three steps (params after minus before, about 1e-3 per
    element at this learning rate) within 1e-3 relative of JAX's in each
    leaf, key biases aside."""
    cfg, tcfg, frozen, params, batch, tfrozen, tparams, tbatch = setup
    jstate, tx = jstep.create_train_state(jax.random.PRNGKey(0), cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jstep.TrainState(jp, tx.init(jp), jnp.zeros((), jnp.int32))
    jfn = jstep.make_train_step(cfg, tx, policy=jprec.FP32)
    state = tstep.create_train_state(None, tcfg, "cpu", params=tparams)
    tfn = tstep.make_train_step(tcfg, tprec.FP32)
    for _ in range(3):
        jstate, jm = jfn(jstate, frozen, batch, None)
        state, m = tfn(state, tfrozen, tbatch)
        for name in ("loss", "seg_loss", "attn_loss", "pseudo_acc"):
            np.testing.assert_allclose(float(getattr(m, name)),
                                       float(getattr(jm, name)),
                                       rtol=FWD_TOL, atol=FWD_TOL, err_msg=name)
    assert state.step == 3
    want = tstep.param_leaves(convert.params_from_jax(_np(jstate.params)))
    moved = 0
    for (name, t), r, p0 in zip(_named(state.params), want, tstep.param_leaves(tparams)):
        np.testing.assert_allclose(t.detach().numpy(), r.numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)
        keep = _not_key_bias(name, p0)
        if keep.any():
            upd, upd_jax = (t.detach() - p0).double()[keep], (r - p0).double()[keep]
            rel = float((upd - upd_jax).norm() / upd_jax.norm())
            assert rel <= UPDATE_TOL, (name, rel)
        moved += int(not torch.equal(t.detach(), p0))
    assert moved == len(want)


def test_step_trains_against_given_labels(setup):
    """make_train_step's ``pseudo`` takes the place of the forward's own
    labels: given those same labels the step is the same; given all-ignored
    labels the segmentation loss is 0."""
    _, tcfg, _, _, _, tfrozen, tparams, tbatch = setup
    fn = tstep.make_train_step(tcfg, tprec.FP32)
    with torch.no_grad():
        labels = tweclip.forward_train(tparams, tfrozen, tbatch, tcfg, False, None,
                                       tprec.FP32).cam_labels
    runs = []
    for pseudo in (None, labels, torch.full_like(labels, 255)):
        state = tstep.create_train_state(None, tcfg, "cpu", params=tparams)
        _, m = fn(state, tfrozen, tbatch, pseudo=pseudo)
        runs.append((m, tstep.param_leaves(state.params)))
    (own, p_own), (given, p_given), (ignored, _) = runs
    assert torch.equal(own.loss, given.loss) and torch.equal(own.pseudo_acc, given.pseudo_acc)
    assert all(torch.equal(a, b) for a, b in zip(p_own, p_given))
    assert float(ignored.seg_loss) == 0.0 and float(own.seg_loss) > 0.0


def test_trainer_runs_and_logs(setup, caplog, tmp_path):
    """The trainer: two steps on an in-memory dataset through the
    PrefetchLoader with dropout on, logged metrics, and the final
    checkpoint at the step reached."""
    cfg, tcfg, tfrozen = setup[0], setup[1], setup[5]
    rng = np.random.default_rng(2)
    data = []
    for i in range(3):
        present = np.zeros(5, bool)
        present[[i, 4]] = True
        data.append({"img": rng.standard_normal((3, 64, 64)).astype(np.float32),
                     "present_mask": present})
    tcfg = dataclasses.replace(
        tcfg, train=dataclasses.replace(tcfg.train, samples_per_gpu=2, log_iters=1),
        precision=dataclasses.replace(tcfg.precision, compute_dtype="float32"),
        work_dir=dataclasses.replace(tcfg.work_dir, dir=str(tmp_path)))
    with caplog.at_level(logging.INFO, logger="weclip_tpu_torch"):
        state = ttrainer.train(tcfg, data, max_steps=2, device="cpu", frozen=tfrozen)
    assert state.step == 2
    lines = [r.getMessage() for r in caplog.records if "seg_loss" in r.getMessage()]
    assert len(lines) == 2 and "iter 2/2" in lines[1]
    ckpt = tmp_path / tcfg.work_dir.ckpt_dir
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_00000002"]
    with pytest.raises(ValueError):     # a dataset smaller than one batch
        ttrainer.train(tcfg, data[:1], max_steps=1, device="cpu", frozen=tfrozen)


def _plain_cfg():
    """The tiny config without CoMer: (jax cfg, port cfg)."""
    cfg = dataclasses.replace(tiny.tiny_config(num_classes=6),
                              clip=tiny.tiny_clip_config(layers=4))
    cfg = dataclasses.replace(cfg, eval=dataclasses.replace(cfg.eval, batch_images=2))
    return cfg, tconfig.from_dict(dataclasses.asdict(cfg))


def test_validate_matches_jax():
    """trainer.validate (original size, single scale, CAM chain, canvas
    512) against the JAX package's on three labelled images: the seg and
    cam scores equal."""
    cfg, tcfg = _plain_cfg()
    frozen, clip_params = tiny.tiny_frozen(cfg)
    params = jweclip.init_trainable_params(jax.random.PRNGKey(1), cfg)
    rng = np.random.default_rng(7)
    val = []
    for oh, ow in ((48, 64), (64, 40), (33, 50)):
        present = np.zeros(5, bool)
        present[[1, 3]] = True
        val.append({"img_raw": rng.integers(0, 256, (oh, ow, 3)).astype(np.uint8),
                    "label": rng.choice([0, 2, 4, 255], (oh, ow)).astype(np.int32),
                    "present_mask": present})
    ref = jtrainer.validate(cfg, params, frozen, clip_params, val, jprec.FP32)
    got = ttrainer.validate(tcfg, convert.params_from_jax(_np(params)),
                            convert.frozen_from_jax(_np(frozen)), val, tprec.FP32,
                            device="cpu")
    assert set(got) == set(ref) == {"seg", "msc_seg", "cam"}
    for key in got:
        for s in ("pAcc", "mAcc", "miou"):
            np.testing.assert_allclose(got[key][s], ref[key][s], rtol=1e-12,
                                       err_msg=f"{key} {s}")
    assert got["cam"]["miou"] > 0


@pytest.mark.parametrize("warmup,max_iters", [(0, 5), (3, 10), (2, 6)])
def test_lr_schedules_match_jax(warmup, max_iters):
    """The learning rate at step t of both schedules, past the end too,
    against the JAX package's, within 1e-6 of the rate or 1e-6 of the base
    rate: JAX forms the warmup's 1 - (1 - t / W)(1 - ratio) in float32,
    1.013e-6 at t = 0 for the exact 1e-6."""
    ocfg = jconfig.OptimizerConfig(learning_rate=1e-3, warmup_iter=warmup, power=0.9)
    tcfg = tconfig.OptimizerConfig(**dataclasses.asdict(ocfg))
    for tfn, jfn in ((toptim.poly_warmup_schedule, joptim.poly_warmup_schedule),
                     (toptim.sgd_poly_warmup_schedule, joptim.sgd_poly_warmup_schedule)):
        if warmup == 0 and tfn is toptim.sgd_poly_warmup_schedule:
            continue          # SGD's warmup term divides by warmup_iter
        got, ref = tfn(tcfg, max_iters, 2e-4), jfn(ocfg, max_iters, 2e-4)
        for t in range(max_iters + 3):
            assert got(t) == pytest.approx(float(ref(jnp.asarray(t))), rel=1e-6,
                                           abs=1e-6 * 2e-4)


def test_sgd_matches_optax():
    """Three poly-warmup SGD updates against the JAX package's optax chain
    on the same gradients, across the warmup boundary (the multiplier falls
    from 10x during warmup, then decays over the remaining steps)."""
    ocfg = jconfig.OptimizerConfig(learning_rate=1e-3, warmup_iter=2, weight_decay=0.05,
                                   power=0.9)
    tcfg = tconfig.OptimizerConfig(**dataclasses.asdict(ocfg))
    mult = toptim.sgd_poly_warmup_multiplier(tcfg, 5)
    sched = joptim.sgd_poly_warmup_schedule(ocfg, 5, 1.0)
    for t in range(7):
        assert mult(t) == pytest.approx(float(sched(t)), rel=1e-6)
    assert mult(0) == 10.0 and mult(1) < mult(0) and mult(2) == 1.0
    rng = np.random.default_rng(3)
    p0 = {"a": rng.standard_normal((4, 6)).astype(np.float32),
          "b": rng.standard_normal(6).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    tx = joptim.make_sgd_optimizer(ocfg, max_iters=5)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(jp)
    tp = [torch.from_numpy(p0[k].copy()).requires_grad_(True) for k in ("a", "b")]
    opt, sch = toptim.make_sgd_optimizer(tp, tcfg, max_iters=5)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, upd)
        for t, k in zip(tp, ("a", "b")):
            t.grad = torch.from_numpy(g[k])
        opt.step()
        sch.step()
        for t, k in zip(tp, ("a", "b")):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)
    assert not np.allclose(tp[0].detach().numpy(), p0["a"], atol=1e-3)


def test_forward_train_without_pseudo_matches_jax(setup):
    """forward_train(with_pseudo=False): the seg logits and the learned
    affinity of JAX's at 1e-4, zero labels and refined CAMs of its shapes."""
    cfg, tcfg, frozen, params, batch, tfrozen, tparams, tbatch = setup
    ref = jax.jit(lambda p: jweclip.forward_train(
        p, frozen, batch, cfg, jnp.bool_(False), None, jprec.FP32, with_pseudo=False))(
        jax.tree_util.tree_map(jnp.asarray, params))
    got = tweclip.forward_train(tparams, tfrozen, tbatch, tcfg, False, None, tprec.FP32,
                                with_pseudo=False)
    for name in ("seg", "attn_pred"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(ref, name)), rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=name)
    for name in ("cam_labels", "cams_refined"):
        want = np.asarray(getattr(ref, name))
        assert tuple(getattr(got, name).shape) == want.shape and not want.any()
        assert not getattr(got, name).any()


def test_seg_step_in_lockstep_with_jax(monkeypatch):
    """Two fully supervised steps (make_seg_train_step, frozen CLIP -> fuse
    -> decoder) against JAX's on the same ground truth, dropout off in both,
    lr 5e-4 from the first step: each step's loss within 1e-5 and its
    accuracy equal; each leaf's two-step update within 1e-3 relative (L2)
    of JAX's, key biases aside, and the parameters within 5e-4.  (AdamW
    turns fp32 rounding in a gradient element near zero into a difference of
    up to about 1e-5 in its parameter, so no tighter absolute bound holds.)"""
    from weclip_tpu.models import heads as jheads
    fuse = jheads.fuse_forward
    monkeypatch.setattr(jheads, "fuse_forward",
                        lambda p, x, rng=None, **kw: fuse(p, x, None, **kw))
    cfg, _ = _plain_cfg()
    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, learning_rate=5e-5, warmup_iter=0))
    tcfg = tconfig.from_dict(dataclasses.asdict(cfg))
    frozen, clip_params = tiny.tiny_frozen(cfg)
    params = _np(jweclip.init_trainable_params(jax.random.PRNGKey(1), cfg))
    tfrozen, tparams = (convert.frozen_from_jax(_np(frozen)),
                        convert.params_from_jax(params))
    batch = tiny.tiny_batch(cfg, clip_params, batch=2)
    tbatch = tweclip.Batch(*(torch.from_numpy(np.array(x)) for x in batch))
    rng = np.random.default_rng(5)
    label = rng.integers(0, 6, (2, 64, 64)).astype(np.int32)
    label[0, :10] = 255
    jstate, tx = jseg.create_seg_train_state(jax.random.PRNGKey(0), cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jstep.TrainState(jp, tx.init(jp), jnp.zeros((), jnp.int32))
    jfn = jseg.make_seg_train_step(cfg, tx, jprec.FP32)
    state = tseg.create_seg_train_state(None, tcfg, "cpu", params=tparams)
    tfn = tseg.make_seg_train_step(tcfg, tprec.FP32)
    for _ in range(2):
        jstate, jm = jfn(jstate, frozen, batch, jnp.asarray(label), jax.random.PRNGKey(9))
        state, m = tfn(state, tfrozen, tbatch, torch.from_numpy(label))
        np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
        assert float(m.acc) == pytest.approx(float(jm.acc), abs=1e-6)
    assert state.step == 2
    want = tstep.param_leaves(convert.params_from_jax(_np(jstate.params)))
    for (name, t), r, p0 in zip(_named(state.params), want, tstep.param_leaves(tparams)):
        np.testing.assert_allclose(t.detach().numpy(), r.numpy(), rtol=0, atol=GRAD_TOL,
                                   err_msg=name)
        keep = _not_key_bias(name, p0)
        upd, upd_jax = (t.detach() - p0).double()[keep], (r - p0).double()[keep]
        assert float((upd - upd_jax).norm() / upd_jax.norm()) <= UPDATE_TOL, name
