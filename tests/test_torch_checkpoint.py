"""The port's checkpoints (weclip_tpu_torch/train/checkpoint.py), resume
and WeCLIPPipeline(model_path=...) on the CPU at a tiny size: a round trip
of params, optimizer and scheduler state; a resumed training run equal bit
for bit to an uninterrupted one; the JAX package's Orbax checkpoints read
into the port's layout."""

import dataclasses
import logging
import os

import numpy as np
import pytest
import torch

import jax

from tests import tiny
from weclip_tpu.models import weclip as jweclip
from weclip_tpu.train import checkpoint as jcheckpoint
from weclip_tpu_torch import convert
from weclip_tpu_torch.api import WeCLIPPipeline
from weclip_tpu_torch.core import config as tconfig
from weclip_tpu_torch.models import weclip as tweclip
from weclip_tpu_torch.train import checkpoint
from weclip_tpu_torch.train import step as tstep
from weclip_tpu_torch.train import trainer as ttrainer


def _cfg(work_dir):
    """The tiny config, fp32, two crops a step, checkpoints and validation
    every 2 steps past step 1, into ``work_dir``."""
    cfg = tiny.tiny_config(num_classes=6)
    cfg = dataclasses.replace(cfg, clip=tiny.tiny_clip_config(layers=4))
    t = tconfig.from_dict(dataclasses.asdict(cfg))
    return dataclasses.replace(
        t, precision=dataclasses.replace(t.precision, compute_dtype="float32"),
        train=dataclasses.replace(t.train, samples_per_gpu=2, eval_iters=2, log_iters=2,
                                  ckpt_start_iter=1, seg_trans_start_iter=3),
        eval=dataclasses.replace(t.eval, batch_images=2),
        work_dir=dataclasses.replace(t.work_dir, dir=str(work_dir)))


def _train_data(n=5, seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        present = np.zeros(5, bool)
        present[[i % 5, 4]] = True
        out.append({"img": rng.standard_normal((3, 64, 64)).astype(np.float32),
                    "present_mask": present})
    return out


def _val_data(n=2, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        oh, ow = 48 - 8 * i, 64
        label = rng.integers(0, 3, (oh, ow)).astype(np.int32)
        present = np.zeros(5, bool)
        present[[0, 1]] = True
        out.append({"img_raw": rng.integers(0, 256, (oh, ow, 3)).astype(np.uint8),
                    "label": label, "present_mask": present})
    return out


@pytest.fixture(scope="module")
def frozen():
    return tweclip.random_frozen_state(_cfg("unused"), seed=0)


def test_save_restore_round_trip(tmp_path, frozen):
    """params, optimizer and scheduler state and the step come back equal;
    ``latest_step`` finds the newest step; a ``step_N`` directory restores
    that step; a missing base directory raises."""
    cfg = _cfg(tmp_path)
    state = tstep.create_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    for p in tstep.param_leaves(state.params):
        p.grad = torch.ones_like(p)
    state.optimizer.step()
    state.scheduler.step()
    base = str(tmp_path / "ck")
    assert checkpoint.latest_step(base) is None
    first = checkpoint.save(base, 100, state.params)
    path = checkpoint.save(base, 250, state.params, state.optimizer, state.scheduler)
    assert os.path.basename(path) == "step_00000250"
    assert checkpoint.latest_step(base) == 250
    params, saved, step = checkpoint.restore(base)
    assert step == 250
    for a, b in zip(tstep.param_leaves(params), tstep.param_leaves(state.params)):
        assert not a.requires_grad and torch.equal(a, b.detach())
    fresh = tstep.create_train_state(None, cfg, "cpu", params=params)
    fresh.optimizer.load_state_dict(saved["optimizer"])
    fresh.scheduler.load_state_dict(saved["scheduler"])
    assert fresh.scheduler.last_epoch == 1
    assert fresh.optimizer.param_groups[0]["lr"] == state.optimizer.param_groups[0]["lr"]
    for a, b in zip(tstep.param_leaves(fresh.params), tstep.param_leaves(state.params)):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(fresh.optimizer.state[a][key], state.optimizer.state[b][key])
    _, saved, step = checkpoint.restore(first)
    assert step == 100 and saved is None
    assert checkpoint.restore(base, step=100)[2] == 100
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"))


def test_resume_is_exact(tmp_path, frozen, caplog):
    """Four uninterrupted training steps (checkpoints and validation at
    steps 2 and 4) equal two steps, then a resumed run of two more, bit for
    bit: params, optimizer moments and the step."""
    data, val = _train_data(), _val_data()
    full_cfg, part_cfg = _cfg(tmp_path / "full"), _cfg(tmp_path / "part")
    with caplog.at_level(logging.INFO, logger="weclip_tpu_torch"):
        full = ttrainer.train(full_cfg, data, max_steps=4, device="cpu", frozen=frozen,
                              val_dataset=val)
    assert sum("val seg" in r.getMessage() for r in caplog.records) == 2
    ckpt_dir = os.path.join(str(tmp_path / "full"), full_cfg.work_dir.ckpt_dir)
    assert sorted(os.listdir(ckpt_dir)) == ["step_00000002", "step_00000004"]
    ttrainer.train(part_cfg, data, max_steps=2, device="cpu", frozen=frozen,
                   val_dataset=val)
    resumed = ttrainer.train(part_cfg, data, max_steps=4, device="cpu", frozen=frozen,
                             val_dataset=val, resume=True)
    assert resumed.step == full.step == 4
    for a, b in zip(tstep.param_leaves(resumed.params), tstep.param_leaves(full.params)):
        assert torch.equal(a, b)
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(resumed.optimizer.state[a][key], full.optimizer.state[b][key])
    p4 = checkpoint.restore(os.path.join(str(tmp_path / "part"), part_cfg.work_dir.ckpt_dir))
    assert p4[2] == 4


def test_orbax_checkpoint_restores_as_converted_params(tmp_path):
    """A checkpoint of the JAX package (Orbax, with optimizer state) reads
    back as ``convert.params_from_jax`` of its params; params only."""
    cfg = tiny.tiny_config(num_classes=6)
    params = jweclip.init_trainable_params(jax.random.PRNGKey(4), cfg)
    path = jcheckpoint.save(str(tmp_path / "orbax"), 7, params,
                            opt_state={"mu": params})
    want = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for where in (str(tmp_path / "orbax"), path):
        got, saved, step = checkpoint.restore(where)
        assert step == 7 and saved is None
        leaves = tstep.param_leaves(got)
        assert len(leaves) == len(tstep.param_leaves(want))
        for a, b in zip(leaves, tstep.param_leaves(want)):
            assert torch.equal(a, b)


def test_pipeline_loads_model_path(tmp_path, frozen):
    """WeCLIPPipeline(model_path=...) segments as a pipeline given the same
    parameters through ``weights``, from the port's checkpoint and from an
    Orbax one."""
    cfg = _cfg(tmp_path)
    cfg = dataclasses.replace(cfg, eval=dataclasses.replace(cfg.eval, resize_long=64))
    state = tstep.create_train_state(torch.Generator().manual_seed(5), cfg, "cpu")
    path = checkpoint.save(str(tmp_path / "ck"), 3, state.params, state.optimizer,
                           state.scheduler)
    im = np.random.default_rng(0).integers(0, 256, (40, 52, 3)).astype(np.uint8)
    ref = WeCLIPPipeline(cfg, precision_name="float32", device="cpu",
                         weights={"params": state.params, "frozen": frozen}).segment(im)
    for where in (path, str(tmp_path / "ck")):
        pipe = WeCLIPPipeline(cfg, model_path=where, precision_name="float32",
                              device="cpu", weights={"params": state.params,
                                                     "frozen": frozen})
        np.testing.assert_array_equal(pipe.segment(im), ref)
    jcfg = dataclasses.replace(tiny.tiny_config(), clip=tiny.tiny_clip_config(layers=4))
    jparams = jweclip.init_trainable_params(jax.random.PRNGKey(4), jcfg)
    jpath = jcheckpoint.save(str(tmp_path / "orbax"), 9, jparams)
    tparams = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    ref = WeCLIPPipeline(cfg, precision_name="float32", device="cpu",
                         weights={"params": tparams, "frozen": frozen}).segment(im)
    got = WeCLIPPipeline(cfg, model_path=jpath, precision_name="float32", device="cpu",
                         weights={"params": state.params, "frozen": frozen}).segment(im)
    np.testing.assert_array_equal(got, ref)
