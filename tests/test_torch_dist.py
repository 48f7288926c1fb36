"""Data parallelism over torch.distributed (weclip_tpu_torch/parallel/mesh.py)
on the CPU: two gloo ranks, each a process started by
``torch.multiprocessing.spawn`` with a ``file://`` rendezvous in
``tmp_path``, against one process, at a tiny size (width 64, 4 layers,
fp32).  The children import only torch and the port (this module imports
no JAX) and run on one thread each; one spawn a scenario.

1. the train step with the global batch split 2 + 2 against one process at
   4: losses within 1e-6, first-step gradients within 1e-5 of each leaf's
   largest, and the mesh's collectives;
2. ``train()`` over 4 steps: checkpoints from rank 0 only, validation
   through the histogram all-reduce, and a resume equal bit for bit to the
   uninterrupted run;
3. ``Evaluator.run`` over 5 images (a ragged shard), without and with the
   native CRF: int64 histograms equal to one process, the same scores on
   every rank;
4. ``--mesh 2`` in one process, and a model width of 2, raise the
   ValueError that names torchrun.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tests import torch_support  # noqa: F401
from weclip_tpu_torch.core import config as tconfig
from weclip_tpu_torch.core import precision as tprec
from weclip_tpu_torch.models import weclip as tweclip
from weclip_tpu_torch.parallel import mesh as meshlib
from weclip_tpu_torch.train import step as tstep

WORLD = 2
LOSS_TOL = 1e-6
GRAD_TOL = 1e-5


def _cfg(work_dir="unused"):
    """A tiny fp32 config: 6 classes, crop 64, 2 crops a rank."""
    c = tconfig.Config()
    return dataclasses.replace(
        c,
        dataset=dataclasses.replace(c.dataset, crop_size=64, num_classes=6),
        clip=tconfig.ClipConfig(patch_size=16, vision_width=64, vision_layers=4,
                                vision_heads=2, embed_dim=32, context_length=16,
                                vocab_size=128, transformer_width=32, transformer_heads=2,
                                transformer_layers=2),
        par=tconfig.ParConfig(dilations=(1, 2), num_iter=4),
        precision=dataclasses.replace(c.precision, compute_dtype="float32"),
        optimizer=dataclasses.replace(c.optimizer, learning_rate=1e-5, warmup_iter=0),
        train=dataclasses.replace(c.train, samples_per_gpu=2, eval_iters=2, log_iters=1,
                                  ckpt_start_iter=1, seg_trans_start_iter=2,
                                  max_iters=4),
        eval=dataclasses.replace(c.eval, batch_images=2, resize_long=96),
        work_dir=dataclasses.replace(c.work_dir, dir=str(work_dir)))


def _train_data(n=16, seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        present = np.zeros(5, bool)
        present[[i % 5, (i * 3 + 1) % 5]] = True
        out.append({"img": rng.standard_normal((3, 64, 64)).astype(np.float32),
                    "present_mask": present})
    return out


def _val_data(n=5, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        oh, ow = 48 - 4 * i, 64 - 6 * i
        label = rng.integers(0, 4, (oh, ow)).astype(np.int32)
        label[: oh // 5] = 255
        present = np.zeros(5, bool)
        present[[i % 3, 3]] = True
        out.append({"name": f"v{i}", "img_raw": rng.integers(0, 256, (oh, ow, 3)).astype(np.uint8),
                    "label": label, "present_mask": present})
    return out


def _spawn(fn, tmp_path, *args):
    """Run ``fn(rank, init_file, out_dir, *args)`` on two gloo ranks."""
    mp.spawn(_child, args=(fn, str(tmp_path / "rendezvous"), str(tmp_path), *args),
             nprocs=WORLD, join=True)


def _child(rank, fn, init_file, out_dir, *args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=WORLD)
    try:
        fn(rank, out_dir, *args)
    finally:
        dist.destroy_process_group()


# -- scenario 1: the train step ---------------------------------------------

def _run_steps(mesh, rows, steps=3):
    """``steps`` train steps on ``rows`` of the global batch of 4; returns
    (losses, metrics, first-step gradients)."""
    cfg = _cfg()
    frozen = tweclip.random_frozen_state(cfg, seed=0)
    from weclip_tpu_torch.data.loader import collate
    from weclip_tpu_torch.train.trainer import make_batcher
    data = _train_data()
    state = tstep.create_train_state(torch.Generator().manual_seed(1), cfg, "cpu")
    step_fn = tstep.make_train_step(cfg, tprec.FP32, mesh)
    to_device = make_batcher(cfg, frozen, "cpu", mesh)
    losses, metrics, grads = [], [], None
    for s in range(steps):
        batch = collate([data[4 * s + i] for i in rows])
        b, ci, ca = to_device(batch)
        state, m = step_fn(state, frozen, b, rng=5, cls_idx=ci, cls_active=ca)
        losses.append(float(m.loss))
        metrics.append([float(x) for x in m])
        if grads is None:
            grads = [t.grad.clone() for t in tstep.param_leaves(state.params)]
    return losses, metrics, grads


def _step_child(rank, out_dir):
    mesh = meshlib.make_mesh()
    assert (mesh.data, mesh.rank) == (WORLD, rank) and meshlib.dp_only(mesh)
    x = torch.tensor([rank + 1.0, 10.0 * rank])
    assert torch.equal(meshlib.psum(x), torch.tensor([3.0, 10.0]))
    assert torch.equal(meshlib.pmax(x), torch.tensor([2.0, 10.0]))
    assert torch.equal(meshlib.pmean(x), torch.tensor([1.5, 5.0]))
    assert torch.equal(meshlib.all_gather(x[None]), torch.tensor([[1.0, 0.0], [2.0, 10.0]]))
    assert meshlib.local_batch_size(mesh, 4) == 2
    losses, metrics, grads = _run_steps(mesh, rows=[2 * rank, 2 * rank + 1])
    torch.save({"losses": losses, "metrics": metrics, "grads": grads},
               os.path.join(out_dir, f"step_rank{rank}.pt"))


def test_train_step_two_ranks_match_one_process(tmp_path):
    _spawn(_step_child, tmp_path)
    losses, metrics, grads = _run_steps(None, rows=[0, 1, 2, 3])
    for rank in range(WORLD):
        got = torch.load(tmp_path / f"step_rank{rank}.pt")
        np.testing.assert_allclose(got["losses"], losses, rtol=0, atol=LOSS_TOL)
        np.testing.assert_allclose(got["metrics"], metrics, rtol=0, atol=LOSS_TOL)
        for g, w in zip(got["grads"], grads):
            tol = GRAD_TOL * max(float(w.abs().max()), 1e-30)
            assert float((g - w).abs().max()) <= tol


# -- scenario 2: train() with checkpoints and resume --------------------------

def _trainer_child(rank, out_dir):
    import logging
    from weclip_tpu_torch.train import trainer
    cfg = lambda d: _cfg(os.path.join(out_dir, d))
    frozen = tweclip.random_frozen_state(cfg("x"), seed=0)
    data, val = _train_data(), _val_data(3)
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logging.getLogger("weclip_tpu_torch").addHandler(handler)
    logging.getLogger("weclip_tpu_torch").setLevel(logging.INFO)
    full = trainer.train(cfg("full"), data, max_steps=4, device="cpu", frozen=frozen,
                         val_dataset=val)
    trainer.train(cfg("part"), data, max_steps=2, device="cpu", frozen=frozen,
                  val_dataset=val)
    resumed = trainer.train(cfg("part"), data, max_steps=4, device="cpu", frozen=frozen,
                            val_dataset=val, resume=True)
    torch.save({"full": [t.detach() for t in tstep.param_leaves(full.params)],
                "resumed": [t.detach() for t in tstep.param_leaves(resumed.params)],
                "steps": (full.step, resumed.step),
                "val_logs": sum("val seg" in m for m in records)},
               os.path.join(out_dir, f"train_rank{rank}.pt"))


def test_train_two_ranks_checkpoints_and_resume(tmp_path):
    _spawn(_trainer_child, tmp_path)
    got = [torch.load(tmp_path / f"train_rank{r}.pt") for r in range(WORLD)]
    for g in got:
        assert g["steps"] == (4, 4)
        for a, b in zip(g["full"], g["resumed"]):
            assert torch.equal(a, b)
    for a, b in zip(got[0]["full"], got[1]["full"]):      # the ranks agree
        assert torch.equal(a, b)
    # rank 0 alone logs and writes: 2 + 1 + 1 validations, one scalar record a step
    assert [g["val_logs"] for g in got] == [4, 0]
    ckpt = tmp_path / "full" / _cfg().work_dir.ckpt_dir
    assert sorted(os.listdir(ckpt)) == ["step_00000002", "step_00000004"]
    recs = (tmp_path / "full" / _cfg().work_dir.tb_logger_dir / "scalars.jsonl").read_text()
    assert len(recs.splitlines()) == 4


# -- scenario 3: Evaluator.run ------------------------------------------------

def _evaluate(crf: bool):
    from weclip_tpu_torch.evalx.runner import Evaluator, make_prep
    cfg = _cfg()
    frozen = tweclip.random_frozen_state(cfg, seed=0)
    params = tweclip.init_trainable_params(torch.Generator().manual_seed(1), cfg)
    pe = frozen["visual"]["positional_embedding"].numpy()
    ev = Evaluator(cfg, make_prep(cfg, 64, 96), pe, policy=tprec.FP32, device="cpu")
    return ev.run(params, frozen, _val_data(), crf=crf, return_hists=True)


def _eval_child(rank, out_dir):
    torch.save({crf: _evaluate(crf) for crf in (False, True)},
               os.path.join(out_dir, f"eval_rank{rank}.pt"))


def test_evaluator_two_ranks_match_one_process(tmp_path):
    _spawn(_eval_child, tmp_path)
    for crf in (False, True):
        want = _evaluate(crf)
        keys = ["seg", "msc_seg", "cam"] + (["crf_seg"] if crf else [])
        assert sorted(want["hists"]) == sorted(keys)
        for rank in range(WORLD):
            got = torch.load(tmp_path / f"eval_rank{rank}.pt", weights_only=False)[crf]
            for key in keys:
                assert got["hists"][key].dtype == np.int64
                np.testing.assert_array_equal(got["hists"][key], want["hists"][key])
                assert got[key]["miou"] == want[key]["miou"]


# -- scenario 4: --mesh N in one process --------------------------------------

@pytest.mark.parametrize("mesh", ["2", "8"])
def test_mesh_above_one_needs_torchrun(mesh):
    from weclip_tpu_torch.cli import eval_voc
    with pytest.raises(ValueError, match=f"torchrun --nproc_per_node {mesh}"):
        eval_voc.main(["--mesh", mesh, "--device", "cpu"])
    with pytest.raises(ValueError, match="torchrun"):
        meshlib.make_mesh(int(mesh))
    # a model width of 2 builds a mesh of 2 processes (test_torch_tensor_parallel.py);
    # one process is too few
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        meshlib.make_mesh(1, model_parallel=2)
    assert meshlib.make_mesh(-1) == meshlib.Mesh(data=1, rank=0)
    assert meshlib.local_device("cuda") == "cuda"
