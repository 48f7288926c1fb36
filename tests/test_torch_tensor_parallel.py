"""The tensor-parallel MLP split (weclip_tpu_torch/parallel/mesh.py, the
``"tp"`` path of models/clip/vit.py::mlp_forward) on the CPU.

One ``torch.multiprocessing.spawn`` of four gloo ranks, a (data 2, model 2)
mesh, at tests/tiny.py's sizes (width 64, 12 layers, crop 64, 6 classes)
with the JAX package's tiny frozen tree carried by convert.py.  Every rank
runs the same list of calls on its data slice, and the parent runs them in
one process on the whole batch:

- one fp32 train step, plain and with the tiny CoMer branch
  (tests/test_multichip.py's dims, its gates opened): the loss within rtol
  1e-5 and the parameters within rtol 5e-5 / atol 1e-7 (the JAX package's
  bounds for its 4 x 2 mesh);
- the ranks of each model group hold the same trainable gradients;
- GradCAM (``cam_single``) on the sharded tree within 1e-5;
- one bf16 step against the one-process (data parallel only) bf16 step at
  rtol 5e-3 / atol 5e-4 (JAX's bound: a partial rounded to bf16 before the
  sum);
- ``Evaluator.run``: int64 histograms equal.

Without a spawn: ``shard_model`` shards the leaves and dims that JAX's
``model_shardings`` does; ``mlp_forward`` over the shards, with the ranks
stacked on a leading axis and the all-reduce replaced by a sum over it,
equals the whole MLP, and so does its gradient with respect to the input;
``--mesh`` arithmetic.  The children import only torch and the port, so
this module imports JAX inside the tests that need it.
"""

import argparse
import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from weclip_tpu_torch.core import config as tconfig
from weclip_tpu_torch.core import precision as tprec
from weclip_tpu_torch.models.clip import vit as tvit
from weclip_tpu_torch.parallel import mesh as meshlib

DATA, MODEL = 2, 2
WORLD = DATA * MODEL
BATCH = 4                   # the global batch, 2 rows a data rank
BF16 = tprec.make_policy("bfloat16")


def _cfg(comer: bool = False):
    """tests/tiny.py's ``tiny_config`` in the port's config (and with
    ``comer`` tests/test_multichip.py's CoMer dims)."""
    c = tconfig.Config()
    c = dataclasses.replace(
        c,
        dataset=dataclasses.replace(c.dataset, crop_size=64, num_classes=6),
        clip=tconfig.ClipConfig(patch_size=16, vision_width=64, vision_layers=12,
                                vision_heads=2, embed_dim=32, context_length=16,
                                vocab_size=128, transformer_width=32, transformer_heads=2,
                                transformer_layers=2),
        par=tconfig.ParConfig(dilations=(1, 2), num_iter=4),
        eval=dataclasses.replace(c.eval, batch_images=2, resize_long=96))
    if comer:
        c = dataclasses.replace(c, comer=tconfig.ComerConfig(
            enabled=True, stem_width=8, pyramid_dims=(16, 16, 16), mrfp_dilations=(1, 2),
            cti_heads=2, interaction_indexes=(2, 5)))
    return c


def _leaves(tree, prefix=""):
    """{path: tensor} of a nested dict/list tree, the mesh left out."""
    if isinstance(tree, dict):
        return {k: v for n, t in tree.items() for k, v in _leaves(t, f"{prefix}/{n}").items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree) for k, v in _leaves(t, f"{prefix}/{i}").items()}
    return {} if isinstance(tree, meshlib.Mesh) else {prefix: tree}


# -- what every rank, and the parent in one process, computes -------------------

def _step(cfg, policy, mesh, frozen, params, host, rows):
    """One train step on ``rows`` of the global batch: (loss, parameters
    after the step, their gradients)."""
    from weclip_tpu_torch.train import step as tstep
    from weclip_tpu_torch.train.trainer import make_batcher
    state = tstep.create_train_state(None, cfg, "cpu", params=params)
    batch, ci, ca = make_batcher(cfg, frozen, "cpu", mesh)(
        {k: v[rows] for k, v in host.items()})
    state, m = tstep.make_train_step(cfg, policy, mesh)(
        state, frozen, batch, rng=7, cls_idx=ci, cls_active=ca)
    leaves = tstep.param_leaves(state.params)
    return {"loss": float(m.loss), "params": [t.detach().clone() for t in leaves],
            "grads": [t.grad.clone() for t in leaves]}


def _cams(cfg, frozen, host):
    """grad_cam of image 0 through ``cam_single`` (fp32): (C, P)."""
    from weclip_tpu_torch.cam import variants
    from weclip_tpu_torch.models.clip.vit import pos_emb_host, vision_forward_frozen
    g = cfg.dataset.crop_size // cfg.clip.patch_size
    pe = torch.from_numpy(pos_emb_host(
        frozen["visual"]["positional_embedding"].numpy(), g, g, g, g))[None]
    img = torch.from_numpy(host["img"][:1])
    valid = torch.ones((1, g * g + 1), dtype=torch.bool)
    x11 = vision_forward_frozen(frozen["visual"], img, pe, valid, cfg.clip,
                                policy=tprec.FP32).layer_tokens[-1]
    text = torch.cat([frozen["fg_text"], frozen["bg_text"]])
    tmask = torch.cat([torch.from_numpy(host["present_mask"][0]),
                       torch.ones(frozen["bg_text"].shape[0], dtype=torch.bool)])
    return variants.cam_single("grad_cam", frozen["visual"], frozen["logit_scale"], x11[0],
                               text, tmask, valid[0], torch.arange(5), cfg.clip, tprec.FP32)


def _evaluate(cfg, frozen, params, examples):
    from weclip_tpu_torch.evalx.runner import Evaluator, make_prep
    pe = frozen["visual"]["positional_embedding"].numpy()
    ev = Evaluator(cfg, make_prep(cfg, 64, 96), pe, policy=tprec.FP32, device="cpu")
    return ev.run(params, frozen, examples, return_hists=True)["hists"]


def _run(mesh, inp):
    """Every call of the scenario on ``mesh`` (None: one process, the whole
    batch)."""
    frozen = inp["frozen"] if mesh is None else meshlib.shard_model(mesh, inp["frozen"])
    rows = (slice(0, BATCH) if mesh is None
            else slice(mesh.data_rank * BATCH // DATA, (mesh.data_rank + 1) * BATCH // DATA))
    mlp = frozen["visual"]["blocks"]["mlp"]
    out = {"shapes": {k: tuple(t.shape) for k, t in mlp.items() if torch.is_tensor(t)}}
    for name, cfg, params, policy in (
            ("fp32", _cfg(), inp["params"], tprec.FP32),
            ("comer", _cfg(comer=True), inp["comer_params"], tprec.FP32),
            ("bf16", _cfg(), inp["params"], BF16)):
        out[name] = _step(cfg, policy, mesh, frozen, params, inp["host"], rows)
    out["cams"] = _cams(_cfg(), frozen, inp["host"])
    out["hists"] = _evaluate(_cfg(), frozen, inp["params"], inp["examples"])
    return out


def _child(rank, work):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous", rank=rank,
                            world_size=WORLD)
    try:
        mesh = meshlib.make_mesh(DATA, MODEL)
        assert (mesh.data_rank, mesh.model_rank) == divmod(rank, MODEL)
        inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
        torch.save(_run(mesh, inp), os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_frozen():
    """The JAX package's tiny frozen tree (tests/tiny.py), its leaves numpy."""
    import jax
    from tests import tiny
    frozen, _ = tiny.tiny_frozen(tiny.tiny_config())
    return jax.tree_util.tree_map(np.asarray, frozen)


def _inputs(jax_frozen):
    """``jax_frozen`` in the port, the port's trainable trees (the CoMer
    gates opened), a global batch and 5 labelled images, all seeded."""
    from weclip_tpu_torch import convert
    from weclip_tpu_torch.models import weclip as tweclip
    frozen = convert.frozen_from_jax(jax_frozen)
    params = tweclip.init_trainable_params(torch.Generator().manual_seed(1), _cfg())
    comer = tweclip.init_trainable_params(torch.Generator().manual_seed(2), _cfg(comer=True))
    gen = torch.Generator().manual_seed(3)
    for stage in comer["comer"]["cti"]:
        for d in ("inj", "ext"):
            stage[d]["o_w"] = torch.randn(stage[d]["o_w"].shape, generator=gen) * 0.2
    comer["comer"]["out_w"] = torch.randn(comer["comer"]["out_w"].shape, generator=gen) * 0.2
    rng = np.random.default_rng(4)
    present = np.zeros((BATCH, 5), bool)
    for i in range(BATCH):
        present[i, [i % 5, (i * 3 + 1) % 5]] = True
    host = {"img": rng.standard_normal((BATCH, 3, 64, 64)).astype(np.float32),
            "present_mask": present}
    examples = []
    for i in range(5):
        oh, ow = 48 - 4 * i, 64 - 6 * i
        label = rng.integers(0, 4, (oh, ow)).astype(np.int32)
        label[: oh // 5] = 255
        pm = np.zeros(5, bool)
        pm[[i % 3, 3]] = True
        examples.append({"name": f"v{i}", "label": label, "present_mask": pm,
                         "img_raw": rng.integers(0, 256, (oh, ow, 3)).astype(np.uint8)})
    return {"frozen": frozen, "params": params, "comer_params": comer, "host": host,
            "examples": examples}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_frozen):
    """(the four ranks' results, the one-process results)."""
    work = tmp_path_factory.mktemp("tp")
    inp = _inputs(jax_frozen)
    torch.save(inp, work / "inputs.pt")
    mp.spawn(_child, args=(str(work),), nprocs=WORLD, join=True)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    # one thread, as the children: at this size the default thread count
    # runs many times slower on a host that other test workers share
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return ranks, _run(None, inp)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["fp32", "comer"])
def test_tp_step_matches_one_process(runs, name):
    ranks, one = runs
    for got in ranks:
        np.testing.assert_allclose(got[name]["loss"], one[name]["loss"], rtol=1e-5)
        for a, b in zip(got[name]["params"], one[name]["params"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["fp32", "comer", "bf16"])
def test_tp_model_group_holds_equal_gradients(runs, name):
    """Replicated activations after the MLP sum give the ranks of a model
    group the same trainable gradients, unreduced."""
    ranks, _ = runs
    for d in range(DATA):
        a, b = (ranks[d * MODEL + m][name]["grads"] for m in range(MODEL))
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_tp_shards_are_half_of_the_mlp(runs):
    ranks, one = runs
    full = one["shapes"]
    half = {"fc_w": (12, 128, 64), "fc_b": (12, 128), "proj_w": (12, 64, 128),
            "proj_b": (12, 64)}
    assert {k: full[k] for k in half} == {"fc_w": (12, 256, 64), "fc_b": (12, 256),
                                          "proj_w": (12, 64, 256), "proj_b": (12, 64)}
    for got in ranks:
        assert got["shapes"] == half


def test_tp_gradcam_matches_one_process(runs):
    ranks, one = runs
    for got in ranks:
        np.testing.assert_allclose(got["cams"].numpy(), one["cams"].numpy(), rtol=0, atol=1e-5)


def test_tp_bf16_step_near_data_parallel_step(runs):
    ranks, one = runs
    for got in ranks:
        np.testing.assert_allclose(got["bf16"]["loss"], one["bf16"]["loss"], rtol=5e-3)
        for a, b in zip(got["bf16"]["params"], one["bf16"]["params"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-3, atol=5e-4)


def test_tp_evaluator_histograms_equal_one_process(runs):
    ranks, one = runs
    for got in ranks:
        assert sorted(got["hists"]) == sorted(one["hists"])
        for k, h in one["hists"].items():
            assert got["hists"][k].dtype == np.int64
            np.testing.assert_array_equal(got["hists"][k], h)


# -- without a spawn ------------------------------------------------------------

@pytest.mark.parametrize("model", [2, 3, 4])
def test_shard_model_matches_jax_model_shardings(jax_frozen, model):
    """The same leaves split along the same dims as JAX's
    ``model_shardings`` (a width that does not divide 256 leaves every leaf
    whole), each rank's slice its model coordinate's part."""
    import jax
    from weclip_tpu.parallel import mesh as jmesh
    from weclip_tpu_torch import convert
    specs = jmesh.model_shardings(jmesh.make_mesh(data_parallel=8 // model,
                                                  model_parallel=model), jax_frozen)
    want = {"/" + "/".join(str(k.key) for k in path): tuple(s.spec)
            for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]}
    frozen = convert.frozen_from_jax(jax_frozen)
    full = _leaves(frozen)
    assert sorted(full) == sorted(want)
    for r in range(model):
        mesh = meshlib.Mesh(data=1, rank=r, model=model, model_rank=r)
        sharded = meshlib.shard_model(mesh, frozen)
        got = _leaves(sharded)
        assert sorted(got) == sorted(full)
        split_any = False
        for path, t in got.items():
            dims = [d for d in range(t.ndim) if t.shape[d] != full[path].shape[d]]
            spec = list(want[path]) + [None] * (t.ndim - len(want[path]))
            assert dims == [d for d, a in enumerate(spec) if a == "model"], path
            for d in dims:
                n = t.shape[d]
                assert t.shape[d] * model == full[path].shape[d]
                assert torch.equal(t, full[path].narrow(d, r * n, n))
            split_any |= bool(dims)
        # the mesh rides beside the split leaves, and only there
        assert (meshlib.mesh_of(sharded) is mesh) == split_any == (256 % model == 0)


def _stacked_mlp(p, r):
    """``r`` ranks' shards of the MLP ``p`` (shard_model) stacked on a
    leading rank axis, broadcastable against a (r, B, L, D) input."""
    shards = [meshlib.shard_model(meshlib.Mesh(data=1, rank=i, model=r, model_rank=i),
                                  {"mlp": p})["mlp"] for i in range(r)]
    st = lambda k, lead: torch.stack([s[k] for s in shards]).reshape(r, *lead, *shards[0][k].shape)
    return {"fc_w": st("fc_w", (1,)), "fc_b": st("fc_b", (1, 1)),
            "proj_w": st("proj_w", (1,)), "proj_b": p["proj_b"],
            "tp": meshlib.Mesh(data=1, rank=0, model=r)}


def _mlp_case(seed=0, w=64):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    p = {"fc_w": t(4 * w, w) / 8, "fc_b": t(4 * w) / 4, "proj_w": t(w, 4 * w) / 16,
         "proj_b": t(w)}
    return p, t(2, 5, w)


def _sum_over_ranks(y, group):
    """The model group's all-reduce with the ranks on a leading axis."""
    return y.sum(0, keepdim=True).expand_as(y).clone()


@pytest.mark.parametrize("r", [2, 4])
def test_split_mlp_forward_sums_to_the_whole_mlp(monkeypatch, r):
    """Each rank's output of the split MLP (partials summed, ``proj_b``
    added once) is the whole MLP's, fp32."""
    monkeypatch.setattr(meshlib, "_sum_partials", _sum_over_ranks)
    p, x = _mlp_case()
    want = tvit.mlp_forward(p, x, tprec.FP32)
    got = tvit.mlp_forward(_stacked_mlp(p, r), x.expand(r, *x.shape), tprec.FP32)
    for i in range(r):
        np.testing.assert_allclose(got[i].numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_split_mlp_input_gradient_matches_autograd(monkeypatch):
    """Through "f" (the input's gradient summed over the ranks) and "g"
    (identity backward), every rank's gradient with respect to the input
    is the whole MLP's within 1e-6; without the sum of "f" each rank would
    hold only its shard's part."""
    monkeypatch.setattr(meshlib, "_sum_partials", _sum_over_ranks)
    p, x = _mlp_case(1)
    c = torch.from_numpy(np.random.default_rng(2).standard_normal(x.shape).astype(np.float32))
    xw = x.clone().requires_grad_(True)
    (tvit.mlp_forward(p, xw, tprec.FP32) * c).sum().backward()
    xs = x.expand(2, *x.shape).clone().requires_grad_(True)
    (tvit.mlp_forward(_stacked_mlp(p, 2), xs, tprec.FP32) * c).sum(dim=(1, 2, 3)).sum().backward()
    for i in range(2):
        np.testing.assert_allclose(xs.grad[i].numpy(), xw.grad.numpy(), rtol=0, atol=1e-6)
    # the shard's own part is far from the whole
    monkeypatch.setattr(meshlib._EnterModel, "backward", staticmethod(lambda ctx, g: (g, None)))
    xs.grad = None
    (tvit.mlp_forward(_stacked_mlp(p, 2), xs, tprec.FP32) * c).sum(dim=(1, 2, 3)).sum().backward()
    assert float((xs.grad[0] - xw.grad).abs().max()) > 1e-2


@pytest.mark.parametrize("total, model, data", [(4, 2, 2), (6, 3, 2), (8, 1, 8),
                                                 (-1, 2, -1), (0, 1, -1), (2, 2, 1)])
def test_build_eval_mesh_counts_ranks_in_all(monkeypatch, total, model, data):
    from weclip_tpu_torch.cli import common
    seen = []
    monkeypatch.setattr(meshlib, "make_mesh", lambda d, m: seen.append((d, m)) or "mesh")
    cfg = tconfig.Config()
    cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh, model_parallel=model))
    mesh, device = common.build_eval_mesh(argparse.Namespace(mesh=total, device="cpu"), cfg)
    assert (mesh, device, seen) == ("mesh", "cpu", [(data, model)])


@pytest.mark.parametrize("total, model", [(3, 2), (4, 3)])
def test_build_eval_mesh_refuses_a_total_the_model_width_does_not_divide(total, model):
    from weclip_tpu_torch.cli import common
    cfg = tconfig.Config()
    cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh, model_parallel=model))
    with pytest.raises(SystemExit, match=f"cfg.mesh.model_parallel={model}"):
        common.build_eval_mesh(argparse.Namespace(mesh=total, device="cpu"), cfg)
