"""The port's CoMer functional benchmark
(weclip_tpu_torch/tools/comer_benchmark.py) against the JAX tool
(tools/comer_benchmark.py): the same data bit for bit, the CoMer arm's
training in lockstep from the JAX package's initial state, and the same
output keys.

Tolerance: the two packages' fp32 step losses within 1e-4 (the fp32
forward's calibration in tests/test_torch_train.py)."""

import ast
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from tests import tiny
from weclip_tpu.core.config import ComerConfig
from weclip_tpu.models import heads as jheads
from weclip_tpu.train import seg_step as jseg
from weclip_tpu_torch import convert
from weclip_tpu_torch.tools import comer_benchmark as tool

LOSS_TOL = 1e-4
JAX_TOOL = Path(__file__).resolve().parents[1] / "tools" / "comer_benchmark.py"


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_comer_benchmark", JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_texture_examples_equal_the_jax_tools(seed):
    """make_texture_example is the JAX tool's numpy code: a seed gives the
    same images and labels bit for bit, example after example."""
    jt = _jax_tool()
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(4):
        (ij, lj), (it, lt) = jt.make_texture_example(rj, 64, 6), tool.make_texture_example(rt, 64, 6)
        assert ij.dtype == it.dtype and lj.dtype == lt.dtype
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(lt, lj)


def test_config_is_the_jax_tools():
    """Each arm's config is the JAX tool's (tests/tiny.py's config, the
    tests' small CoMer dims), field for field; the CTI head width it gives
    is 256 / 2 = 128."""
    jcfg = tiny.tiny_config()
    for comer in (False, True):
        want = jcfg if not comer else dataclasses.replace(jcfg, comer=ComerConfig(
            enabled=True, stem_width=8, pyramid_dims=(16, 16, 16),
            mrfp_dilations=(1, 2), cti_heads=2, interaction_indexes=(2, 5)))
        assert dataclasses.asdict(tool.arm_config(comer)) == dataclasses.asdict(want)
    cfg = tool.arm_config(True)
    assert cfg.clip.embedding_dim // cfg.comer.cti_heads == 128


LOCKSTEP = 4   # steps: CTI's cross-attention enters the loss from the third


def test_comer_arm_trains_in_lockstep_with_jax(monkeypatch):
    """The CoMer arm from JAX's seed-0 initial state (carried into the port
    by weclip_tpu_torch.convert), fuse dropout off in both: each of the
    first 4 fp32 steps' losses within 1e-4 of the JAX tool's (the first two
    do not depend on CTI's attention: test_cti_attention_enters_the_loss)."""
    fuse = jheads.fuse_forward
    monkeypatch.setattr(jheads, "fuse_forward",
                        lambda p, x, rng=None, **kw: fuse(p, x, None, **kw))
    jt = _jax_tool()
    cfg = tiny.tiny_config()
    cfg = dataclasses.replace(cfg, comer=ComerConfig(
        enabled=True, stem_width=8, pyramid_dims=(16, 16, 16),
        mrfp_dilations=(1, 2), cti_heads=2, interaction_indexes=(2, 5)))
    # the JAX tool's own initial state at seed 0
    frozen, _ = tiny.tiny_frozen(cfg, seed=0)
    state, _ = jseg.create_seg_train_state(jax.random.PRNGKey(0), cfg)
    _, want = jt.run_arm(True, LOCKSTEP, 4, 0, 0)
    _, got = tool.run_arm(True, LOCKSTEP, 4, 0, 0, device="cpu",
                          frozen=convert.frozen_from_jax(_np(frozen)),
                          params=convert.params_from_jax(_np(state.params)),
                          dropout=False)
    assert len(got) == len(want) == LOCKSTEP
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=LOSS_TOL)


def test_cti_attention_enters_the_loss(monkeypatch):
    """Which of the CoMer arm's first 4 losses run through CTI's attention
    (on the card K6's forward and K3-rect's gradients; on the CPU the plain
    forward and its autograd): none of the first, since CTI's output
    projections start at zero, and the later ones do.  Scaling the
    attention's output by 1.01 moves the third and fourth losses; cutting
    its gradients to q, k and v (K3-rect's outputs) moves the fourth (a
    step's gradients reach the loss of the step after it)."""
    from weclip_tpu_torch.ops import attention_kernels as ak

    def losses():
        return tool.run_arm(True, LOCKSTEP, 4, 0, 0, device="cpu", dropout=False)[1]

    base = losses()
    fwd = ak.cross_attention_core_plain
    monkeypatch.setattr(ak, "cross_attention_core_plain", lambda *a: fwd(*a) * 1.01)
    k6 = losses()
    monkeypatch.setattr(ak, "cross_attention_core_plain", lambda *a: fwd(*a).detach())
    k3 = losses()
    assert k6[0] == base[0] and k3[0] == base[0]
    assert k6[2] != base[2] and k6[3] != base[3]
    assert k3[3] != base[3]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree.detach().double().numpy().ravel()
    elif hasattr(tree, "shape"):
        yield prefix, np.asarray(tree, np.float64).ravel()


def test_initial_weights_follow_jaxs_distributions():
    """The port's seeded initial state of the CoMer arm draws each leaf
    from the JAX package's distribution (the two differ only in their
    random streams): over seeds 0-2, every leaf of 256 or more values has
    its mean and standard deviation within a tenth of the larger standard
    deviation, and every constant leaf the same constant."""
    cfg = dataclasses.replace(tiny.tiny_config(), comer=ComerConfig(
        enabled=True, stem_width=8, pyramid_dims=(16, 16, 16),
        mrfp_dilations=(1, 2), cti_heads=2, interaction_indexes=(2, 5)))
    from weclip_tpu_torch.train import seg_step as tseg
    want, got = {}, {}
    for seed in range(3):
        state, _ = jseg.create_seg_train_state(jax.random.PRNGKey(seed), cfg)
        for k, v in _leaves(convert.params_from_jax(_np(state.params))):
            want.setdefault(k, []).append(v)
        ours = tseg.create_seg_train_state(torch.Generator().manual_seed(seed),
                                           tool.arm_config(True), "cpu")
        for k, v in _leaves(ours.params):
            got.setdefault(k, []).append(v)
    assert set(got) == set(want)
    for k in want:
        a, b = np.concatenate(want[k]), np.concatenate(got[k])
        sd = max(a.std(), b.std())
        if sd == 0:
            assert a[0] == b[0], k
        elif a.size >= 256:
            assert abs(a.std() - b.std()) <= 0.1 * sd, k
            assert abs(a.mean() - b.mean()) <= 0.1 * sd, k


def _jax_tool_keys():
    """The keys of the JSON object the JAX tool's main prints last."""
    tree = ast.parse(JAX_TOOL.read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "out" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no out = {...} in the JAX tool")


def test_main_prints_the_jax_tools_keys(capsys):
    """main(--steps 2 --eval_n 4 --device cpu) runs both arms and prints one
    JSON line with the JAX tool's keys and finite scores."""
    torch.manual_seed(0)
    out = tool.main(["--steps", "2", "--eval_n", "4", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    printed = json.loads(line)
    assert set(printed) == _jax_tool_keys()
    assert printed == json.loads(json.dumps(out))
    assert printed["steps"] == 2 and printed["seeds"] == 1
    for key in ("plain_miou", "comer_miou", "plain_final_loss", "comer_final_loss"):
        assert np.isfinite(printed[key]), key
