"""The port's weight conversion, its isolation from JAX, and its kernel
wrappers' refusal to fall back (weclip_tpu_torch/convert.py, kernels.py)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from tests import tiny
from tests import torch_support  # noqa: F401
from weclip_tpu.core.config import ComerConfig
from weclip_tpu.models import comer as jcomer
from weclip_tpu.models import heads as jheads
from weclip_tpu.models.clip import vit as jvit
from weclip_tpu_torch import convert, kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _assert_tree_equal(a, b, where=""):
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{where}[{i}]")
        return
    assert set(a) == set(b), where
    for k in a:
        if isinstance(a[k], (dict, list)):
            _assert_tree_equal(a[k], b[k], f"{where}.{k}")
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where}.{k}")


def test_convert_round_trip():
    """(f) JAX trees -> port tensors -> numpy gives the same arrays back,
    with blocks stacked on the leading axis and torch-layout attention."""
    cfg = tiny.tiny_config()
    visual = _np_tree(jvit.init_vision_params(jax.random.PRNGKey(0), cfg.clip))
    head = _np_tree(jheads.init_head_params(jax.random.PRNGKey(1), n_layers=11,
                                            in_dim=64, embed=32, num_classes=6))
    tv = convert.visual_from_jax(visual)
    th = convert.head_from_jax(head)
    _assert_tree_equal(convert.to_numpy(tv), visual, "visual")
    _assert_tree_equal(convert.to_numpy(th), head, "head")
    assert tv["blocks"]["attn"]["in_w"].shape == (12, 3 * 64, 64)
    assert th["fuse"]["proj1_w"].shape == (11, 32, 64)
    assert all(t.dtype == torch.float32 for t in (tv["proj"], th["fuse"]["fuse_w"]))
    frozen = {"visual": visual, "logit_scale": np.float32(2.5),
              "fg_text": np.ones((5, 32), np.float32),
              "bg_text": np.zeros((3, 32), np.float32)}
    tf = convert.frozen_from_jax(frozen)
    assert float(tf["logit_scale"]) == 2.5 and tf["bg_text"].shape == (3, 32)
    assert convert.params_from_jax({"head": head})["head"]["decoder"]["pred_w"].shape == (6, 32)


def test_convert_rejects_malformed_trees():
    cfg = tiny.tiny_config()
    visual = _np_tree(jvit.init_vision_params(jax.random.PRNGKey(0), cfg.clip))
    broken = dict(visual)
    del broken["ln_post"]
    with pytest.raises(KeyError):
        convert.visual_from_jax(broken)
    ragged = dict(visual, blocks=dict(visual["blocks"],
                                      ln_1={"g": np.ones((3, 64)), "b": np.ones((12, 64))}))
    with pytest.raises(ValueError):
        convert.visual_from_jax(ragged)
    with pytest.raises(TypeError):
        convert.visual_from_jax(dict(visual, proj=np.zeros((64, 32), np.int32)))
    head = _np_tree(jheads.init_head_params(jax.random.PRNGKey(1), n_layers=11,
                                            in_dim=64, embed=32, num_classes=6))
    with pytest.raises(KeyError):
        convert.params_from_jax({"head": head, "comer": {}})
    comer = _comer_tree()
    with pytest.raises(KeyError):
        convert.comer_from_jax(dict(comer, cti=[dict(comer["cti"][0], inj={})]))
    with pytest.raises(ValueError):
        convert.comer_from_jax(dict(comer, mrfp=comer["mrfp"][:2]))


def _comer_tree():
    cfg = ComerConfig(enabled=True, stem_width=8, pyramid_dims=(16, 16, 16),
                      mrfp_dilations=(1, 2), cti_heads=2, interaction_indexes=(2, 5))
    return _np_tree(jcomer.init_comer_params(jax.random.PRNGKey(2), cfg,
                                             vit_width=32, embed=16))


def test_convert_comer_round_trip():
    """The CoMer tree (its mrfp and cti entries lists of dicts): JAX ->
    port -> numpy gives the same arrays back, also through
    params_from_jax."""
    comer = _comer_tree()
    tc = convert.comer_from_jax(comer)
    _assert_tree_equal(convert.to_numpy(tc), comer, "comer")
    assert len(tc["mrfp"]) == 3 and len(tc["cti"]) == 2
    assert tc["cti"][1]["ext"]["o_w"].shape == (16, 16)
    head = _np_tree(jheads.init_head_params(jax.random.PRNGKey(1), n_layers=11,
                                            in_dim=64, embed=32, num_classes=6))
    both = convert.params_from_jax({"head": head, "comer": comer})
    _assert_tree_equal(convert.to_numpy(both), {"head": head, "comer": comer})


def test_port_imports_without_jax():
    """(g) every module of the port imports with JAX, PIL, cv2, Orbax,
    tqdm and regex blocked (the card's machine lacks some of them), and
    none of the JAX package's modules gets imported."""
    code = """
import importlib, pkgutil, sys
for blocked in ("jax", "PIL", "cv2", "orbax", "tqdm", "regex"):
    sys.modules[blocked] = None
import weclip_tpu_torch
names = [m.name for m in pkgutil.walk_packages(weclip_tpu_torch.__path__,
                                                 "weclip_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "weclip_tpu" or m.startswith("weclip_tpu."))
assert not leaked, leaked
assert len(names) >= 62, names
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 62


def test_kernel_build_needs_nvcc(monkeypatch):
    """Without the CUDA toolkit the kernels cannot be built, and the build
    says so instead of falling back."""
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", os.path.join(REPO, "no-such-toolkit"))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.nvcc_path()


def test_launch_counters_reset():
    kernels.launches["par_affinity"] += 3
    kernels.reset_launches()
    assert set(kernels.launches) == {"attention_fwd_export", "attention_fwd",
                                     "attention_bwd", "cross_attention",
                                     "attention_bwd_rect", "par_affinity",
                                     "par_propagate", "crf_window", "qkv_bias_split",
                                     "residual_ln", "bias_quick_gelu"}
    assert not any(kernels.launches.values())


def test_every_kernel_source_has_its_signatures():
    """kernels.build() compiles one library per SIGNATURES entry: every
    csrc/*.cu is one, and every C entry point it lists is defined there
    with the argument types that ctypes passes."""
    csrc = os.path.join(REPO, "weclip_tpu_torch", "csrc")
    sources = {f[:-3] for f in os.listdir(csrc) if f.endswith(".cu")}
    assert sources == set(kernels.SIGNATURES)
    for name, fns in kernels.SIGNATURES.items():
        with open(os.path.join(csrc, f"{name}.cu")) as f:
            text = f.read()
        for fn, argtypes in fns.items():
            head = f'extern "C" int {fn}('
            assert head in text, (name, fn)
            params = text.split(head, 1)[1].split(")", 1)[0].split(",")
            assert len(params) == len(argtypes), (name, fn)
            for param, argtype in zip(params, argtypes):
                kind = {"void*": kernels._P, "int": kernels._I, "float": kernels._F}
                ctype = param.split()[-2] if "*" not in param else "void*"
                assert kind[ctype] is argtype, (name, fn, param)
