"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the port.  Modules are compared by their
top-level name whole: ``weclip_tpu_torch`` begins with ``weclip_tpu``."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
JAX_NAMES = {"jax", "jaxlib", "flax", "weclip_tpu"}

RUN_A_CELL = """
import json, sys, time
sys.path.insert(0, {copy!r})
from benchmark import run as run_mod
from benchmark.spec import Spec
spec = Spec()
for name in spec.bench["per_layer"]:
    spec.metric_reader(name["name"])
import benchmark.readings, benchmark.reference.drive
for cell in ("tiny-comer-train", "tiny-eval"):
    run_mod.measure(spec, cell, 77, 0.5, True, device="cpu", t_start=time.perf_counter())
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""

RUN_THE_REFERENCE = """
import json, sys
sys.path.insert(0, {copy!r})
import torch
from benchmark import pool, weights, work
from benchmark.reference import drive
d = work.config_dict(json.load(open({config!r})))
sd = weights.clip_state_dict(3, d["clip"], "cpu", d["tower"], d["published"])
fg, bg = weights.class_features(3, 5, 4, d["clip"]["embed_dim"], "cpu")
shapes = [(p, tuple(t.shape)) for p, t in weights.leaf_paths(drive.weclip.init_trainable_params(
    torch.Generator().manual_seed(0), drive.from_dict(d), "cpu"))]
values = weights.trainable_values(3, shapes, "cpu")
exs = pool.make_pool(3, 8, [[48, 64]], [1, 2], 5, "cpu")
drive.train_readings(d, sd, fg, bg, values, exs, 1, "cpu")
drive.eval_outputs(d, sd, fg, bg, values, [exs[:2]], True, 64, "cpu")
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _modules(code: str) -> set:
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    copy = tiny.make_copy(tmp_path)
    found = _modules(RUN_A_CELL.format(copy=str(copy)))
    assert "weclip_tpu_torch" in found and "torch" in found
    assert not found & JAX_NAMES, found & JAX_NAMES


def test_the_reference_loads_nothing_of_the_port(tmp_path):
    copy = tiny.make_copy(tmp_path)
    config = str(copy / "benchmark" / "configs" / "tiny.json")
    found = _modules(RUN_THE_REFERENCE.format(copy=str(copy), config=config))
    assert not found & (JAX_NAMES | {"weclip_tpu_torch"})


def test_the_reference_sources_import_nothing_of_the_port():
    for path in (ROOT / "benchmark" / "reference").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".", 1)[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".", 1)[0]]
            else:
                continue
            assert not set(tops) & (JAX_NAMES | {"weclip_tpu_torch"}), (path.name, tops)
