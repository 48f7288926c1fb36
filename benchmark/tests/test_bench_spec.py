"""The benchmark's files: well formed, found by name, and extended by new
files alone."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.spec import LINE, NAME, UNIT, Spec
from benchmark.tests import tiny
from benchmark.tests.conftest import tiny_run

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"
LAST_LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_benchmark_json_is_valid():
    spec = Spec()
    assert spec.validate() == []
    assert spec.bench["paths"] == ["benchmark"]


def test_every_cell_names_an_existing_configuration_and_mix():
    spec = Spec()
    for w in spec.bench["workloads"]:
        cell = spec.workload(w["name"])
        assert (spec.folder / "configs" / f"{cell['config']}.json").exists()
        traffic = spec.traffic(cell["traffic"])
        assert (spec.folder / "mixes" / f"{traffic['mix']}.py").exists()
        assert set(cell["limits"]) >= {"inputs", "seg", "loss", "grad", "update"} or \
            set(cell["limits"]) >= {"logits", "msc_gap", "hists"}


def test_names_units_and_texts_use_the_allowed_characters():
    spec = Spec()
    b = spec.bench
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in b[group]:
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e and group != "end_to_end":
                    assert LINE.match(e[key]), e[key]
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
    for path in spec.folder.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(spec.folder.parent).as_posix()
        assert all(NAME.match(part) for part in rel.split("/")), rel
    assert len(json.dumps(b)) < 64 * 1024


def test_configuration_files_state_their_cuts():
    """Nothing is cut: each file's tower sizes are its own published ones,
    and its tower has both of its files."""
    spec = Spec()
    sizes = ("vision_width", "vision_layers", "vision_heads", "patch_size", "embed_dim")
    for c in spec.bench["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] == []
        assert data["name"] == c["name"]
        clip, published = data["config"]["clip"], data["published"]
        assert {k: clip[k] for k in sizes} == {k: published[k] for k in sizes}, c["name"]
        for folder in ("towers", "reference/towers"):
            assert (spec.folder / folder / f"{data['tower']}.py").exists(), (c["name"], folder)


def test_a_configuration_names_a_tower_that_has_both_files(tmp_path):
    copy = tiny.make_copy(tmp_path)
    path = copy / "benchmark" / "configs" / "tiny.json"
    good = json.loads(path.read_text())
    spec = Spec(copy / "BENCHMARK.json", copy / "benchmark")
    assert spec.validate() == []
    for tower, error in ((None, "config tiny: tower None"),
                         ("toy-clip", "config tiny: tower 'toy-clip'"),
                         ("no_such", "config tiny: no towers/no_such.py")):
        bad = {k: v for k, v in good.items() if k != "tower"}
        if tower is not None:
            bad["tower"] = tower
        path.write_text(json.dumps(bad))
        assert error in spec.validate()
    (copy / "benchmark" / "reference" / "towers" / "toy_clip.py").unlink()
    path.write_text(json.dumps(dict(good, tower="toy_clip")))
    assert spec.validate() == ["config tiny: no reference/towers/toy_clip.py"]
    from benchmark import towers
    for bad_name in ("toy-clip", "../weights", None):
        with pytest.raises(ValueError):
            towers.load(bad_name)


def test_new_files_alone_add_a_configuration_cell_and_metric(tiny_bench):
    spec, _ = tiny_bench
    assert spec.validate() == []
    names = {w["name"] for w in spec.bench["workloads"]}
    assert {"tiny-train", "tiny-eval", "voc-train"} <= names
    assert "windows.train" in [m["name"] for m in spec.per_layer("tiny-train")]
    assert callable(spec.metric_reader("windows.train"))


def test_new_files_alone_add_a_tower(tiny_bench):
    """A second tower (``toy_clip``: OpenAI's block with a 2x MLP, and no
    ln_pre), added to the copy as two new files and named by a new
    configuration, is drawn, converted, run through the reference's frozen
    forward, GradCAM and an evaluation batch on the CPU, and counted; no
    file of this folder changes."""
    spec, _ = tiny_bench
    import importlib

    import torch

    from benchmark import pool, towers, weights, work
    from benchmark.reference import drive
    copy_tiny = importlib.import_module("benchmark.tests.tiny")
    for path in HERE.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            assert (spec.folder / path.relative_to(HERE)).read_bytes() == path.read_bytes()

    config = spec.config("tiny-toy")
    d = work.config_dict(config)
    assert d["tower"] == "toy_clip" and d["published"]["mlp_ratio"] == 2
    w = d["clip"]["vision_width"]
    sd = weights.clip_state_dict(3, d["clip"], "cpu", d["tower"], d["published"])
    assert not [k for k in sd if "ln_pre" in k]
    assert sd["visual.transformer.resblocks.0.mlp.c_fc.weight"].shape == (2 * w, w)
    assert towers.load("toy_clip").block_products(d["clip"], d["published"], 1, 5)[2] == (
        5, w, 2 * w)
    cfg = drive.from_dict(d)
    visual = drive.frozen_state(sd, *weights.class_features(3, 5, 4, d["clip"]["embed_dim"],
                                                            "cpu"),
                                cfg, d["tower"], d["published"])["visual"]
    assert "ln_pre" not in visual and visual["tower"].__name__.endswith(".toy_clip")

    for export in (True, False):
        got, want = copy_tiny.vit_flops("toy_clip", export)
        assert got == want
    got, want = copy_tiny.gradcam_flops("toy_clip")
    assert got == want

    fg, bg = weights.class_features(3, 5, config["text"]["num_bg"], d["clip"]["embed_dim"],
                                    "cpu")
    shapes = [(p, tuple(t.shape)) for p, t in weights.leaf_paths(
        drive.weclip.init_trainable_params(torch.Generator().manual_seed(0), cfg, "cpu"))]
    values = weights.trainable_values(3, shapes, "cpu")
    exs = pool.make_pool(3, 4, [[48, 64]], [1, 2], 5, "cpu")
    out = drive.eval_outputs(d, sd, fg, bg, values, [exs[:2]], True, 64, "cpu")
    assert torch.isfinite(out[0]["msc"]).all() and out[0]["cams"].shape[:2] == (2, 4)

    # a 2x MLP counts less than OpenAI's 4x at the same widths
    openai = dict(d, tower="openai_clip")
    sizes, mcs = [(48, 64), (64, 48)], [1, 2]
    assert (sum(o.flops for o in work.eval_batch(d, sizes, True, mcs))
            < sum(o.flops for o in work.eval_batch(openai, sizes, True, mcs)))


def test_the_last_line_has_the_contract_keys(tiny_bench):
    spec, run_mod = tiny_bench
    run, line = tiny_run(spec, run_mod, "tiny-train", trace=False)
    assert list(line) == LAST_LINE_KEYS
    assert set(line["metrics"]) == {"train_step_ms", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    run, line = tiny_run(spec, run_mod, "tiny-train", trace=True)
    assert list(line) == LAST_LINE_KEYS[:5] + ["breakdown", "checks"]
    assert line["metrics"]["windows.train"]["value"] == run.attempted
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(line)


def test_the_command_fails_without_a_card():
    # this sandbox's PyTorch has no CUDA: no result line, a non-zero exit
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "voc-train",
                           "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_the_command_fails_without_the_port(tmp_path):
    (tmp_path / "benchmark").mkdir()
    for p in (ROOT / "benchmark").rglob("*.py"):
        dst = tmp_path / p.relative_to(ROOT)
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_bytes(p.read_bytes())
    for p in (ROOT / "benchmark").rglob("*.json"):
        dst = tmp_path / p.relative_to(ROOT)
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_bytes(p.read_bytes())
    (tmp_path / "BENCHMARK.json").write_bytes((ROOT / "BENCHMARK.json").read_bytes())
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "voc-train",
                           "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
