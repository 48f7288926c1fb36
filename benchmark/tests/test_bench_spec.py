"""The benchmark's files: well formed, found by name, and extended by new
files alone."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.spec import LINE, NAME, UNIT, Spec
from benchmark.tests.conftest import tiny_run

ROOT = Path(__file__).resolve().parents[2]
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
    spec = Spec()
    for c in spec.bench["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] == []
        assert data["name"] == c["name"]
        clip = data["config"]["clip"]
        assert (clip["vision_width"], clip["vision_layers"], clip["vision_heads"],
                clip["patch_size"], clip["embed_dim"]) == (768, 12, 12, 16, 512)


def test_new_files_alone_add_a_configuration_cell_and_metric(tiny_bench):
    spec, _ = tiny_bench
    assert spec.validate() == []
    names = {w["name"] for w in spec.bench["workloads"]}
    assert {"tiny-train", "tiny-eval", "voc-train"} <= names
    assert "windows.train" in [m["name"] for m in spec.per_layer("tiny-train")]
    assert callable(spec.metric_reader("windows.train"))


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
