"""A copy of the benchmark with tiny configurations and cells, added as new
files only, for tests on the CPU."""

from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

SIZES = [[48, 64], [64, 48], [40, 64]]
TRAIN_CELLS = ("tiny-train", "tiny-comer-train")
EVAL_CELLS = ("tiny-eval", "tiny-eval-segonly")


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _dump(obj, path: Path) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def tiny_config(name: str, comer: bool) -> dict:
    cfg = _load(HERE / "configs" / "weclip-comer-vitb16-voc.json")
    cfg["name"] = name
    c = cfg["config"]
    c["dataset"].update(num_classes=6, crop_size=64)
    c["clip"].update(vision_width=64, vision_layers=4, vision_heads=2, embed_dim=32,
                     embedding_dim=32, in_channels=64)
    c["par"].update(dilations=[1, 2], num_iter=4)
    c["eval"].update(resize_long=64)
    if comer:
        c["comer"].update(stem_width=8, pyramid_dims=[16, 32, 32], interaction_indexes=[1, 2],
                          cti_heads=2)
    else:
        c["comer"] = {"enabled": False}
    return cfg


def make_copy(tmp: Path) -> Path:
    """``tmp``/benchmark: this folder, plus tiny configurations, mixes'
    traffic files, cells and one extra metric, each a new file; and a
    ``BENCHMARK.json`` that names them.  Returns the copy's root."""
    tmp = Path(tmp)
    shutil.copytree(HERE, tmp / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = _load(HERE.parent / "BENCHMARK.json")
    b = tmp / "benchmark"
    _dump(tiny_config("tiny", False), b / "configs" / "tiny.json")
    _dump(tiny_config("tiny-comer", True), b / "configs" / "tiny-comer.json")
    t = _load(HERE / "traffic" / "train-b4-crop320.json")
    t.update(pool_images=24, sizes=SIZES, trace_from=1, trace_steps=2)
    _dump(t, b / "traffic" / "tiny-train.json")
    for kind in ("cam", "segonly"):
        t = _load(HERE / "traffic" / f"eval-msc-flip-{kind}.json")
        t.update(pool_images=24, sizes=SIZES, list_length=256, max_ori=64, min_batches=3,
                 trace_from=1, trace_batches=1)
        _dump(t, b / "traffic" / f"tiny-eval-{kind}.json")
    limits_train = _load(HERE / "workloads" / "voc-train.json")["limits"]
    limits_eval = _load(HERE / "workloads" / "voc-eval.json")["limits"]
    limits_seg = _load(HERE / "workloads" / "voc-eval-segonly.json")["limits"]
    cells = [("tiny-train", "tiny", "tiny-train", limits_train),
             ("tiny-comer-train", "tiny-comer", "tiny-train", limits_train),
             ("tiny-eval", "tiny", "tiny-eval-cam", limits_eval),
             ("tiny-eval-segonly", "tiny", "tiny-eval-segonly", limits_seg)]
    for name, cfg, traffic, limits in cells:
        _dump({"name": name, "config": cfg, "traffic": traffic, "why": "a tiny CPU cell",
               "limits": limits}, b / "workloads" / f"{name}.json")
        bench["workloads"].append({"name": name, "config": cfg, "traffic": traffic,
                                   "chips": 1, "why": "a tiny CPU cell"})
    bench["configs"] += [{"name": n, "source": "https://arxiv.org/abs/2406.11189",
                          "file": f"benchmark/configs/{n}.json", "reduced": [],
                          "why": "a tiny CPU configuration"} for n in ("tiny", "tiny-comer")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        ws = m.get("workloads")
        if ws is None:
            continue
        if any(w in ws for w in ("voc-train", "comer-train")):
            ws += list(TRAIN_CELLS)
        if "voc-eval" in ws:
            # the segmentation-only cell reports every evaluation metric
            # but PAR's
            ws += ["tiny-eval"] + ([] if m["name"].startswith("par_") else ["tiny-eval-segonly"])
    # one more per-layer metric, as a new reader file
    (b / "metrics" / "windows.train.py").write_text(
        '"""Steps the window ran (a test metric)."""\n\n\n'
        "def read(run):\n    return float(run.attempted)\n")
    bench["per_layer"].append({"name": "windows.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "step program",
                               "moves": "train_step_ms", "workloads": list(TRAIN_CELLS)})
    _dump(bench, tmp / "BENCHMARK.json")
    return tmp


def load(tmp: Path):
    """(spec, run module) of the copy at ``tmp``, imported afresh."""
    for k in [m for m in sys.modules if m == "benchmark" or m.startswith("benchmark.")]:
        del sys.modules[k]
    sys.path.insert(0, str(tmp))
    try:
        from benchmark import run as run_mod
        from benchmark.spec import Spec
        return Spec(tmp / "BENCHMARK.json", tmp / "benchmark"), run_mod
    finally:
        sys.path.remove(str(tmp))
