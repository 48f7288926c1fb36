"""A copy of the benchmark with tiny configurations and cells, added as new
files only, for tests on the CPU; and the reference of a tiny configuration
with any tower, with its operations as ``FlopCounterMode`` and ``work.py``
count them."""

from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
TOY = Path(__file__).resolve().parent / "toy_tower"

SIZES = [[48, 64], [64, 48], [40, 64]]
TRAIN_CELLS = ("tiny-train", "tiny-comer-train")
EVAL_CELLS = ("tiny-eval", "tiny-eval-segonly")


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _dump(obj, path: Path) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def tower_published(tower: str) -> dict:
    """The ``published`` block of the first configuration file that names
    ``tower``."""
    for path in sorted((HERE / "configs").glob("*.json")):
        cfg = _load(path)
        if cfg.get("tower") == tower:
            return cfg["published"]
    raise KeyError(f"no configuration names the tower {tower!r}")


def tiny_config(name: str, comer: bool, tower: str = "openai_clip") -> dict:
    """CoMer's configuration at tiny widths, with ``tower`` and the
    published sizes of a configuration that names it."""
    cfg = _load(HERE / "configs" / "weclip-comer-vitb16-voc.json")
    cfg["name"] = name
    cfg["tower"], cfg["published"] = tower, tower_published(tower)
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
    traffic files, cells, one extra metric and a second tower
    (``toy_clip``, named by ``configs/tiny-toy.json``, which no cell runs:
    the port loads OpenAI's layout alone), each a new file; and a
    ``BENCHMARK.json`` that names the cells.  Returns the copy's root."""
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
    # a second tower, its two files, and a configuration that names it
    shutil.copy(TOY / "draw.py", b / "towers" / "toy_clip.py")
    shutil.copy(TOY / "reference.py", b / "reference" / "towers" / "toy_clip.py")
    toy = tiny_config("tiny-toy", False)
    toy["tower"], toy["published"] = "toy_clip", dict(toy["published"], mlp_ratio=2)
    _dump(toy, b / "configs" / "tiny-toy.json")
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


# -- a tiny configuration's reference, counted ------------------------------------

def reference_setup(tower: str = "openai_clip", comer: bool = False):
    """(``work.config_dict`` of a tiny configuration with ``tower`` and 4
    background classes, the reference's Config, its frozen tree, its
    trainable tree), from seed 1."""
    import torch

    from benchmark import weights, work
    from benchmark.reference import drive
    cfg_file = tiny_config("t", comer, tower)
    cfg_file["text"]["num_bg"] = 4
    d = work.config_dict(cfg_file)
    cfg = drive.from_dict(d)
    sd = weights.clip_state_dict(1, d["clip"], "cpu", tower, d["published"])
    fg, bg = weights.class_features(1, 5, 4, d["clip"]["embed_dim"], "cpu")
    shapes = [(p, tuple(t.shape)) for p, t in weights.leaf_paths(
        drive.weclip.init_trainable_params(torch.Generator().manual_seed(0), cfg, "cpu"))]
    params = drive.trainable(cfg, weights.trainable_values(1, shapes, "cpu"))
    return d, cfg, drive.frozen_state(sd, fg, bg, cfg, tower, d["published"]), params


def flops(fn) -> int:
    """``FlopCounterMode``'s total over a call of ``fn``."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def vit_flops(tower: str, export: bool):
    """(counted, work.py's) operations of the reference's frozen forward of
    two images on a 4 x 4 grid through a tiny ``tower``."""
    import numpy as np
    import torch

    from benchmark import work
    from benchmark.reference import precision, vit
    d, cfg, frozen, _ = reference_setup(tower)
    b, g, patch = 2, 4, cfg.clip.patch_size
    img = torch.randn(b, 3, g * patch, g * patch)
    pe = vit.pos_emb_host(np.random.default_rng(0).standard_normal(
        (197, cfg.clip.vision_width)).astype(np.float32), g, g, g, g)
    valid = torch.ones(b, g * g + 1, dtype=torch.bool)
    got = flops(lambda: vit.vision_forward_frozen(frozen["visual"], img,
                                                  torch.from_numpy(pe)[None], valid, cfg.clip,
                                                  precision.DEFAULT, with_attn=export))
    lens = [g * g + 1] * b
    ops = work.patch_embed(d["clip"], lens, "bf16") + work.vit_blocks(
        d, lens, "bf16", [export] * b, d["clip"]["vision_layers"] - 1)
    return got, sum(o.flops for o in ops)


def gradcam_flops(tower: str):
    """(counted, work.py's) operations of the reference's GradCAM, forward
    and backward, over two images on a 4 x 4 grid and 3 classes each,
    through a tiny ``tower``."""
    import torch

    from benchmark import work
    from benchmark.reference import gradcam, precision
    d, cfg, frozen, _ = reference_setup(tower)
    b, g, mc = 2, 4, 3
    l = g * g + 1
    x11 = torch.randn(b, l, cfg.clip.vision_width).bfloat16()
    text = torch.cat([frozen["fg_text"], frozen["bg_text"]])
    mask = torch.ones(b, text.shape[0], dtype=torch.bool)
    got = flops(lambda: gradcam.gradcam_batch(
        frozen["visual"], frozen["logit_scale"], x11, text, mask,
        torch.ones(b, l, dtype=torch.bool), 5, cfg.clip, precision.DEFAULT,
        class_idx=torch.zeros(b, mc, dtype=torch.long), grid=(g, g)))
    ops = work.gradcam(d, [l] * b, [mc] * b, text.shape[0], "bf16")
    return got, sum(o.flops for o in ops)
