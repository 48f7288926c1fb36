"""The program's span and counter recorder (weclip_tpu_torch/utils/spans.py):
step grouping, nesting and self time, the ring's bound, annotations only
under a profiler and as its top-level host events, syncs counted under the
profiler only, the by-kernel launch view, device-timed spans (nothing on
the CPU), the benchmark's readers of the records, and the spans of a
training step, an evaluation batch and the trainer's profile export on the
CPU.  Two tests, marked ``cuda``, count the walk's synchronizations and time
a device span against its kernels on the card; run them there with
``python -m pytest --noconftest -m cuda tests/test_torch_spans.py``."""

import inspect
import json
import sys
import types
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.torch_support import card  # noqa: F401
from weclip_tpu_torch import kernels
from weclip_tpu_torch.core import config as tconfig
from weclip_tpu_torch.utils import spans

TRAIN_STAGES = ("input.wait", "input.batch", "backbone", "heads", "chain.gradcam",
                "chain.walk", "chain.par", "loss", "backward", "optimizer")


class Clock:
    """A host clock the test advances."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(spans.time, "perf_counter", c)
    return c


def _spans(rec):
    return {(n, p): (v[0], v[1], v[2]) for (n, p), v in rec.spans.items()}


def test_steps_group_spans_and_input_lands_in_the_next_step(clock):
    r = spans.Recorder()
    with r.span("input.wait"):
        clock.t += 1.0
    with r.step("train.step"):
        with r.span("backbone"):
            clock.t += 2.0
        r.count("launches", 3, key=("par_propagate", (1, 2)))
    with r.span("input.wait"):          # between two steps: the next one's
        clock.t += 4.0
    assert len(r.records) == 1 and r.closed == 1
    first = r.records[0]
    assert (first.kind, first.index, first.profiled) == ("train.step", 0, False)
    assert _spans(first) == {("input.wait", None): (1.0, 1.0, 1),
                             ("backbone", "train.step"): (2.0, 2.0, 1),
                             ("train.step", None): (2.0, 0.0, 1)}
    assert first.counts == {("launches", "train.step"): 3}
    assert first.keyed == {("launches", ("par_propagate", (1, 2))): 3}
    with r.step("eval.batch"):
        pass
    with r.step("train.step"):
        pass
    assert _spans(r.records[1])[("input.wait", None)] == (4.0, 4.0, 1)
    assert [(x.kind, x.index) for x in r.records] == [
        ("train.step", 0), ("eval.batch", 0), ("train.step", 1)]


def test_nesting_parents_and_self_time(clock):
    r = spans.Recorder()
    with r.step("eval.batch"):
        with r.span("eval.scale1"):
            clock.t += 0.5
            with r.span("backbone"):
                clock.t += 2.0
            with r.span("chain.walk"):
                clock.t += 1.0
                r.count(spans.SYNC)
                r.count(spans.SYNC)
        with r.span("eval.scale2"):
            with r.span("backbone"):
                clock.t += 3.0
        with r.span("heads"):
            clock.t += 0.25
        with r.span("heads"):
            clock.t += 0.25
    rec = r.records[0]
    got = _spans(rec)
    assert got[("eval.scale1", "eval.batch")] == (3.5, 0.5, 1)
    assert got[("backbone", "eval.scale1")] == (2.0, 2.0, 1)
    assert got[("backbone", "eval.scale2")] == (3.0, 3.0, 1)
    assert got[("eval.scale2", "eval.batch")] == (3.0, 0.0, 1)
    assert got[("heads", "eval.batch")] == (0.5, 0.5, 2)
    assert got[("eval.batch", None)] == (7.0, 0.0, 1)
    assert rec.host_s(["backbone"]) == 5.0
    assert rec.host_s(["backbone", "heads"]) == 5.5
    assert rec.counts == {(spans.SYNC, "chain.walk"): 2}
    assert rec.count(spans.SYNC) == 2
    js = rec.to_json()
    json.dumps(js)
    assert {"name": "backbone", "parent": "eval.scale2", "total_s": 3.0, "self_s": 3.0,
            "calls": 1} in js["spans"]


def test_the_ring_is_bounded():
    r = spans.Recorder(size=5)
    for _ in range(8):
        with r.step("train.step"):
            pass
    assert len(r.records) == 5 and r.closed == 8
    assert [x.index for x in r.records] == [3, 4, 5, 6, 7]
    assert [x.index for x in r.window(2)] == [6, 7]
    assert [x.index for x in r.since(6)] == [6, 7]
    assert [x.index for x in r.since(0)] == [3, 4, 5, 6, 7]
    assert r.window(0) == [] and len(r.window(50)) == 5
    assert spans.RING >= 4096


def test_no_annotation_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"annotated {name} with no profiler recording")

    monkeypatch.setattr(spans._profiler, "record_function", refuse)
    r = spans.Recorder()
    with r.step("train.step"):
        with r.span("backbone"):
            torch.ones(4).add_(1)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            with r.span("chain.walk"):
                warnings.warn(spans.SYNC_MESSAGE)
    assert not r.records[0].profiled and not r._capturing
    assert r.records[0].counts == {}      # syncs count under a profiler only
    assert [str(w.message) for w in seen] == [spans.SYNC_MESSAGE]


def _host_events(prof):
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]


def test_spans_are_top_level_host_events_around_their_ops():
    r = spans.Recorder()
    x = torch.randn(32, 32)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        with r.span("input.wait"):
            x + 1
        with r.step("eval.batch"):
            with r.span("eval.scale1"):
                with r.span("chain.walk"):
                    x @ x
                torch.relu(x)
    finally:
        prof.stop()
        r.notice()
    assert not r._capturing
    events = _host_events(prof)
    by_name = {e.name: e for e in events}
    # the step is not an annotation; its stages are top level
    assert "eval.batch" not in by_name
    for name in ("input.wait", "eval.scale1"):
        assert by_name[name].cpu_parent is None
    assert by_name["chain.walk"].cpu_parent.name == "eval.scale1"
    parent = {e.name: e.cpu_parent.name for e in events
              if e.name in ("aten::add", "aten::matmul", "aten::relu")}
    assert parent == {"aten::add": "input.wait", "aten::matmul": "chain.walk",
                      "aten::relu": "eval.scale1"}
    for outer, inner in (("input.wait", "aten::add"), ("chain.walk", "aten::matmul")):
        o, i = by_name[outer].time_range, by_name[inner].time_range
        assert o.start <= i.start and i.end <= o.end
    assert [rec.profiled for rec in r.records] == [True]


def test_an_annotation_entered_before_the_profiler_stops_exits_cleanly():
    r = spans.Recorder()
    x = torch.randn(16, 16)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with r.step("eval.batch"):
        with r.span("eval.combine"):
            x * 2
            prof.stop()                 # as the evaluation mix stops it
            x * 3
    assert r.records[0].profiled and not r._capturing
    assert "eval.combine" in {e.name for e in _host_events(prof)}
    # and the recorder goes on, unannotated, with no profiler
    with r.step("eval.batch"):
        with r.span("eval.combine"):
            x * 4
    assert not r.records[1].profiled
    assert r._stack() == []


def test_syncs_count_by_span_and_line_under_the_profiler():
    r = spans.Recorder()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
        try:
            with r.step("train.step"):
                with r.span("chain.walk"):
                    for _ in range(3):
                        warnings.warn(spans.SYNC_MESSAGE)
                    line = inspect.currentframe().f_lineno - 1
                warnings.warn("another warning")
        finally:
            prof.stop()
            r.notice()
    rec = r.records[0]
    assert rec.counts == {(spans.SYNC, "chain.walk"): 3}
    ((counter, key), n), = rec.keyed.items()
    assert (counter, n) == (spans.SYNC, 3) and key.endswith(f"test_torch_spans.py:{line}")
    # other warnings still reach whoever shows them
    assert [str(w.message) for w in seen] == ["another warning"]


def test_launch_counts_keep_their_by_kernel_view():
    names = {"attention_fwd_export", "attention_fwd", "attention_bwd", "cross_attention",
             "attention_bwd_rect", "par_affinity", "par_propagate", "crf_window",
             "qkv_bias_split", "residual_ln", "bias_quick_gelu"}
    kernels.reset_launches()
    try:
        assert set(kernels.launches) == names and len(kernels.launches) == 11
        assert not any(kernels.launches.values())
        rec = spans.RECORDER.open
        kernels.count_launch("par_propagate", (2, 5, 64, 64), 20)
        kernels.count_launch("par_propagate", (1, 3, 64, 64), 20)
        kernels.count_launch("attention_fwd_export", (2, 12, 1025, 64))
        assert kernels.launches["par_propagate"] == 40
        assert dict(kernels.launches)["attention_fwd_export"] == 1
        assert rec.keyed[(spans.LAUNCHES, ("par_propagate", (2, 5, 64, 64)))] >= 20
        kernels.launches["par_affinity"] += 3
        assert kernels.launches["par_affinity"] == 3
        with pytest.raises(KeyError):
            kernels.count_launch("no_such_kernel", (1,))
        with pytest.raises(KeyError):
            kernels.launches["no_such_kernel"]
    finally:
        kernels.reset_launches()
    assert not any(kernels.launches.values())


# -- the benchmark's readers -------------------------------------------------

# metric -> (names read, or None for the sync count)
READERS = {
    "loader_wait_ms.train": ("input.wait",),
    "backbone_host_ms.train": ("backbone",),
    "heads_host_ms.train": ("heads",),
    "comer_host_ms.train": ("comer",),
    "chain_host_ms.train": ("chain.gradcam", "chain.walk", "chain.par"),
    "backward_host_ms.train": ("backward",),
    "optimizer_host_ms.train": ("optimizer",),
    "syncs_per_step.train": None,
    "prefetch_wait_ms.eval": ("eval.wait",),
    "scale1_host_ms.eval": ("eval.scale1",),
    "scale2_host_ms.eval": ("eval.scale2",),
    "combine_host_ms.eval": ("eval.combine",),
    "syncs_per_batch.eval": None,
}
ALL_NAMES = sorted({n for v in READERS.values() if v for n in v})


def _filled_ring(clock, kind, before, stretch, after, warm):
    """A recorder of ``warm`` steps outside the window, then the window:
    ``before`` untraced steps, ``stretch`` profiled ones (2 syncs each),
    ``after`` untraced ones.  Each span of step i of a part takes
    (part + 1) * 1e-3 * (1 + i % 2) s."""
    r = spans.Recorder()
    for part, n in enumerate((warm, before, stretch, after)):
        for i in range(n):
            with r.step(kind):
                with r.span("wrapper"):
                    for name in ALL_NAMES:
                        with r.span(name):
                            clock.t += (part + 1) * 1e-3 * (1 + i % 2)
                if part == 2:
                    r.open.profiled = True
                    r.count(spans.SYNC, 2, key="refine/bbox.py:39")
    return r


@pytest.mark.parametrize("metric", sorted(READERS))
def test_each_reader_takes_its_window_records(metric, clock, monkeypatch):
    from benchmark.spec import Spec
    spec = Spec()
    entry = next(m for m in spec.bench["per_layer"] if m["name"] == metric)
    kind = "train.step" if metric.endswith(".train") else "eval.batch"
    before, stretch, after = (10, 10, 3) if kind == "train.step" else (3, 4, 2)
    monkeypatch.setattr(spans, "RECORDER",
                        _filled_ring(clock, kind, before, stretch, after, warm=5))
    run = types.SimpleNamespace(untraced_units=before + after, stretch_units=stretch)
    got = spec.metric_reader(metric)(run)
    names = READERS[metric]
    if names is None:
        assert entry["source"] == "program_counter"
        assert got == pytest.approx(2.0)
    else:
        assert entry["source"] == "program_span" and entry["unit"] == "ms"
        # the untraced steps before the stretch: part 1, 1 or 2 ms a span
        per_step = [2e-3 * (1 + i % 2) for i in range(before)]
        want = 1e3 * len(names) * sum(per_step) / before
        assert got == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_readers_read_nothing_from_a_program_without_the_recorder(metric, monkeypatch):
    from benchmark.spec import Spec
    monkeypatch.setitem(sys.modules, "weclip_tpu_torch.utils.spans", None)
    run = types.SimpleNamespace(untraced_units=10, stretch_units=10)
    assert Spec().metric_reader(metric)(run) is None


# metric -> the device-timed span it reads
DEVICE_READERS = {"backbone_device_ms.eval": "backbone",
                  "gradcam_device_ms.eval": "chain.gradcam"}


def _device_ring(clock, name, before, stretch, after, unresolved=()):
    """An evaluation ring whose untraced batch i before the stretch spent
    (1 + i) ms of device time in two calls of ``name``; batches listed in
    ``unresolved`` hold none yet, and the stretch's and later batches hold
    100 ms (which no reader may take)."""
    r = spans.Recorder()
    for part, n in enumerate((before, stretch, after)):
        for i in range(n):
            with r.step("eval.batch"):
                with r.span("eval.scale1"):
                    with r.span(name):
                        clock.t += 1e-3
                if part == 1:
                    r.open.profiled = True
                if part or i not in unresolved:
                    s = 0.1 if part else 1e-3 * (1 + i)
                    r.open.device[(name, "eval.scale1")] = [s, 2]
    return r


@pytest.mark.parametrize("metric", sorted(DEVICE_READERS))
def test_each_device_reader_takes_the_resolved_batches_before_the_stretch(
        metric, clock, monkeypatch):
    from benchmark.spec import Spec
    spec = Spec()
    entry = next(m for m in spec.bench["per_layer"] if m["name"] == metric)
    assert (entry["source"], entry["unit"], entry["layer"], entry["moves"]) == (
        "program_span", "ms", "model", "eval_images_per_s")
    assert entry["workloads"] == ["voc-eval", "comer-eval", "vitl14-eval"]
    name = DEVICE_READERS[metric]
    run = types.SimpleNamespace(untraced_units=6, stretch_units=3)
    monkeypatch.setattr(spans, "RECORDER", _device_ring(clock, name, 4, 3, 2))
    assert spec.metric_reader(metric)(run) == pytest.approx(2.5)
    # a batch whose pair has not resolved is left out, not read as 0
    monkeypatch.setattr(spans, "RECORDER",
                        _device_ring(clock, name, 4, 3, 2, unresolved=(3,)))
    assert spec.metric_reader(metric)(run) == pytest.approx(2.0)
    # another span's device time is not read
    other = "chain.gradcam" if name == "backbone" else "backbone"
    monkeypatch.setattr(spans, "RECORDER", _device_ring(clock, other, 4, 3, 2))
    assert spec.metric_reader(metric)(run) is None


@pytest.mark.parametrize("metric", sorted(DEVICE_READERS))
def test_device_readers_read_nothing_from_records_without_device_time(metric, clock,
                                                                       monkeypatch):
    """A program whose records have no device time (the recorder before it
    timed spans on the card), and one without the recorder."""
    from benchmark.spec import Spec
    r = spans.Recorder()
    for _ in range(6):
        with r.step("eval.batch"):
            with r.span(DEVICE_READERS[metric]):
                clock.t += 1e-3
    # the earlier recorder's records: host spans and counts alone
    old = [types.SimpleNamespace(kind=x.kind, profiled=x.profiled, spans=x.spans,
                                 counts=x.counts, keyed=x.keyed) for x in r.records]
    r.records.clear()
    r.records.extend(old)
    monkeypatch.setattr(spans, "RECORDER", r)
    run = types.SimpleNamespace(untraced_units=6, stretch_units=0)
    assert Spec().metric_reader(metric)(run) is None
    monkeypatch.setitem(sys.modules, "weclip_tpu_torch.utils.spans", None)
    assert Spec().metric_reader(metric)(run) is None


def test_device_spans_on_the_cpu_record_nothing_and_add_no_sync(clock):
    """Without a card in use a device-timed span is a host span: no event,
    no device time, nothing pending; under a profiler it counts no sync."""
    r = spans.Recorder()
    x = torch.randn(64, 64)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        with r.step("eval.batch"):
            with r.span("eval.scale1"):
                with r.span("backbone", device=x.is_cuda):
                    x @ x
                    clock.t += 2e-3
                with r.span("chain.gradcam", device=True):
                    x @ x
                    clock.t += 1e-3
    finally:
        prof.stop()
        r.notice()
    rec = r.records[0]
    assert rec.profiled and rec.device == {} and r._pending == []
    assert rec.count(spans.SYNC) == 0
    assert rec.spans[("backbone", "eval.scale1")][0] == pytest.approx(2e-3)
    assert rec.device_s(("backbone", "chain.gradcam")) is None
    assert rec.to_json()["device"] == []


# -- the program's spans on the CPU -------------------------------------------

def _tiny_cfg(work_dir="unused"):
    """A tiny fp32 configuration: ViT width 64, 4 layers, crop 64, 6 classes."""
    t = tconfig.from_dict({
        "dataset": {"crop_size": 64, "num_classes": 6},
        "clip": {"patch_size": 16, "vision_width": 64, "vision_layers": 4,
                 "vision_heads": 2, "embed_dim": 32, "context_length": 16,
                 "vocab_size": 128, "transformer_width": 32, "transformer_heads": 2,
                 "transformer_layers": 2},
        "par": {"dilations": [1, 2], "num_iter": 4},
        "precision": {"compute_dtype": "float32"},
        "train": {"samples_per_gpu": 2, "eval_iters": 100, "log_iters": 2,
                  "ckpt_start_iter": 100, "seg_trans_start_iter": 3},
        "eval": {"batch_images": 2},
        "work_dir": {"dir": str(work_dir)},
    })
    return t


def _train_data(n=6, seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        present = np.zeros(5, bool)
        present[[i % 5, 4]] = True
        out.append({"img": rng.standard_normal((3, 64, 64)).astype(np.float32),
                    "present_mask": present})
    return out


def _val_data(n=4, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        oh, ow = 48 - 8 * (i % 2), 64
        present = np.zeros(5, bool)
        present[[0, 1]] = True
        out.append({"img_raw": rng.integers(0, 256, (oh, ow, 3)).astype(np.uint8),
                    "label": rng.integers(0, 3, (oh, ow)).astype(np.int32),
                    "present_mask": present, "name": f"im{i}"})
    return out


def test_training_profile_writes_the_profiled_steps_span_records(tmp_path):
    """``train(profile_steps=...)`` writes ``spans.json`` beside the
    Chrome trace: the profiled steps' records, whose stage spans cover the
    step, and the trace's top-level host events name the stages."""
    from weclip_tpu_torch.models import weclip
    from weclip_tpu_torch.train import trainer
    cfg = _tiny_cfg(tmp_path)
    frozen = weclip.random_frozen_state(cfg, seed=0)
    closed = spans.RECORDER.closed
    trainer.train(cfg, _train_data(), max_steps=4, device="cpu", frozen=frozen,
                  profile_steps=(1, 2))
    steps = [r for r in spans.RECORDER.since(closed) if r.kind == "train.step"]
    assert len(steps) == 4
    assert [r.profiled for r in steps] == [False, True, True, False]
    for r in steps:
        step_s = r.host_s(["train.step"])
        stages = r.host_s(TRAIN_STAGES) - r.host_s(["input.wait", "input.batch"])
        assert {n for n, _ in r.spans} >= set(TRAIN_STAGES)
        assert dict(r.spans)[("backbone", "train.step")][0] > 0
        assert stages <= step_s and stages >= 0.5 * step_s
    out = tmp_path / "profile"
    records = json.loads((out / "spans.json").read_text())
    assert [(r["kind"], r["profiled"]) for r in records] == [("train.step", True)] * 2
    names = {s["name"] for r in records for s in r["spans"]}
    assert names >= set(TRAIN_STAGES)
    trace = json.loads((out / "trace.json").read_text())
    assert {e.get("name") for e in trace["traceEvents"]} >= {"backbone", "chain.walk",
                                                              "backward", "optimizer"}


def test_an_evaluation_batch_is_a_step_of_its_stages():
    from weclip_tpu_torch.core import precision
    from weclip_tpu_torch.evalx.runner import Evaluator, make_prep
    from weclip_tpu_torch.models import weclip
    cfg = _tiny_cfg()
    frozen = weclip.random_frozen_state(cfg, seed=0)
    params = weclip.init_trainable_params(torch.Generator().manual_seed(0), cfg)
    pe = frozen["visual"]["positional_embedding"].float().numpy()
    ev = Evaluator(cfg, make_prep(cfg, 64, None), pe, policy=precision.FP32, device="cpu")
    closed = spans.RECORDER.closed
    ev.run(params, frozen, _val_data())
    batches = spans.RECORDER.since(closed)
    assert [(r.kind, r.profiled) for r in batches] == [("eval.batch", False)] * 2
    for r in batches:
        got = {k for k in r.spans}
        assert got >= {("eval.wait", "eval.batch"), ("eval.scale1", "eval.batch"),
                       ("eval.scale2", "eval.batch"), ("eval.combine", "eval.batch"),
                       ("backbone", "eval.scale1"), ("backbone", "eval.scale2"),
                       ("chain.gradcam", "eval.scale1"), ("chain.par", "eval.scale1")}
    # the worker thread's spans have no parent; the read-back is the next
    # record's
    prepared = sum(r.spans.get(("eval.prepare", None), [0, 0, 0])[2]
                   for r in batches + [spans.RECORDER.open])
    assert prepared == 2
    assert ("eval.readback", None) in spans.RECORDER.open.spans


# -- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_the_sync_counter_counts_the_walks_loop_on_the_card(card, monkeypatch):
    """Under a profiler, each iteration of ``bbox.connected_components``'
    loop reads ``torch.any`` to the host: one sync a pass at its line; a
    copy from pageable memory is one more."""
    from weclip_tpu_torch.refine import bbox
    grid = torch.zeros((2, 12, 12), dtype=torch.bool)
    grid[0, 1, 1:11] = grid[0, 1:11, 10] = grid[0, 10, 1:11] = True    # a long path
    grid[1, 5:7, 5:7] = True
    reads = []
    real_any = torch.any
    monkeypatch.setattr(bbox.torch, "any", lambda t: reads.append(1) or real_any(t))
    want = bbox.connected_components(grid)
    monkeypatch.setattr(bbox.torch, "any", real_any)
    line = next(i for i, text in enumerate(inspect.getsource(bbox).splitlines(), 1)
                if "bool(torch.any(" in text)
    host = np.ones((4, 64), np.float32)
    g = grid.to(card)
    torch.cuda.synchronize()
    r = spans.Recorder()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        with r.step("train.step"):
            with r.span("chain.walk"):
                got = bbox.connected_components(g)
            with r.span("input.batch"):
                torch.from_numpy(host).to(card)
    finally:
        torch.cuda.synchronize()
        prof.stop()
        r.notice()
    assert torch.equal(got.cpu(), want) and len(reads) > 3
    rec = r.records[0]
    assert rec.counts[(spans.SYNC, "chain.walk")] == len(reads)
    assert rec.keyed[(spans.SYNC, f"refine/bbox.py:{line}")] == len(reads)
    assert rec.counts[(spans.SYNC, "input.batch")] == 1
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
def test_a_device_span_times_at_least_its_kernels_and_forces_no_sync(card):
    """The event pair around a span covers the work it queued: at least the
    time the same products take between two events of their own.  Under a
    profiler the span counts no sync, and its pair resolves only once its
    end has completed."""
    a = torch.randn((4096, 4096), device=card)
    for _ in range(3):
        a @ a
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        a @ a
    end.record()
    torch.cuda.synchronize()
    alone_s = 1e-3 * start.elapsed_time(end)
    assert alone_s > 1e-3
    r = spans.Recorder()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        with r.step("eval.batch"):
            with r.span("eval.scale1"):
                with r.span("backbone", device=a.is_cuda):
                    for _ in range(20):
                        a @ a
        rec = r.records[0]
        pending = len(r._pending)
    finally:
        torch.cuda.synchronize()
        prof.stop()
        r.notice()
    assert rec.count(spans.SYNC) == 0
    assert pending == 1 and rec.device == {}
    r.resolve()
    assert r._pending == []
    seconds, calls = rec.device[("backbone", "eval.scale1")]
    assert calls == 1 and seconds >= 0.9 * alone_s
    assert rec.device_s(("backbone",)) == seconds
