"""The frozen ViT forward's CUDA graphs (weclip_tpu_torch/models/clip/graphs.py,
``vit.vision_forward_frozen``).

On the CPU, with the capture stubbed: eager at a signature's first call,
capture at its second, replay after; eager under a profiler or with no key;
least-recently-used eviction; eager for good after a failed capture; the
``backbone_graph`` counter's keys and the launch counts a replay carries;
the signature (``vit.graph_key``): none for a block split over a model
group, a new one for new parameter storage; CPU tensors never graphed.  The tests marked
``cuda`` hold the replayed forward bit-equal to the eager one at the
benchmark's three signatures, across successive calls, with clones kept
past the next call, and a capture while another thread copies from pinned
memory; run them there with
``python -m pytest --noconftest -m cuda tests/test_torch_vit_graphs.py``."""

import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.torch_support import card  # noqa: F401
from weclip_tpu_torch import kernels
from weclip_tpu_torch.core import precision
from weclip_tpu_torch.core.config import ClipConfig
from weclip_tpu_torch.models.clip import graphs, vit
from weclip_tpu_torch.parallel.mesh import Mesh
from weclip_tpu_torch.utils import spans

SHAPE = (2, 3, 4, 8)      # the launch key the stub forward counts


def forward(x, y):
    """A stand-in forward: two outputs and one counted launch."""
    kernels.count_launch("attention_fwd", SHAPE)
    return x * 2.0 + y, x.sum(0)


class StubCapture:
    """Captures by running ``fn`` once; a replay runs it again into the
    first outputs, its counts dropped (a graph's launches count only through
    what the capture held)."""

    def __init__(self, fail: bool = False):
        self.calls, self.fail = 0, fail

    def __call__(self, fn, inputs):
        self.calls += 1
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        outputs = fn(*inputs)

        def replay():
            with spans.hold_counts():
                fresh = fn(*inputs)
            for o, n in zip(outputs, fresh):
                o.copy_(n)

        return replay, outputs


def counter_totals(name):
    return dict(spans.RECORDER.totals.get(name, {}))


def launches_at(shape=SHAPE):
    return spans.RECORDER.totals.get(spans.LAUNCHES, {}).get(("attention_fwd", shape), 0)


def inputs(seed, n=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, 5), generator=g), torch.randn((n, 5), generator=g)


def test_eager_first_then_capture_then_replay():
    name = "test_graph_sequence"
    stub = StubCapture()
    cache = graphs.ForwardGraphs(name, capture=stub, allowed=lambda: True)
    seen = []
    for call in range(4):
        x, y = inputs(call)
        before = launches_at()
        out = cache.run(("sig",), forward, (x, y))
        want = forward(x, y)
        assert all(torch.equal(o, w) for o, w in zip(out, want))
        # every call counts the launches its forward makes, replays too
        assert launches_at() - before == 2
        seen.append(out)
    assert stub.calls == 1
    assert counter_totals(name) == {"eager": 1, "capture": 1, "replay": 2}
    assert cache.states() == [(("sig",), "graph")]
    # the capture and the replays hand out the graph's own tensors
    assert seen[1][0] is seen[2][0] is seen[3][0]
    assert seen[0][0] is not seen[1][0]


def test_outputs_hold_until_the_next_call_and_clones_survive_it():
    stub = StubCapture()
    cache = graphs.ForwardGraphs("test_graph_lifetime", capture=stub, allowed=lambda: True)
    for call in range(2):
        cache.run("sig", forward, inputs(call))
    first = cache.run("sig", forward, inputs(10))
    kept = [t.clone() for t in first]
    second = cache.run("sig", forward, inputs(11))
    want_first, want_second = forward(*inputs(10)), forward(*inputs(11))
    assert all(torch.equal(k, w) for k, w in zip(kept, want_first))
    # the first call's outputs now hold the second's
    assert all(torch.equal(o, w) for o, w in zip(first, want_second))
    assert all(torch.equal(o, w) for o, w in zip(second, want_second))


def test_no_key_and_a_profiler_stay_eager():
    name = "test_graph_eager"
    stub = StubCapture()
    cache = graphs.ForwardGraphs(name, capture=stub)
    for call in range(3):
        cache.run(None, forward, inputs(call))
    assert cache.states() == [] and stub.calls == 0
    cache.run("sig", forward, inputs(0))
    with profile(activities=[ProfilerActivity.CPU]):
        assert not graphs.capture_allowed()
        cache.run("sig", forward, inputs(1))
    assert stub.calls == 0 and cache.states() == [("sig", "seen")]
    cache.run("sig", forward, inputs(2))
    assert stub.calls == 1 and cache.states() == [("sig", "graph")]
    assert counter_totals(name) == {"eager": 5, "capture": 1}


def test_least_recently_used_signature_is_evicted():
    stub = StubCapture()
    cache = graphs.ForwardGraphs("test_graph_lru", size=2, capture=stub, allowed=lambda: True)
    for key in ("a", "a", "b", "b"):
        cache.run(key, forward, inputs(0))
    cache.run("a", forward, inputs(0))          # "a" most recent
    assert [k for k, _ in cache.states()] == ["b", "a"]
    cache.run("c", forward, inputs(0))           # evicts "b"
    assert cache.states() == [("a", "graph"), ("c", "seen")]
    cache.run("b", forward, inputs(0))           # "b" seen anew: eager, evicts "a"
    assert cache.states() == [("c", "seen"), ("b", "seen")]
    assert stub.calls == 2


def test_a_failed_capture_falls_back_to_eager_for_good():
    name = "test_graph_fallback"
    stub = StubCapture(fail=True)
    cache = graphs.ForwardGraphs(name, capture=stub, allowed=lambda: True)
    for call in range(4):
        before = launches_at()
        x, y = inputs(call)
        out = cache.run("sig", forward, (x, y))
        assert all(torch.equal(o, w) for o, w in zip(out, forward(x, y)))
        assert launches_at() - before == 2
    assert stub.calls == 1
    assert cache.states() == [("sig", "failed")]
    assert counter_totals(name) == {"eager": 1, "fallback": 3}


def test_replays_carry_the_captured_launches_into_the_open_record():
    r = spans.Recorder()
    with r.hold_counts() as held:
        r.count(spans.LAUNCHES, 3, key=("attention_fwd", SHAPE))
        with r.hold_counts() as inner:
            r.count(spans.LAUNCHES, 1, key=("attention_fwd_export", SHAPE))
        r.count("other")
    assert held == [(spans.LAUNCHES, 3, ("attention_fwd", SHAPE)), ("other", 1, None)]
    assert inner == [(spans.LAUNCHES, 1, ("attention_fwd_export", SHAPE))]
    assert r.open.counts == {} and r.totals == {}
    # a replay inside a span re-records them there
    stub = StubCapture()
    cache = graphs.ForwardGraphs("test_graph_record", capture=stub, allowed=lambda: True)
    for _ in range(2):
        cache.run("sig", forward, inputs(0))
    with spans.span("backbone"):
        before = spans.RECORDER.open.counts.get((spans.LAUNCHES, "backbone"), 0)
        cache.run("sig", forward, inputs(0))
        after = spans.RECORDER.open.counts.get((spans.LAUNCHES, "backbone"), 0)
    assert after - before == 1
    keyed = spans.RECORDER.open.keyed
    assert keyed.get(("test_graph_record", "replay"), 0) >= 1


def test_graph_key_tracks_the_inputs_and_the_parameters():
    cfg = ClipConfig(vision_width=32, vision_heads=2, vision_layers=3, patch_size=16)
    params = vit.init_vision_params(torch.Generator().manual_seed(0), cfg)
    ins = (torch.zeros((2, 3, 32, 32)), torch.zeros((2, 5, 32)),
           torch.ones((2, 5), dtype=torch.bool))
    pol = precision.DEFAULT
    args = (cfg, pol, True, 2)
    key = vit.graph_key(params, *ins, *args)
    assert key is not None and key == vit.graph_key(params, *ins, *args)
    # a block split over a model group runs eager
    split = dict(params, blocks=dict(params["blocks"], mlp=dict(
        params["blocks"]["mlp"], tp=Mesh(data=1, rank=0, model=2))))
    assert vit.graph_key(split, *ins, *args) is None
    # new parameter storage, another device, shape, map export or policy: a new key
    fresh = vit.tree_map(lambda t: t.clone(), params)
    assert vit.graph_key(fresh, *ins, *args) != key
    assert vit.graph_key(params, *(t.to("meta") for t in ins), *args) != key
    wide = tuple(torch.zeros((4,) + tuple(t.shape[1:]), dtype=t.dtype) for t in ins)
    assert vit.graph_key(params, *wide, *args) != key
    assert vit.graph_key(params, *ins, cfg, pol, True, 1) != key
    assert vit.graph_key(params, *ins, cfg, pol, False, 2) != key
    assert vit.graph_key(params, *ins, cfg, precision.FP32, True, 2) != key


def test_vision_forward_on_the_cpu_never_touches_the_graphs(monkeypatch):
    cfg = ClipConfig(vision_width=32, vision_heads=2, vision_layers=3, patch_size=16)
    params = vit.init_vision_params(torch.Generator().manual_seed(0), cfg)
    stub = StubCapture()
    cache = graphs.ForwardGraphs("test_graph_cpu", capture=stub, allowed=lambda: True)
    monkeypatch.setattr(vit, "FROZEN_GRAPHS", cache)
    img = torch.randn((2, 3, 32, 32), generator=torch.Generator().manual_seed(1))
    pe = vit.build_pos_emb(params, 2, 2).expand(2, 5, 32)
    valid = torch.ones((2, 5), dtype=torch.bool)
    outs = [vit.vision_forward_frozen(params, img, pe, valid, cfg, attn_rows=1)
            for _ in range(3)]
    want = vit._forward_frozen(params, img, pe, valid, cfg, precision.DEFAULT, True, 1)
    for out in outs:
        assert torch.equal(out.layer_tokens, want.layer_tokens)
        assert torch.equal(out.layer_attn, want.layer_attn)
    assert outs[0].layer_tokens is not outs[1].layer_tokens
    assert cache.states() == [] and counter_totals("test_graph_cpu") == {}


# -- on the card ------------------------------------------------------------

@pytest.fixture(scope="module")
def vitb16():
    """CLIP ViT-B/16 at its published widths, seeded, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = ClipConfig()
    return cfg, vit.init_vision_params(torch.Generator().manual_seed(0), cfg, "cuda")


def _card_inputs(cfg, b, side, valid_side, seed):
    """A batch at ``side`` pixels whose first ``valid_side`` x ``valid_side``
    patches (and CLS) are valid."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = side // cfg.patch_size
    img = torch.randn((b, 3, side, side), generator=g, device="cuda")
    pe = torch.randn((b, 1 + n * n, cfg.vision_width), generator=g, device="cuda") * 0.02
    grid = torch.zeros((b, n, n), dtype=torch.bool, device="cuda")
    grid[:, :valid_side, :valid_side] = True
    valid = torch.cat([torch.ones((b, 1), dtype=torch.bool, device="cuda"),
                       grid.reshape(b, -1)], dim=1)
    return img, pe, valid


# (batch, side, valid side, maps, attn_rows): training 4 x 401 tokens with
# maps; evaluation scale 1, 16 x 1025 with maps for the first 8 rows;
# scale 2, 16 x 626 without maps
SIGNATURES = [(4, 320, 20, True, None), (16, 512, 22, True, 8), (16, 400, 17, False, None)]


def _launch_totals():
    return dict(kernels.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("b,side,valid_side,with_attn,attn_rows", SIGNATURES)
def test_replay_is_bit_equal_to_eager_at_the_benchmark_signatures(
        card, vitb16, monkeypatch, b, side, valid_side, with_attn, attn_rows):
    cfg, params = vitb16
    name = f"test_graph_card_{b}_{side}"
    cache = graphs.ForwardGraphs(name)
    monkeypatch.setattr(vit, "FROZEN_GRAPHS", cache)
    pol = precision.make_policy("bfloat16")
    k = attn_rows if (with_attn and attn_rows is not None) else b
    kept = None
    for call in range(5):
        img, pe, valid = _card_inputs(cfg, b, side, valid_side, seed=call)
        before = _launch_totals()
        got = vit.vision_forward_frozen(params, img, pe, valid, cfg, policy=pol,
                                        with_attn=with_attn, attn_rows=attn_rows)
        launched = {n: kernels.launches[n] - before[n] for n in before}
        want = vit._forward_frozen(params, img, pe, valid, cfg, pol, with_attn, k)
        torch.cuda.synchronize()
        assert torch.equal(got.layer_tokens, want.layer_tokens), call
        assert torch.equal(got.layer_attn, want.layer_attn), call
        assert got.valid is valid
        # a replay counts the launches the eager forward makes
        after_want = {n: kernels.launches[n] - before[n] - launched[n] for n in before}
        assert launched == after_want, call
        if kept is not None:
            # the last call's clones hold; its own tensors now hold this call's
            assert torch.equal(kept[0], kept[2].layer_tokens)
            assert torch.equal(kept[1], kept[2].layer_attn)
            assert got.layer_tokens.data_ptr() == kept[3]
        kept = (got.layer_tokens.clone(), got.layer_attn.clone(), want,
                got.layer_tokens.data_ptr()) if call >= 2 else None
    assert counter_totals(name) == {"eager": 1, "capture": 1, "replay": 3}
    assert cache.states()[0][1] == "graph"


@pytest.mark.cuda
def test_capture_holds_while_another_thread_copies_from_pinned_memory(card, vitb16,
                                                                      monkeypatch):
    """The evaluation worker pins and copies on its own thread while the
    main thread runs scale 1: the capture neither fails nor is spoiled."""
    cfg, params = vitb16
    cache = graphs.ForwardGraphs("test_graph_worker")
    monkeypatch.setattr(vit, "FROZEN_GRAPHS", cache)
    pol = precision.make_policy("bfloat16")
    stop, copies, errors = threading.Event(), [0], []

    def worker():
        try:
            while not stop.is_set():
                host = torch.randn((8, 3, 512, 512)).pin_memory()
                dev = host.to("cuda", non_blocking=True)
                torch.cuda.current_stream().synchronize()
                assert torch.equal(dev.cpu(), host)
                copies[0] += 1
        except Exception as e:        # reported below
            errors.append(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        results = []
        for call in range(4):
            img, pe, valid = _card_inputs(cfg, 16, 512, 22, seed=call)
            got = vit.vision_forward_frozen(params, img, pe, valid, cfg, policy=pol,
                                            attn_rows=8)
            want = vit._forward_frozen(params, img, pe, valid, cfg, pol, True, 8)
            results.append(torch.equal(got.layer_tokens, want.layer_tokens)
                           and torch.equal(got.layer_attn, want.layer_attn))
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and not errors and copies[0] > 0
    assert all(results)
    assert counter_totals("test_graph_worker") == {"eager": 1, "capture": 1, "replay": 2}
