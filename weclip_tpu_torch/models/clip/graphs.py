"""CUDA graphs of a gradient-free forward, one per input signature.

``ForwardGraphs.run(key, fn, inputs)`` serves one call of ``fn(*inputs)``,
where ``fn`` launches its work on the current stream, depends on nothing
but its input tensors and fixed state, and returns a tree of tensors
(``models/clip/vit.py::vision_forward_frozen`` is the caller).  Under a key:

- the first call runs ``fn`` as it is (``eager``): a shape seen once, such
  as an evaluation's ragged last batch, never pays for a capture, and the
  run warms every library the forward launches;
- the second captures ``fn`` over copies of the inputs into a CUDA graph,
  on a side stream in thread-local capture mode (CUDA calls of other
  threads, such as the evaluation worker's pinned copies, neither fail
  nor spoil it), then replays it (``capture``).  While a profiler records,
  or with sync debug mode on (``utils/spans.py`` counts synchronizations
  then), the call runs as it is and the capture waits for a later one;
- later calls copy their inputs into the graph's and replay it
  (``replay``), on the current stream;
- a capture that raises leaves the key eager for good (``fallback``).

``key=None`` runs ``fn`` as it is (``eager``).  A capture or a replay
returns the graph's own output tensors: they hold until the next call
under the same key, and a caller that keeps them longer clones them.
Counts the forward makes while it is captured (``kernels.count_launch``'s
``launches``) are held and recorded again at every replay, so they count
the launches the device runs.  Every call counts once under ``counter``,
keyed by how it was served.  ``size`` keys are kept (eager, graphed or
failed), the least recently used evicted with its graph.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Hashable, List, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _profiler

from weclip_tpu_torch.utils import spans

EAGER, CAPTURE, REPLAY, FALLBACK = "eager", "capture", "replay", "fallback"

# (fn, static inputs) -> (replay, outputs)
Capture = Callable[[Callable, Sequence[torch.Tensor]], Tuple[Callable[[], None], object]]


def capture_cuda(fn: Callable, inputs: Sequence[torch.Tensor]):
    """``fn(*inputs)`` captured into a CUDA graph on a side stream, in
    thread-local capture mode.  Returns (the graph's replay, its outputs);
    nothing has run on the device yet."""
    graph = torch.cuda.CUDAGraph()
    caller = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(caller)
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            outputs = fn(*inputs)
        finally:
            graph.capture_end()
    caller.wait_stream(side)
    return graph.replay, outputs


def capture_allowed() -> bool:
    """No profiler recording and sync debug mode off."""
    if _profiler._is_profiler_enabled:
        return False
    return not (torch.cuda.is_initialized() and torch.cuda.get_sync_debug_mode() != 0)


class _Graph:
    __slots__ = ("inputs", "replay", "outputs", "counts")

    def __init__(self, inputs, replay, outputs, counts):
        self.inputs, self.replay, self.outputs, self.counts = inputs, replay, outputs, counts


_SEEN, _FAILED = "seen", "failed"


class ForwardGraphs:
    """The graphs of one forward by key (module docstring)."""

    def __init__(self, counter: str, size: int = 4, capture: Capture = capture_cuda,
                 allowed: Callable[[], bool] = capture_allowed):
        self.counter, self.size = counter, size
        self._capture, self._allowed = capture, allowed
        self._entries: "OrderedDict[Hashable, object]" = OrderedDict()

    def run(self, key: Optional[Hashable], fn: Callable, inputs: Sequence[torch.Tensor]):
        if key is None:
            return self._eager(EAGER, fn, inputs)
        entry = self._entries.get(key)
        if entry is None:
            self._keep(key, _SEEN)
            return self._eager(EAGER, fn, inputs)
        self._entries.move_to_end(key)
        if entry is _FAILED:
            return self._eager(FALLBACK, fn, inputs)
        if entry is _SEEN:
            if not self._allowed():
                return self._eager(EAGER, fn, inputs)
            static = [t.clone() for t in inputs]
            try:
                with spans.hold_counts() as counts:
                    replay, outputs = self._capture(fn, static)
            except RuntimeError:
                self._entries[key] = _FAILED
                return self._eager(FALLBACK, fn, inputs)
            entry = self._entries[key] = _Graph(static, replay, outputs, counts)
            how = CAPTURE
        else:
            for s, t in zip(entry.inputs, inputs):
                s.copy_(t)
            how = REPLAY
        entry.replay()
        for name, n, k in entry.counts:
            spans.count(name, n, k)
        spans.count(self.counter, key=how)
        return entry.outputs

    def states(self) -> List[Tuple[Hashable, str]]:
        """(key, ``seen``, ``graph`` or ``failed``), least recently used first."""
        return [(k, v if isinstance(v, str) else "graph") for k, v in self._entries.items()]

    def _eager(self, how: str, fn: Callable, inputs: Sequence[torch.Tensor]):
        out = fn(*inputs)
        spans.count(self.counter, key=how)
        return out

    def _keep(self, key: Hashable, entry: object) -> None:
        self._entries[key] = entry
        while len(self._entries) > self.size:
            self._entries.popitem(last=False)
