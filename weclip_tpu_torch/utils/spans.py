"""Host-time spans and counters of the program, grouped by step.

One recorder serves the process (``RECORDER``; the module functions use
it).  It keeps a bounded ring of per-step records:

- ``span(name)`` times a stage on the host clock.  With no profiler
  recording it costs two ``time.perf_counter`` reads and an add into the
  open record.  While a ``torch.profiler`` records (the module flag
  ``torch.autograd.profiler._is_profiler_enabled``, read at entry), the span
  also enters ``record_function(name)``, so it sits on the profiler's own
  clock as a host event around the operations it covers; an annotation
  entered is always exited, even where the profiler stopped inside it.
- ``step(kind)`` is a span that closes the open record as a step of
  ``kind`` (``train.step``, ``eval.batch``) and opens the next.  It is not
  an annotation, so the stages inside it are the profiler's top-level host
  events.  Spans opened between two steps belong to the next one.
- ``count(name, n, key)`` adds to a counter of the open record, keyed by
  the innermost open span of the calling thread and, with ``key``, by that
  key too (kernel launches by kernel and shape).  ``kernels.launches`` is
  the by-kernel view of the ``launches`` counter's totals (``CounterView``).
  Inside ``hold_counts()`` the calling thread's counts go to a list instead
  (a CUDA graph's capture, whose launches count at each replay:
  ``models/clip/graphs.py``).
- While a profiler records, every host-device synchronization the program
  forces counts as ``sync`` (``torch.cuda.set_sync_debug_mode`` set to warn,
  its warnings caught), keyed by span and by the source line that forced it.
- ``span(name, device=True)`` (a caller whose work is on the card) also
  records a CUDA event pair on the current stream around the span: the
  device seconds between the two events, which include any gap in which
  the device waited for the host.  A pair is resolved only once its end
  event has completed (``query()``, which does not wait), at a later device
  span's exit or step close, and its seconds go to the record the span
  closed in, so timing a span forces no host sync.  Nothing is recorded
  while the current stream is being captured into a CUDA graph.

A record holds the step's kind and index, whether a profiler was seen
recording during it, the host clock at its close, host seconds by (span, parent) in total and self
(total less the spans nested in it), calls, device seconds and calls by
(span, parent) where the span was device-timed, and the counts.  The ring
holds ``RING`` records, more than a benchmark window's steps or batches.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import warnings
from collections import deque
from collections.abc import MutableMapping
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _profiler

RING = 4096
SYNC = "sync"
LAUNCHES = "launches"
# the warning torch gives for a synchronizing call in sync debug mode 1
SYNC_MESSAGE = "called a synchronizing CUDA operation"
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Record:
    """One step's spans and counts."""

    __slots__ = ("kind", "index", "profiled", "end_s", "spans", "device", "counts", "keyed")

    def __init__(self):
        self.kind: Optional[str] = None
        self.index = -1
        self.profiled = False
        self.end_s = 0.0            # the host clock when the step closed
        self.spans: Dict[Tuple[str, Optional[str]], List[float]] = {}  # -> [total, self, calls]
        self.device: Dict[Tuple[str, Optional[str]], List[float]] = {}  # -> [seconds, calls]
        self.counts: Dict[Tuple[str, Optional[str]], int] = {}        # (counter, span) -> n
        self.keyed: Dict[Tuple[str, object], int] = {}                # (counter, key) -> n

    def host_s(self, names: Iterable[str]) -> float:
        """Total host seconds of the spans named in ``names``."""
        names = set(names)
        return sum(v[0] for (n, _), v in self.spans.items() if n in names)

    def device_s(self, names: Iterable[str]) -> Optional[float]:
        """Device seconds of the device-timed spans named in ``names``; None
        where none of them was resolved into this record."""
        names = set(names)
        got = [v[0] for (n, _), v in self.device.items() if n in names]
        return sum(got) if got else None

    def count(self, counter: str) -> int:
        return sum(n for (c, _), n in self.counts.items() if c == counter)

    def to_json(self) -> dict:
        return {"kind": self.kind, "index": self.index, "profiled": self.profiled,
                "end_s": self.end_s,
                "spans": [{"name": n, "parent": p, "total_s": v[0], "self_s": v[1],
                           "calls": int(v[2])} for (n, p), v in self.spans.items()],
                "device": [{"name": n, "parent": p, "total_s": v[0], "calls": int(v[1])}
                           for (n, p), v in self.device.items()],
                "counts": [{"counter": c, "span": s, "n": n}
                           for (c, s), n in self.counts.items()],
                "keyed": [{"counter": c, "key": _key_text(k), "n": n}
                          for (c, k), n in self.keyed.items()]}


def _key_text(key) -> str:
    return " ".join(str(k) for k in key) if isinstance(key, tuple) else str(key)


class _Span:
    __slots__ = ("rec", "name", "annotate", "watch", "closes", "device", "parent", "child",
                 "rf", "ev", "t0")

    def __init__(self, recorder: "Recorder", name: str, annotate: bool, closes: bool,
                 device: bool = False):
        self.rec, self.name, self.annotate, self.closes = recorder, name, annotate, closes
        self.watch = annotate or closes
        self.device = device

    def __enter__(self):
        r = self.rec
        stack = r._stack()
        self.rf = None
        if self.watch:
            if _profiler._is_profiler_enabled:
                r._seen_profiler()
                if self.annotate:
                    self.rf = _profiler.record_function(self.name)
                    self.rf.__enter__()
            elif r._capturing:
                r._capture(False)
        self.parent = stack[-1] if stack else None
        self.child = 0.0
        stack.append(self)
        self.ev = r._device_start() if self.device else None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        r = self.rec
        r._stack().pop()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        parent = self.parent
        if parent is not None:
            parent.child += dur
        rec = r.open
        key = (self.name, None if parent is None else parent.name)
        v = rec.spans.get(key)
        if v is None:
            rec.spans[key] = [dur, dur - self.child, 1]
        else:
            v[0] += dur
            v[1] += dur - self.child
            v[2] += 1
        if self.ev is not None:
            r._device_end(rec, key, self.ev)
        if self.watch:
            r.notice()
        if self.closes:
            r._close(self.name)
        return False


class Recorder:
    """Spans, counters and the ring of step records (module docstring)."""

    def __init__(self, size: int = RING):
        self.records: deque = deque(maxlen=size)
        self.open = Record()
        self.closed = 0                     # records closed so far
        self.totals: Dict[str, Dict[object, int]] = {}   # counter -> key -> n
        self._next_index: Dict[str, int] = {}
        self._local = threading.local()
        self._capturing = False
        self._caught = None
        self._show = None
        self._sync_mode = None
        # device-timed spans whose end event has not completed:
        # (record, (span, parent), start event, end event), oldest first
        self._pending: List[tuple] = []

    def span(self, name: str, annotate: bool = True, device: bool = False) -> _Span:
        """A stage.  ``annotate=False``: a span of a thread other than the
        profiled one, which neither annotates nor watches the profiler.
        ``device=True``: the span's work is on the card, so its device time
        is recorded too (module docstring)."""
        return _Span(self, name, annotate, False, device)

    def step(self, kind: str) -> _Span:
        """The step boundary: closes the open record as a step of ``kind``."""
        return _Span(self, kind, False, True)

    def count(self, name: str, n: int = 1, key=None) -> None:
        held = getattr(self._local, "held", None)
        if held is not None:
            held.append((name, n, key))
            return
        stack = self._stack()
        rec = self.open
        k = (name, stack[-1].name if stack else None)
        rec.counts[k] = rec.counts.get(k, 0) + n
        if key is not None:
            k = (name, key)
            rec.keyed[k] = rec.keyed.get(k, 0) + n
            t = self.totals.setdefault(name, {})
            t[key] = t.get(key, 0) + n

    @contextlib.contextmanager
    def hold_counts(self):
        """The calling thread's counts inside, as a list of (name, n, key)
        in order, instead of recorded."""
        outer = getattr(self._local, "held", None)
        self._local.held = held = []
        try:
            yield held
        finally:
            self._local.held = outer

    def window(self, n: int) -> List[Record]:
        """The last ``n`` closed records, oldest first."""
        return list(self.records)[-n:] if n > 0 else []

    def since(self, closed: int) -> List[Record]:
        """The records closed after the first ``closed`` (those still in
        the ring)."""
        return self.window(min(self.closed - closed, len(self.records)))

    def resolve(self) -> None:
        """Move the device time of every pending pair whose end event has
        completed into the record its span closed in; waits for nothing."""
        still = []
        for rec, key, start, end in self._pending:
            if not end.query():
                still.append((rec, key, start, end))
                continue
            v = rec.device.get(key)
            if v is None:
                v = rec.device[key] = [0.0, 0]
            v[0] += 1e-3 * start.elapsed_time(end)
            v[1] += 1
        self._pending = still

    def notice(self) -> None:
        """Read the profiler's flag: mark the open record and start or stop
        counting synchronizations (every watching span does this at entry
        and exit; a caller that has just stopped a profiler may too)."""
        if _profiler._is_profiler_enabled:
            self._seen_profiler()
        elif self._capturing:
            self._capture(False)

    # -- internals ---------------------------------------------------------
    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _device_start(self) -> Optional["torch.cuda.Event"]:
        """The start event of a device-timed span, recorded on the current
        stream; None without a card in use or inside a graph's capture."""
        if not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _device_end(self, rec: Record, key: Tuple[str, Optional[str]],
                    start: "torch.cuda.Event") -> None:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self._pending.append((rec, key, start, end))
        self.resolve()

    def _close(self, kind: str) -> None:
        if self._pending:
            self.resolve()
        rec = self.open
        rec.kind = kind
        rec.end_s = time.perf_counter()
        rec.index = self._next_index.get(kind, 0)
        self._next_index[kind] = rec.index + 1
        self.records.append(rec)
        self.closed += 1
        self.open = Record()

    def _seen_profiler(self) -> None:
        self.open.profiled = True
        if not self._capturing:
            self._capture(True)

    def _capture(self, on: bool) -> None:
        """Count synchronizations (on) or stop (off): sync debug mode 1 on a
        card in use, its warnings shown always and caught here."""
        self._capturing = on
        cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        if on:
            self._caught = warnings.catch_warnings()
            self._caught.__enter__()
            warnings.filterwarnings("always", message=SYNC_MESSAGE, category=UserWarning)
            warnings.filterwarnings("ignore", message="Synchronization debug mode is a "
                                    "prototype", category=UserWarning)
            self._show = warnings.showwarning
            warnings.showwarning = self._on_warning
            if cuda:
                self._sync_mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode(1)
        else:
            if cuda and self._sync_mode is not None:
                torch.cuda.set_sync_debug_mode(self._sync_mode)
            self._sync_mode = None
            self._caught.__exit__(None, None, None)
            self._caught = self._show = None

    def _on_warning(self, message, category, filename, lineno, file=None, line=None):
        if SYNC_MESSAGE in str(message):
            self.open.profiled = True
            path = os.path.abspath(filename)
            if path.startswith(_PACKAGE + os.sep):
                path = os.path.relpath(path, _PACKAGE)
            self.count(SYNC, key=f"{path}:{lineno}")
            return
        self._show(message, category, filename, lineno, file, line)


class CounterView(MutableMapping):
    """One counter's totals by the first element of its keys, over a fixed
    set of names (``kernels.launches``: launches by kernel).  Setting a
    name's value replaces its totals of every shape by one entry."""

    def __init__(self, recorder: Recorder, counter: str, names: Sequence[str]):
        self._rec, self._counter, self._names = recorder, counter, tuple(names)

    def _totals(self) -> Dict[object, int]:
        return self._rec.totals.setdefault(self._counter, {})

    def __getitem__(self, name: str) -> int:
        if name not in self._names:
            raise KeyError(name)
        return sum(n for k, n in self._totals().items() if k[0] == name)

    def __setitem__(self, name: str, value: int) -> None:
        if name not in self._names:
            raise KeyError(name)
        t = self._totals()
        for k in [k for k in t if k[0] == name]:
            del t[k]
        if value:
            t[(name, None)] = value

    def __delitem__(self, name: str) -> None:
        raise TypeError(f"the {self._counter} counter's names are fixed")

    def __contains__(self, name) -> bool:
        return name in self._names

    def __iter__(self):
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def __repr__(self) -> str:
        return repr(dict(self))


RECORDER = Recorder()


def span(name: str, annotate: bool = True, device: bool = False) -> _Span:
    return RECORDER.span(name, annotate, device)


def step(kind: str) -> _Span:
    return RECORDER.step(kind)


def count(name: str, n: int = 1, key=None) -> None:
    RECORDER.count(name, n, key)


def hold_counts():
    return RECORDER.hold_counts()


def window(n: int) -> List[Record]:
    return RECORDER.window(n)


def before_profiled(records: Sequence[Record]) -> List[Record]:
    """The records before the first one a profiler was seen in."""
    out = []
    for r in records:
        if r.profiled:
            break
        out.append(r)
    return out


def profiled(records: Sequence[Record]) -> List[Record]:
    return [r for r in records if r.profiled]
