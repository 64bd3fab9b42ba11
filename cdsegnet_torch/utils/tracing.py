"""Spans and counters at the port's layer boundaries, kept in memory.

Tracing is off unless a `capture` is open. Off, `span(name)` returns one
shared object whose ``with`` does nothing, and `count` returns at once:
each costs one read of a module global. On, a span records its id, the id
of its root (the outermost span it runs under: one training step, one
request, one trainer iteration), its parent's id (the innermost span open
on the same thread when it began), its name, its thread and its start and
end; a count adds to a named counter and remembers the innermost span open
at the time. Nothing is written until the caller asks (`Capture.write`).

The clock is ``time.time_ns()``, which is the clock of a `torch.profiler`
trace: an exported Chrome trace's ``ts`` (microseconds) plus its
``baseTimeNanoseconds`` is ``time.time_ns()``, so ``(t - base) / 1e3`` puts
a span on that trace's axis (`Capture.events`).

On a process that has started CUDA, a capture also counts ``host_syncs``:
it sets ``torch.cuda.set_sync_debug_mode("warn")`` and counts each
synchronizing call's warning (``.item()``, ``.tolist()``, a copy from the
card or a pageable one to it, ``nonzero``, a boolean mask, a stream's
``synchronize()``) under the innermost open span, or `OUTSIDE` when none is
open. ``torch.cuda.synchronize()`` (the device's) gives no warning and is
not counted. The mode, the warning filters and ``warnings.showwarning`` are
restored when it ends.

Spans of the port (the layer each belongs to is in ``PERF.md`` §3):
``train.step`` > ``train.forward`` (> ``geometry``), ``train.backward``,
``train.optimizer`` in `engine.state.make_train_step`; ``infer.request`` >
``infer.prepare``, ``infer.forward`` (> ``geometry``) in
`engine.test.SemSegTester.predict_fragment`; ``geometry`` in
`models.pyramid.build_pyramid`; ``trainer.iteration`` >
``trainer.data_wait``, ``trainer.to_device``, ``trainer.metrics`` in
`engine.train.Trainer.train`. Counters: ``host_syncs``,
``pyramid.dropped_l<i>`` (valid points lost to overflow at pooled level
i), ``pyramid.sorted_build`` (the ``cond`` pyramid fell back to the sorted
neighbour tables).

    with tracing.capture() as cap:
        step(point)
    cap.write("spans.json")
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import re
import threading
import time
import warnings
from typing import Dict, List, NamedTuple, Optional

import torch

SYNCS = "host_syncs"
OUTSIDE = "(outside)"
_SYNC_WARNING = re.compile(r".*synchronizing CUDA operation", re.I)


class Span(NamedTuple):
    id: int
    root_id: int
    parent_id: Optional[int]
    name: str
    thread: int
    start: int  # ns, time.time_ns()
    end: int


class _Off:
    """The span of tracing off: its ``with`` does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()
_capture: Optional["Capture"] = None


def span(name: str):
    """A context manager that records the block as span ``name`` while a
    capture is open, and the shared no-op `OFF` otherwise."""
    cap = _capture
    return OFF if cap is None else _Open(cap, name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a capture is open."""
    cap = _capture
    if cap is not None:
        cap._count(name, n)


def enabled() -> bool:
    """Whether a capture is open (for callers that would build a counter's
    name or value only to count it)."""
    return _capture is not None


class _Open:
    __slots__ = ("cap", "name", "id", "root_id", "parent_id", "thread", "start")

    def __init__(self, cap: "Capture", name: str):
        self.cap, self.name = cap, name

    def __enter__(self):
        self.thread = threading.get_ident()
        stack = self.cap._stacks.setdefault(self.thread, [])
        parent = stack[-1] if stack else None
        self.id = next(self.cap._ids)
        self.parent_id = parent.id if parent else None
        self.root_id = parent.root_id if parent else self.id
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        stack = self.cap._stacks.get(self.thread)
        if stack and stack[-1] is self:
            stack.pop()
            self.cap._record(self, end)
        return False


def _launches() -> Dict[str, int]:
    from cdsegnet_torch.ops import flash_attention as fa

    return dict(fwd=fa.patch_attention_fwd.launches,
                fwd_lse=fa.patch_attention_fwd.lse_launches,
                dq=fa.patch_attention_bwd_dq.launches,
                dkdv=fa.patch_attention_bwd_dkdv.launches)


class Capture:
    """What one `capture` recorded: ``spans`` (`Span`, by start),
    ``counters`` (totals by name), ``counts`` (each increment as ``(time,
    name, span id or None, n)``), ``launches`` (the attention kernels
    launched meanwhile: ``fwd``, ``fwd_lse``, ``dq``, ``dkdv``),
    ``thread`` (the thread that opened it) and ``start_ns``/``end_ns``."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = collections.Counter()
        self.counts: List[tuple] = []
        self.launches: Dict[str, int] = {}
        self._ids = itertools.count(1)
        self._stacks: Dict[int, list] = {}
        self._open = False
        self._syncs = None

    # -- lifetime --------------------------------------------------------

    def start(self) -> "Capture":
        global _capture
        if _capture is not None:
            raise RuntimeError("a capture is already open")
        self.thread = threading.get_ident()
        self._launch0 = _launches()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            self._watch_syncs()
        self._open = True
        self.start_ns = time.time_ns()
        _capture = self
        return self

    def stop(self) -> "Capture":
        """End the capture; spans still open end here."""
        global _capture
        if _capture is not self:
            return self
        _capture = None
        self.end_ns = time.time_ns()
        for stack in self._stacks.values():
            for s in stack:
                self._record(s, self.end_ns)
            stack.clear()
        self._open = False
        if self._syncs is not None:
            mode, guard = self._syncs
            torch.cuda.set_sync_debug_mode(mode)
            guard.__exit__(None, None, None)
            self._syncs = None
        after = _launches()
        self.launches = {k: after[k] - self._launch0[k] for k in after}
        self.spans.sort(key=lambda s: (s.start, s.id))
        return self

    def __enter__(self) -> "Capture":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def _watch_syncs(self) -> None:
        guard = warnings.catch_warnings()
        guard.__enter__()
        warnings.filterwarnings("always", message=_SYNC_WARNING.pattern)
        # setting the mode warns once per process that it is a prototype
        warnings.filterwarnings("ignore", message="Synchronization debug mode")
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if _SYNC_WARNING.match(str(message)):
                self._count(SYNCS, 1)
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        self._syncs = (torch.cuda.get_sync_debug_mode(), guard)
        torch.cuda.set_sync_debug_mode("warn")

    # -- recording -------------------------------------------------------

    def _record(self, s: _Open, end: int) -> None:
        if self._open:
            self.spans.append(Span(s.id, s.root_id, s.parent_id, s.name, s.thread,
                                   s.start, end))

    def _count(self, name: str, n: int) -> None:
        stack = self._stacks.get(threading.get_ident())
        self.counters[name] += n
        self.counts.append((time.time_ns(), name, stack[-1].id if stack else None, n))

    # -- reading ---------------------------------------------------------

    def by_id(self) -> Dict[int, Span]:
        return {s.id: s for s in self.spans}

    def children(self, s: Span) -> List[Span]:
        return [c for c in self.spans if c.parent_id == s.id]

    def self_ns(self, s: Span) -> int:
        """``s``'s duration less the part of it its child spans cover."""
        covered, reach = 0, s.start
        for c in sorted(self.children(s), key=lambda c: c.start):
            a, b = max(c.start, reach), min(c.end, s.end)
            if b > a:
                covered += b - a
                reach = b
        return (s.end - s.start) - covered

    def counted_by_span(self, name: str) -> Dict[str, int]:
        """Counter ``name`` by the innermost span open at each increment
        (`OUTSIDE` where none was)."""
        spans = self.by_id()
        out: Dict[str, int] = collections.Counter()
        for _, key, sid, n in self.counts:
            if key == name:
                out[spans[sid].name if sid in spans else OUTSIDE] += n
        return dict(out)

    def under(self, name: str, root: str) -> int:
        """Counter ``name`` summed over increments made inside a span named
        ``root`` (the span itself or any span beneath it)."""
        spans = self.by_id()

        def inside(sid):
            while sid is not None and sid in spans:
                if spans[sid].name == root:
                    return True
                sid = spans[sid].parent_id
            return False

        return sum(n for _, key, sid, n in self.counts if key == name and inside(sid))

    # -- writing ---------------------------------------------------------

    def events(self, base_ns: int) -> List[Dict]:
        """The capture as Chrome-trace events on the axis of a trace whose
        ``baseTimeNanoseconds`` is ``base_ns``: each span an ``X`` event
        (``cat`` "span") on a track ``spans <thread>`` of this process,
        each counter a ``C`` event of its running total."""
        pid = os.getpid()
        us = lambda t: (t - base_ns) / 1e3
        out = [dict(ph="X", cat="span", name=s.name, pid=pid, tid=f"spans {s.thread}",
                    ts=us(s.start), dur=(s.end - s.start) / 1e3,
                    args=dict(id=s.id, root_id=s.root_id, parent_id=s.parent_id))
               for s in self.spans]
        total: Dict[str, int] = collections.Counter()
        for t, name, _, n in sorted(self.counts, key=lambda c: c[0]):
            total[name] += n
            out.append(dict(ph="C", cat="span", name=name, pid=pid, ts=us(t),
                            args={name: total[name]}))
        return out

    def write(self, path: str, base_ns: Optional[int] = None) -> None:
        """Write the capture as a Chrome trace (JSON) at ``path``, on the
        axis of ``base_ns`` (by default the capture's start)."""
        base = self.start_ns if base_ns is None else base_ns
        with open(path, "w") as f:
            json.dump(dict(traceEvents=self.events(base), baseTimeNanoseconds=base,
                           counters=dict(self.counters), launches=self.launches), f)


def capture() -> Capture:
    """A `Capture` to use as a context manager (``with capture() as cap``),
    or to `Capture.start` and `Capture.stop` by hand."""
    return Capture()
