"""Device-idle time of a traced stretch, by the program's own spans.

A span stretch is a stretch of steps or requests profiled with the card's
activity alone (`trace.profiled`) inside a capture of the port's spans and
counters (``cdsegnet_torch.utils.tracing.capture``). A run that has one
holds it as ``run["span_trace"]`` (the `trace.Trace`), ``run["spans"]``
(the capture: ``spans`` with ``name``, ``thread``, ``start`` and ``end`` on
``time.time_ns()``, ``thread``, and ``under(counter, root)``) and
``run["span_stretch"]`` (``steps``: its steps or requests; ``base_ns``: the
trace's ``baseTimeNanoseconds``, which puts a span on the trace's ``ts``
axis). A run without one gives None.

Idle time is the complement, within the stretch, of the union of device
intervals (`trace.Trace.intervals`). Each instant of it belongs to the
innermost span open on the capture's thread at that instant, or to
`OUTSIDE` where none is open: exact attribution over the whole gap, not by
where it begins.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

OUTSIDE = "(outside)"


def pieces(spans: Sequence[Tuple[float, float, str]], start: float,
           end: float) -> List[Tuple[float, float, str]]:
    """``[start, end)`` cut into pieces ``(a, b, name)``, each named by the
    innermost of ``spans`` (nested intervals ``(a, b, name)`` of one thread)
    open over all of it: the one that began last."""
    cuts = sorted({start, end} | {min(max(t, start), end) for a, b, _ in spans for t in (a, b)})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        if b <= a:
            continue
        m = (a + b) / 2
        open_ = [s for s in spans if s[0] <= m < s[1]]
        name = max(open_, key=lambda s: (s[0], -s[1]))[2] if open_ else OUTSIDE
        if out and out[-1][2] == name and out[-1][1] == a:
            out[-1] = (out[-1][0], b, name)
        else:
            out.append((a, b, name))
    return out


def idle_gaps(intervals: Sequence[Tuple[float, float]], start: float,
              end: float) -> List[Tuple[float, float]]:
    """The complement of the (sorted, disjoint) device ``intervals`` in
    ``[start, end)``."""
    out, prev = [], start
    for a, b in list(intervals) + [(end, end)]:
        a, b = max(a, start), min(b, end)
        if a > prev:
            out.append((prev, a))
        prev = max(prev, b)
    return out


def idle_by_name(intervals, start: float, end: float,
                 spans: Sequence[Tuple[float, float, str]]) -> Dict[str, float]:
    """Idle microseconds of ``[start, end)`` by the innermost span open."""
    out: Dict[str, float] = defaultdict(float)
    cut = pieces(spans, start, end)
    i = 0
    for a, b in idle_gaps(intervals, start, end):
        while i < len(cut) and cut[i][1] <= a:
            i += 1
        j = i
        while j < len(cut) and cut[j][0] < b:
            lo, hi = max(a, cut[j][0]), min(b, cut[j][1])
            if hi > lo:
                out[cut[j][2]] += hi - lo
            j += 1
    return dict(out)


def on_axis(capture, base_ns: int) -> List[Tuple[float, float, str]]:
    """The capture's spans on its thread, in microseconds on the axis of a
    trace whose ``baseTimeNanoseconds`` is ``base_ns``."""
    return [((s.start - base_ns) / 1e3, (s.end - base_ns) / 1e3, s.name)
            for s in capture.spans if s.thread == capture.thread]


def idle_seconds(run) -> Optional[Dict[str, float]]:
    """Idle seconds of the span stretch by the innermost span open."""
    st = run.get("span_stretch")
    if not st:
        return None
    tr = run["span_trace"]
    us = idle_by_name(tr.intervals(), tr.start, tr.end, on_axis(run["spans"], st["base_ns"]))
    return {k: v / 1e6 for k, v in us.items()}


def idle_ms(run, name: str) -> Optional[float]:
    """Device-idle ms per step or request of the span stretch whose
    innermost open span is ``name``."""
    by = idle_seconds(run)
    return None if by is None else 1e3 * by.get(name, 0.0) / run["span_stretch"]["steps"]


def named_share(run, roots: Sequence[str]) -> Optional[float]:
    """The share (%) of the span stretch's idle time that falls under a
    named child span: not in a root's own time (``roots``), not outside."""
    by = idle_seconds(run)
    total = sum(by.values()) if by else 0.0
    if not total:
        return None
    return 100.0 * (1.0 - sum(by.get(k, 0.0) for k in (*roots, OUTSIDE)) / total)


def syncs_per(run, root: str) -> Optional[float]:
    """The capture's ``host_syncs`` made under spans named ``root``, per
    step or request of the span stretch."""
    st = run.get("span_stretch")
    if not st:
        return None
    return run["spans"].under("host_syncs", root) / st["steps"]
