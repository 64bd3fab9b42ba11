"""The traced stretch: `torch.profiler` over a fixed number of steps or
requests at the end of a run's window, read back from its Chrome trace.

`Trace` holds the device operations (kernels, copies, sets) on the shared
timeline, the host operators and each kernel's launch time, clipped to the
stretch: the wall time of the ``bench_stretch`` range, which ends after a
synchronize. Busy time is the union of device intervals; the idle gaps are
named by the innermost host operator that was running where each begins.
`FAMILIES` sorts kernels by name into the families of the port's profile
tables.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

STRETCH = "bench_stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
FAMILIES = (
    ("attention kernel", ("patch_attention_fwd",)),
    ("topk", ("TopK", "topk", "KthValue", "radixFind", "computeBlockwise")),
    ("attention backward kernels", ("patch_attention_bwd",)),
    ("sort", ("sort", "Sort", "radix", "Radix")),
    ("matmul", ("gemm", "Gemm", "cutlass", "sm90_xmma", "cublas", "nvjet")),
    ("gather/scatter", ("index", "Index", "gather", "Gather", "scatter", "Scatter")),
    ("reduce", ("reduce", "Reduce")),
)


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "elementwise/other"


@contextlib.contextmanager
def profiled(device="cuda", host: bool = False):
    """Profile the block; yields a holder whose ``trace`` is the parsed
    `Trace` after it. Without ``host`` only the card's activity is traced,
    which costs the host little, and the stretch is the block's wall time
    between two synchronizes; with ``host`` the host's operators are traced
    too (they slow its launches) and the stretch is a marked range."""
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = type("Holder", (), {})()
    cuda = torch.device(device).type == "cuda"
    acts = ([ProfilerActivity.CUDA] if cuda else []) + ([ProfilerActivity.CPU] if host or not cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        with record_function(STRETCH) if host else contextlib.nullcontext():
            yield holder
            sync()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder.trace = Trace(json.load(f)["traceEvents"], None if host else wall)
    finally:
        os.remove(path)


class Trace:
    def __init__(self, events: List[Dict], wall: Optional[float] = None):
        """``wall``: the stretch's seconds when no range marks it; every
        device operation of the trace then belongs to it."""
        device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        marks = [e for e in events if e.get("name") == STRETCH and e.get("ph") == "X"
                 and e.get("cat") in ("user_annotation", "cpu_op")]
        if marks:
            mark = marks[0]
            self.start, self.end = float(mark["ts"]), float(mark["ts"]) + float(mark["dur"])
        elif wall is not None:
            first = min((float(e["ts"]) for e in device), default=0.0)
            self.start, self.end = first, first + wall * 1e6
        else:
            raise RuntimeError("the trace has no stretch range")
        inside = lambda e: self.start <= float(e["ts"]) < self.end
        self.device = sorted(
            ((e["name"], float(e["ts"]), float(e.get("dur", 0.0)), e.get("cat"),
              (e.get("args") or {}).get("correlation"))
             for e in device if inside(e)),
            key=lambda k: k[1])
        self.launch_ts = {(e.get("args") or {}).get("correlation"): float(e["ts"])
                          for e in events if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"}
        # every host thread's operators: the backward runs on autograd's own
        self.host_ops = sorted(((e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
                                for e in events if e.get("ph") == "X"
                                and e.get("cat") in ("cpu_op", "user_annotation")
                                and e["name"] != STRETCH),
                               key=lambda o: o[1])
        self._host_starts = [ts for _, ts, _ in self.host_ops]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def intervals(self) -> List[Tuple[float, float]]:
        """The union of device intervals within the stretch, in order."""
        out: List[List[float]] = []
        for _, ts, dur, _, _ in self.device:
            a, b = max(ts, self.start), min(ts + dur, self.end)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals()) / 1e6

    def kernel_seconds(self, match) -> Tuple[float, int]:
        """Summed device seconds and count of kernels whose name ``match``
        accepts."""
        hit = [dur for name, _, dur, cat, _ in self.device if cat == "kernel" and match(name)]
        return sum(hit) / 1e6, len(hit)

    def family_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, _, dur, cat, _ in self.device:
            out[family(name) if cat == "kernel" else cat] += dur / 1e6
        return dict(out)

    def seconds_under(self, host_name_prefix: str) -> Optional[float]:
        """Device seconds of the operations launched while a host range whose
        name starts with ``host_name_prefix`` ran; None without such a range."""
        ranges = sorted((ts, ts + dur) for name, ts, dur in self.host_ops
                        if name.startswith(host_name_prefix))
        if not ranges:
            return None
        starts = [a for a, _ in ranges]
        total = 0.0
        for _, _, dur, _, corr in self.device:
            t = self.launch_ts.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ranges[i][1]:
                total += dur
        return total / 1e6

    def host_op_at(self, t: float) -> str:
        """The innermost host operator running at time ``t``: of the ranges
        that hold it, the one that began last."""
        i = bisect.bisect_right(self._host_starts, t) - 1
        for name, ts, dur in reversed(self.host_ops[max(i - 5000, 0):i + 1]):
            if t < ts + dur:
                return name
        return "host (no operator)"

    def device_ops(self, top: int = 10) -> List:
        """The device operations that took the most time, by name."""
        ops: Dict[str, float] = defaultdict(float)
        for name, _, dur, _, _ in self.device:
            ops[name[:160]] += dur / 1e6
        return _rank(ops, top)

    def idle_gaps(self, top: int = 10) -> List:
        """Idle device time, summed by the host operator running where each
        gap begins."""
        gaps: Dict[str, float] = defaultdict(float)
        prev = self.start
        for a, b in self.intervals() + [(self.end, self.end)]:
            if a > prev:
                gaps[self.host_op_at(prev)] += (a - prev) / 1e6
            prev = max(prev, b)
        return _rank(gaps, top)


def _rank(d: Dict[str, float], top: int) -> List:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
