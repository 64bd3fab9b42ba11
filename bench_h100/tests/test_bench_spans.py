"""`spans.py`'s arithmetic on a hand-made trace and span set, and the
program's own capture of the tests' cells on the CPU read through it."""

from __future__ import annotations

import types

import pytest
import torch

from bench_h100 import manifest, program, spans, traffic, weights
from bench_h100.loops import test_fragments
from bench_h100.tests import tiny
from bench_h100.trace import Trace
from cdsegnet_torch.utils import tracing

SEED = 2 ** 40 + 11


def _span(i, parent, name, a, b, thread=1):
    """A span of the port's kind, ``a``..``b`` in microseconds (base 0)."""
    return tracing.Span(i, 1, parent, name, thread, int(a * 1e3), int(b * 1e3))


def _kernel(ts, dur):
    return dict(ph="X", cat="kernel", name="k", ts=ts, dur=dur, args=dict(correlation=ts))


def hand_run():
    """One step from 100 to 1100 us; kernels at 100-200, 400-500, 900-1000."""
    trace = Trace([_kernel(100, 100), _kernel(400, 100), _kernel(900, 100)], wall=1000e-6)
    cap = types.SimpleNamespace(thread=1, spans=[
        _span(1, None, "train.step", 100, 1100),
        _span(2, 1, "train.forward", 150, 600),
        _span(3, 2, "geometry", 300, 450),
        _span(4, 1, "train.backward", 600, 950),
        _span(5, 1, "train.optimizer", 950, 1080),
        _span(6, None, "elsewhere", 0, 2000, thread=2),  # another thread: not read
    ], under=lambda counter, root: 3 if (counter, root) == ("host_syncs", "train.step") else 0)
    return dict(spans=cap, span_trace=trace, span_stretch=dict(steps=2, base_ns=0))


def test_idle_time_goes_to_the_innermost_span_at_each_instant():
    run = hand_run()
    assert spans.idle_seconds(run) == pytest.approx(dict(
        {"train.forward": 200e-6, "geometry": 100e-6, "train.backward": 300e-6,
         "train.optimizer": 80e-6, "train.step": 20e-6}))
    # per step of the two the stretch holds
    assert spans.idle_ms(run, "train.backward") == pytest.approx(0.15)
    assert spans.idle_ms(run, "geometry") == pytest.approx(0.05)
    assert spans.idle_ms(run, "infer.prepare") == 0.0
    assert spans.named_share(run, ["train.step"]) == pytest.approx(100 * (1 - 20 / 700))
    assert spans.syncs_per(run, "train.step") == 1.5
    # idle before the first span and after the last is outside any
    by = spans.idle_by_name([(10, 20)], 0, 40, [(5, 15, "a")])
    assert by == {spans.OUTSIDE: 25, "a": 5}
    for reader in (spans.idle_seconds, lambda r: spans.idle_ms(r, "geometry"),
                   lambda r: spans.named_share(r, ["train.step"]),
                   lambda r: spans.syncs_per(r, "train.step")):
        assert reader({"trace": run["span_trace"]}) is None  # no span stretch


def test_pieces_merge_and_nest():
    cut = spans.pieces([(0, 10, "r"), (2, 4, "c"), (4, 6, "d"), (6, 8, "c2"),
                        (6, 8, "r")], 0, 12)
    assert cut == [(0, 2, "r"), (2, 4, "c"), (4, 6, "d"), (6, 8, "c2"), (8, 10, "r"),
                   (10, 12, spans.OUTSIDE)]
    assert spans.idle_gaps([(1, 2), (2, 3), (5, 7)], 0, 8) == [(0, 1), (3, 5), (7, 8)]


def _no_device_run(cap, steps):
    """The capture's own window with no device interval in it: every
    instant idle (the CPU has no device trace)."""
    tr = types.SimpleNamespace(start=cap.start_ns / 1e3, end=cap.end_ns / 1e3,
                               intervals=lambda: [])
    return dict(spans=cap, span_trace=tr, span_stretch=dict(steps=steps, base_ns=0))


def _model(cell):
    cfg = cell["cfg"]
    R = manifest.reference(cfg)
    return program.build_model(cfg, weights.make(R.param_shapes(R.Arch(cfg["model"])),
                                                 traffic.derive(SEED, 10), "cpu"), "cpu")


@pytest.mark.parametrize("name", ["cdsegnet_scannet.train", "spunet_scannet.train"])
def test_the_programs_training_spans_read_through(name):
    cell = tiny.cell(name)
    cfg = cell["cfg"]
    mix, buckets = traffic.make(cell["traffic"], SEED)
    model = _model(cell)
    step, _ = program.train_step(cfg, model, traffic.derive(SEED, 30), "cpu")
    points = [program.to_point(b, cfg["serialization_depth"], mix["scenes_per_bucket"], "cpu")
              for b in buckets[:2]]
    step(points[0])
    with tracing.capture() as cap:
        for p in points:
            step(p)
    run = _no_device_run(cap, len(points))
    for span in ("geometry", "train.forward", "train.backward", "train.optimizer"):
        assert spans.idle_ms(run, span) > 0, span
    assert spans.named_share(run, ["train.step"]) > 85
    assert spans.syncs_per(run, "train.step") == 0  # counted on the card only


def test_the_programs_request_spans_read_through():
    cell = tiny.cell("cdsegnet_scannet.infer")
    frags = traffic.make(cell["traffic"], SEED)[1]
    tester = program.tester(cell["cfg"], _model(cell).eval(), "cpu")
    noise_fn = lambda i, bucket, c: test_fragments.noise(SEED, i, bucket, c, "cpu")
    tester.predict_fragment(frags[0], 0, noise_fn)
    with tracing.capture() as cap:
        for i in range(3):
            tester.predict_fragment(frags[i], i, noise_fn)
    run = _no_device_run(cap, 3)
    for span in ("infer.prepare", "geometry", "infer.forward"):
        assert spans.idle_ms(run, span) > 0, span
    assert spans.named_share(run, ["infer.request"]) > 85
    assert spans.syncs_per(run, "infer.request") == 0
    assert torch.is_tensor(tester.predict_fragment(frags[0], 0, noise_fn))
