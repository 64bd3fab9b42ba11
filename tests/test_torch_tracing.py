"""`cdsegnet_torch.utils.tracing`: spans and counters off and on, their
nesting and self time, the spans of the training step and of the tester's
request on the tiny model, the clock against `torch.profiler`'s exported
trace, and the written Chrome trace. The tests marked ``cuda`` count host
syncs and place a span over its kernels on the card. No JAX here: the
card's machine has none."""

from __future__ import annotations

import json
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from cdsegnet_torch.engine.optimizer import build_optimizer
from cdsegnet_torch.engine.state import make_train_step
from cdsegnet_torch.engine.test import SemSegTester
from cdsegnet_torch.models.builder import build_model, build_model_criteria
from cdsegnet_torch.utils import tracing
from cdsegnet_torch.utils.synthetic import synthetic_arrays, synthetic_point_batch

BACKBONE = dict(
    type="PT-v3m1", c_in_channels=6, n_in_channels=6,
    order=("z", "z-trans", "hilbert", "hilbert-trans"), c_stride=(4, 4),
    c_enc_depths=(1, 1, 1), c_enc_channels=(8, 16, 16), c_enc_num_head=(1, 2, 2),
    c_enc_patch_size=(64, 64, 64), c_dec_depths=(1, 1), c_dec_channels=(8, 8),
    c_dec_num_head=(1, 1), c_dec_patch_size=(64, 64), n_stride=(2, 2, 2, 2),
    n_enc_depths=(1, 1, 1, 1, 1), n_enc_channels=(8, 16, 16, 16, 16),
    n_enc_num_head=(1, 2, 2, 2, 2), n_enc_patch_size=(64, 64, 64, 64, 64),
    n_dec_depths=(1, 1, 1, 1), n_dec_channels=(8, 8, 16, 16), n_dec_num_head=(1, 1, 2, 2),
    n_dec_patch_size=(64, 64, 64, 64), mlp_ratio=2, drop_path=0.1, num_classes=5, T_dim=16,
    condition=True, skip_connection_mode="cat", skip_connection_scale=True,
    capacity_div=(1, 2, 4, 8, 8))
MODEL = dict(
    type="DefaultSegmentorV2", backbone=BACKBONE,
    criteria=[dict(type="MSELoss", loss_weight=1.0),
              dict(type="CrossEntropyLoss", loss_weight=1.0),
              dict(type="LovaszLoss", loss_weight=1.0)],
    loss_type="GLS", task_num=2, num_classes=5, T=20, beta_start=0, beta_end=1000,
    noise_schedule="cosine", T_dim=16, dm=True, dm_input="xt", dm_target="noise",
    condition=True, c_in_channels=6)
DEPTH = 7


def names(cap, **where):
    return [s.name for s in cap.spans
            if all(getattr(s, k) == v for k, v in where.items())]


def test_off_records_nothing_and_returns_the_shared_no_op():
    assert not tracing.enabled()
    assert tracing.span("a") is tracing.OFF and tracing.span("b") is tracing.OFF
    with tracing.span("a") as got:
        tracing.count("n", 3)
    assert got is None
    with tracing.capture() as cap:
        assert tracing.enabled() and tracing.span("a") is not tracing.OFF
    assert tracing.span("a") is tracing.OFF and not tracing.enabled()
    with tracing.span("late"):
        tracing.count("late")
    assert cap.spans == [] and dict(cap.counters) == {}


def test_nesting_ids_roots_counters_and_self_time():
    def other():
        with tracing.span("other"):
            time.sleep(0.002)

    with tracing.capture() as cap:
        tracing.count("n")
        with tracing.span("root"):
            time.sleep(0.002)
            with tracing.span("a"):
                time.sleep(0.003)
                with tracing.span("a.inner"):
                    tracing.count("n", 2)
                    time.sleep(0.001)
            t = threading.Thread(target=other)
            t.start()
            t.join(5)
            with tracing.span("b"):
                tracing.count("n", 4)
                time.sleep(0.002)
        with tracing.span("second"):
            pass
        with tracing.span("left open"):
            cap.stop()
    assert not t.is_alive()
    by = {s.name: s for s in cap.spans}
    assert [s.name for s in cap.spans] == ["root", "a", "a.inner", "other", "b", "second",
                                          "left open"]
    root, a, inner, b = by["root"], by["a"], by["a.inner"], by["b"]
    assert root.parent_id is None and root.root_id == root.id
    assert a.parent_id == root.id and b.parent_id == root.id
    assert inner.parent_id == a.id
    assert {s.root_id for s in (a, inner, b)} == {root.id}
    # another thread's spans hang from its own stack
    assert by["other"].parent_id is None and by["other"].thread != root.thread
    assert by["second"].root_id == by["second"].id != root.id
    assert by["left open"].end == cap.end_ns
    assert all(s.start <= c.start and c.end <= s.end for s, c in ((root, a), (a, inner),
                                                                   (root, b)))
    assert cap.children(root) == [a, b]
    assert cap.self_ns(root) == (root.end - root.start) - (a.end - a.start) - (b.end - b.start)
    assert cap.self_ns(a) == (a.end - a.start) - (inner.end - inner.start)
    assert cap.self_ns(inner) == inner.end - inner.start
    assert dict(cap.counters) == {"n": 7}
    assert cap.counted_by_span("n") == {tracing.OUTSIDE: 1, "a.inner": 2, "b": 4}
    assert cap.under("n", "root") == 6 and cap.under("n", "a") == 2
    assert cap.launches == dict(fwd=0, fwd_lse=0, dq=0, dkdv=0)


def test_a_second_capture_cannot_open_inside_the_first():
    with tracing.capture():
        with pytest.raises(RuntimeError):
            tracing.capture().start()
    assert not tracing.enabled()


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return build_model(dict(MODEL), device="cpu")


def test_one_training_step_gives_its_spans_in_order(model):
    opt = build_optimizer(dict(type="AdamW", lr=1e-3, weight_decay=0.01), model,
                          dict(type="OneCycleLR", pct_start=0.3), total_steps=10,
                          param_dicts=[dict(keyword="block", lr=1e-4)], device="cpu")
    step = make_train_step(model, build_model_criteria(MODEL), opt, seed=0, device="cpu")
    point = synthetic_point_batch(1024, 2, DEPTH, seed=1, device="cpu")
    with tracing.capture() as cap:
        out = step(point)
    assert names(cap) == ["train.step", "train.forward", "geometry", "train.backward",
                          "train.optimizer"]
    by = {s.name: s for s in cap.spans}
    top = by["train.step"]
    assert [c.name for c in cap.children(top)] == ["train.forward", "train.backward",
                                                  "train.optimizer"]
    assert by["geometry"].parent_id == by["train.forward"].id
    assert {s.root_id for s in cap.spans} == {top.id}
    drops = {k: v for k, v in cap.counters.items() if k.startswith("pyramid.dropped_l")}
    assert drops == {f"pyramid.dropped_l{i}": int(out[f"dropped_l{i}"]) for i in range(1, 5)}
    assert cap.counted_by_span("pyramid.dropped_l1") == {"geometry": drops["pyramid.dropped_l1"]}
    assert cap.counters.get("pyramid.sorted_build", 0) == int(sum(drops.values()) > 0)
    assert tracing.SYNCS not in cap.counters  # counted on a card only
    with tracing.span("x"):  # and off again
        pass
    assert step.generators and len(cap.spans) == 5


def test_a_request_gives_prepare_then_forward_with_its_geometry(model):
    a = synthetic_arrays(1024, 1, DEPTH, seed=2)
    n = int(a["mask"].sum())
    frag = dict(coord=a["coord"][:n].astype(np.float32), feat=a["feat"][:n],
                grid_coord=a["grid_coord"][:n].astype(np.int32))
    tester = SemSegTester(dict(num_devices=1, serialization_depth=DEPTH, seed=0,
                               save_path=".", test_buckets=(1024, 2048)),
                          model=model, device="cpu", verbose=False)
    with tracing.capture() as cap:
        probs = tester.predict_fragment(frag, 0)
    assert probs.shape == (n, 5)
    assert names(cap) == ["infer.request", "infer.prepare", "infer.forward", "geometry"]
    by = {s.name: s for s in cap.spans}
    assert by["infer.prepare"].parent_id == by["infer.request"].id
    assert by["infer.forward"].parent_id == by["infer.request"].id
    assert by["geometry"].parent_id == by["infer.forward"].id


def test_spans_sit_on_the_profiler_traces_clock(tmp_path):
    """A `record_function` opened inside a span lies inside it on the
    exported trace's ``ts`` axis, within 1 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.capture() as cap:
            for _ in range(3):
                with tracing.span("outer"):
                    time.sleep(0.002)
                    with record_function("probe"):
                        torch.randn(200, 200) @ torch.randn(200, 200)
                    time.sleep(0.002)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    base = data["baseTimeNanoseconds"]
    probes = sorted((e["ts"], e["ts"] + e["dur"]) for e in data["traceEvents"]
                    if e.get("name") == "probe" and e.get("ph") == "X")
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in cap.events(base) if e["ph"] == "X"]
    assert len(probes) == len(spans) == 3
    for (a, b), (sa, sb) in zip(probes, spans):
        assert sa - 1000 <= a and b <= sb + 1000, (a, b, sa, sb)
        # the gaps of 2 ms on each side are there: not merely within 1 ms
        assert a - sa > 1000 and sb - b > 1000, (a, b, sa, sb)


def test_write_gives_a_chrome_trace(tmp_path):
    with tracing.capture() as cap:
        with tracing.span("a"):
            tracing.count("c", 2)
            with tracing.span("b"):
                tracing.count("c")
    path = str(tmp_path / "spans.json")
    cap.write(path)
    with open(path) as f:
        data = json.load(f)
    assert data["baseTimeNanoseconds"] == cap.start_ns
    assert data["counters"] == {"c": 3} and set(data["launches"]) == {"fwd", "fwd_lse", "dq",
                                                                       "dkdv"}
    xs = [e for e in data["traceEvents"] if e["ph"] == "X"]
    cs = [e for e in data["traceEvents"] if e["ph"] == "C"]
    assert [e["name"] for e in xs] == ["a", "b"]
    for e in xs:
        assert {"name", "ph", "ts", "dur", "pid", "tid", "cat", "args"} <= set(e)
        assert e["ts"] >= 0 and e["dur"] >= 0 and e["tid"].startswith("spans ")
    assert xs[1]["args"]["parent_id"] == xs[0]["args"]["id"]
    assert xs[0]["ts"] <= xs[1]["ts"] and xs[1]["ts"] + xs[1]["dur"] <= xs[0]["ts"] + xs[0]["dur"]
    assert [e["args"]["c"] for e in cs] == [2, 3]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_one_item_counts_one_host_sync_under_its_span(card):
    x = torch.arange(1000, device=card, dtype=torch.float32)
    torch.cuda.synchronize()
    before = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with tracing.capture() as cap:
            y = x * 2
            with tracing.span("probe"):
                v = y.sum().item()
            z = y + 1  # launches, no sync
    assert v == 999000.0 and z.shape == x.shape
    assert cap.counted_by_span(tracing.SYNCS) == {"probe": 1}
    assert cap.under(tracing.SYNCS, "probe") == 1
    assert torch.cuda.get_sync_debug_mode() == before
    leaked = [str(w.message) for w in shown if "ynchroniz" in str(w.message)]
    assert not leaked, leaked
    with tracing.capture() as cap2:
        torch.as_tensor(np.ones(8, np.float32), device=card)  # a pageable copy
    assert cap2.counted_by_span(tracing.SYNCS) == {tracing.OUTSIDE: 1}


@pytest.mark.cuda
def test_a_span_covers_its_kernels_on_the_device_trace(card, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(4096, 4096, device=card)
    (a @ a).sum().item()  # cuBLAS set up before the trace
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with tracing.capture() as cap:
            with tracing.span("loop"):
                for _ in range(20):
                    a = (a @ a).clamp_(-1, 1)
                torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    (loop,) = [e for e in cap.events(data["baseTimeNanoseconds"]) if e["ph"] == "X"]
    kernels = [e for e in data["traceEvents"] if e.get("ph") == "X" and e.get("cat") == "kernel"]
    assert len(kernels) >= 40
    first = min(e["ts"] for e in kernels)
    last = max(e["ts"] + e["dur"] for e in kernels)
    assert loop["ts"] - 1000 <= first and last <= loop["ts"] + loop["dur"] + 1000, (
        loop["ts"], loop["dur"], first, last)
    # the loop's device time fills most of the span: the span is on the card's axis
    busy = sum(e["dur"] for e in kernels)
    assert busy > 0.5 * loop["dur"], (busy, loop["dur"])
