"""`cdsegnet_torch.utils.tracing`: spans and counters off and on, their
nesting and self time, the spans of the training step and of the tester's
request on the tiny model, PTv2's geometry, kNN and attention spans and
counters, spans as profiler ranges, the clock against `torch.profiler`'s
exported trace, and the written Chrome trace. The tests marked ``cuda`` count host
syncs and place a span over its kernels on the card. No JAX here: the
card's machine has none."""

from __future__ import annotations

import json
import os
import subprocess
import sys
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
from cdsegnet_torch.utils import cuda_build, tracing
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
    assert cap.launches == dict(fwd=0, fwd_lse=0, dq=0, dkdv=0, conv_fwd=0, conv_dgrad=0,
                                conv_wgrad=0, knn=0)


def test_a_launch_counter_registered_during_a_capture_counts_from_zero(monkeypatch):
    def kernel():
        kernel.launches += 1

    kernel.launches = 5  # what the attribute held before it was registered
    monkeypatch.setattr(cuda_build, "_COUNTERS", dict(cuda_build._COUNTERS))
    with tracing.capture() as cap:
        cuda_build.register_launches("late", kernel)
        kernel()
        kernel()
    assert cap.launches["late"] == 2 and cap.launches["fwd"] == 0
    assert set(cap.launches) == {"fwd", "fwd_lse", "dq", "dkdv", "conv_fwd", "conv_dgrad",
                                 "conv_wgrad", "knn", "late"}
    cuda_build.reset_launch_counts()
    assert kernel.launches == 0 and cuda_build.launch_counts()["late"] == 0


def test_a_capture_reports_only_the_kernels_imported_by_its_end():
    """`tracing` imports no kernel wrapper: in a fresh process a capture
    reports no launch counter until a wrapper module has registered its
    own."""
    code = (
        "import json, sys\n"
        "from cdsegnet_torch.utils import tracing\n"
        "ops = sorted(m for m in sys.modules if m.startswith('cdsegnet_torch.ops'))\n"
        "with tracing.capture() as bare:\n"
        "    pass\n"
        "with tracing.capture() as late:\n"
        "    from cdsegnet_torch.ops import subm_conv\n"
        "print(json.dumps([ops, bare.launches, late.launches]))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    ops, bare, late = json.loads(out.strip().splitlines()[-1])
    assert ops == [] and bare == {}
    assert late == {"conv_fwd": 0, "conv_dgrad": 0, "conv_wgrad": 0}


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
    assert data["counters"] == {"c": 3} and set(data["launches"]) == {
        "fwd", "fwd_lse", "dq", "dkdv", "conv_fwd", "conv_dgrad", "conv_wgrad", "knn"}
    xs = [e for e in data["traceEvents"] if e["ph"] == "X"]
    cs = [e for e in data["traceEvents"] if e["ph"] == "C"]
    assert [e["name"] for e in xs] == ["a", "b"]
    for e in xs:
        assert {"name", "ph", "ts", "dur", "pid", "tid", "cat", "args"} <= set(e)
        assert e["ts"] >= 0 and e["dur"] >= 0 and e["tid"].startswith("spans ")
    assert xs[1]["args"]["parent_id"] == xs[0]["args"]["id"]
    assert xs[0]["ts"] <= xs[1]["ts"] and xs[1]["ts"] + xs[1]["dur"] <= xs[0]["ts"] + xs[0]["dur"]
    assert [e["args"]["c"] for e in cs] == [2, 3]


PTV2 = dict(type="DefaultSegmentor", backbone=dict(
    type="PT-v2m2-pointcept", in_channels=6, num_classes=5, patch_embed_channels=8,
    patch_embed_groups=2, enc_channels=(8, 16, 16, 16), enc_groups=(2, 4, 4, 4),
    dec_channels=(8, 8, 16, 16), dec_groups=(2, 2, 4, 4), grid_sizes=(0.1, 0.2, 0.4, 0.8)),
    criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)])


def test_ptv2_geometry_gives_a_knn_span_per_level_and_its_counts():
    """The published PTv2's forward: one ``geometry`` with a
    ``pointops.knn`` inside per level (5), one ``ptv2.attention`` per block
    (17), the drop counters of the metric levels, and ``knn.queries`` and
    ``knn.pairs`` equal to each level's valid points and the sum over its
    scenes of their squares."""
    torch.manual_seed(0)
    model = build_model(dict(PTV2), device="cpu").train()
    point = synthetic_point_batch(2048, 2, DEPTH, seed=1, device="cpu")
    with tracing.capture() as cap:
        out = model(point, generators=dict(dropout=torch.Generator().manual_seed(0)))
    geometry = [s for s in cap.spans if s.name == "geometry"]
    knns = [s for s in cap.spans if s.name == "pointops.knn"]
    assert len(geometry) == 1 and len(knns) == 5
    assert all(s.parent_id == geometry[0].id for s in knns)
    assert len(names(cap, name="ptv2.attention")) == 17
    levels, _ = model.backbone.precompute_geometry(point)
    queries = pairs = 0
    for lv in levels:
        valid = lv.point.batch[lv.point.mask]
        sizes = torch.bincount(valid.long())
        queries += int(sizes.sum())
        pairs += int((sizes * sizes).sum())
    assert cap.counters["knn.queries"] == queries
    assert cap.counters["knn.pairs"] == pairs > queries
    assert cap.under("knn.pairs", "geometry") == pairs
    assert {f"pyramid.dropped_l{i}": cap.counters[f"pyramid.dropped_l{i}"]
            for i in range(1, 5)} == {f"pyramid.dropped_l{i}": d
                                      for i, d in enumerate(out["pyramid_dropped"], 1)}


def test_a_span_marks_a_profiler_range_and_is_off_without_one(tmp_path):
    """While a torch profiler runs, a span is a ``user_annotation`` range of
    its name on the trace, with a capture open or not; with neither, the
    span is the shared `OFF`."""
    from torch.profiler import ProfilerActivity, profile

    assert tracing.span("a") is tracing.OFF
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.span("probe") is not tracing.OFF
        with tracing.span("probe"):
            torch.randn(64, 64) @ torch.randn(64, 64)
        with tracing.capture() as cap:
            with tracing.span("captured"):
                torch.randn(64, 64).sum()
    assert tracing.span("a") is tracing.OFF
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = {e["name"] for e in events
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"}
    assert {"probe", "captured"} <= ranges
    assert names(cap) == ["captured"]


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
    # cuBLAS and the clamp's kernel set up before the trace: the first
    # clamp_ otherwise holds the host for 12-31 ms inside the span
    (a @ a).clamp_(-1, 1).sum().item()
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
