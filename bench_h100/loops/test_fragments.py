"""Inference cells: the port's tester (`SemSegTester.predict_fragment`),
one fragment at a time from one client (a closed loop).

The mix (kind ``test_fragments``) makes the fragments of ``rooms`` rooms
through the test pipeline (CenterShift, NormalizeColor, each of
``augmentations``, then GridSample at ``grid_size`` in test mode and
CenterShift without z), in order; requests cycle over them.

Each request hands over one fragment of the traffic's rooms, in order, with
its c-branch noise drawn from the seed and the request's number; its
latency runs from the hand-over to its probabilities being ready on the
card after a synchronize. Set-up warms the shape up with three requests. A
traced run profiles a fixed stretch of requests after the window, with the
geometry build timed on the host around each call. Once the program's
state is freed, the reference recomputes a sample of the window's answers,
drawn from the seed, the largest fragment among them.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bench_h100 import compare, counts, manifest, program, scene, traffic, weights
from bench_h100.loops.train_buckets import sync
from bench_h100.reference import geometry as geo
from bench_h100.reference.nn import Precision
from bench_h100.trace import profiled

WARMUP = 3
STRETCH_REQUESTS = 12
SAMPLE = 4


def make(mix: Dict, seed: int) -> List[Dict[str, np.ndarray]]:
    frags = []
    for r in range(mix["rooms"]):
        data = scene.normalize_color(scene.center_shift(
            scene.room(traffic.room_seed(seed, r), mix["cell"]), apply_z=True))
        data.pop("segment")
        for aug in mix["augmentations"]:
            for part in scene.grid_sample_test(scene.augment(data, aug), mix["grid_size"]):
                frags.append(scene.collect(scene.center_shift(part, apply_z=False)))
    return frags


def noise(seed: int, index: int, bucket: int, channels: int, device) -> torch.Tensor:
    g = torch.Generator(device).manual_seed(traffic.derive(seed, 40, index))
    return torch.randn((bucket, channels), generator=g, device=device)


def bucket_for(cfg: Dict, n: int) -> int:
    fits = [b for b in sorted(cfg["test_buckets"]) if n <= b]
    return fits[0] if fits else max(cfg["test_buckets"])


def sample(seed: int, frags) -> list:
    """Requests whose answers are compared: a few drawn from the seed among
    the first cycle, and the first request of the largest fragment."""
    first = min(len(frags), 64)
    rng = np.random.default_rng(traffic.derive(seed, 50))
    picks = set(int(i) for i in rng.choice(first, size=min(SAMPLE, first), replace=False))
    picks.add(int(np.argmax([f["coord"].shape[0] for f in frags])))
    return sorted(picks)


def reference_probs(cell: Dict, frags, seed: int, index: int, prec: Precision, device):
    cfg = cell["cfg"]
    R = manifest.reference(cfg)
    arch = R.Arch(cfg["model"])
    frag = frags[index % len(frags)]
    n = frag["coord"].shape[0]
    bucket = bucket_for(cfg, n)
    tb = {k: torch.as_tensor(v, device=device) for k, v in scene.collate([frag], bucket).items()}
    W = weights.make(R.param_shapes(arch), traffic.derive(seed, 10), device)
    prec.use()
    logits = R.ssi_logits(arch, W, tb, noise(seed, index, bucket, arch.c_in, device),
                          cfg["serialization_depth"], prec)
    Precision("f32").use()
    return torch.softmax(logits[:n], -1)


def run(cell: Dict, seed: int, seconds: float, trace: bool, device, t0: float,
        fault: Optional[str] = None, control: bool = False) -> Dict:
    cfg = cell["cfg"]
    R = manifest.reference(cfg)
    arch = R.Arch(cfg["model"])
    marks = dict(start=time.perf_counter() - t0)
    frags = traffic.make(cell["traffic"], seed)[1]
    picks = sample(seed, frags)
    marks["inputs"] = time.perf_counter() - t0
    if control:
        pairs = [(reference_probs(cell, frags, seed, i, Precision(cfg["control_precision"]), device),
                  reference_probs(cell, frags, seed, i, Precision("f32"), device)) for i in picks]
        return dict(numbers=compare.prob_numbers(pairs), attempted=len(pairs), window=None)

    if cfg.get("cuda_kernels") and torch.device(device).type == "cuda":
        program.build_kernels()
    marks["kernels"] = time.perf_counter() - t0
    Precision("f32").use()
    model = program.build_model(cfg, weights.make(R.param_shapes(arch), traffic.derive(seed, 10),
                                                  device), device).eval()
    marks["model"] = time.perf_counter() - t0
    tester = program.tester(cfg, model, device)
    noise_fn = lambda i, bucket, c: noise(seed, i, bucket, c, device)
    predict = tester.predict_fragment
    if fault == "altered":  # one point's answer set to its least likely class

        def predict(frag, index, noise_fn):
            p = tester.predict_fragment(frag, index, noise_fn)
            wrong = torch.nn.functional.one_hot(p[0].argmin(), p.shape[1]).to(p.dtype)
            return torch.cat([wrong[None], p[1:]], 0)

    for w in range(WARMUP):
        predict(frags[w % len(frags)], 10 ** 6 + w, noise_fn)
    sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    setup_s = time.perf_counter() - t0
    kept, lat, points = {}, [], 0
    w0 = time.perf_counter()
    i = 0
    while time.perf_counter() - w0 < seconds:
        frag = frags[i % len(frags)]
        t = time.perf_counter()
        p = predict(frag, i, noise_fn)
        sync(device)
        lat.append(time.perf_counter() - t)
        points += frag["coord"].shape[0]
        if i in picks:
            kept[i] = p
        i += 1
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    marks["warmup"] = setup_s
    run_ = dict(setup_s=setup_s, attempted=i, cfg=cfg, phases=marks,
                window=dict(seconds=window_s, requests=i, points=points, latencies=lat,
                            peak_bytes=peak))
    if trace:
        before = program.attention_launches()
        stretch = [(i + j) % len(frags) for j in range(STRETCH_REQUESTS)]
        with profiled(device) as held:
            for j, f in enumerate(stretch):
                predict(frags[f], i + j, noise_fn)
        after = program.attention_launches()
        with profiled(device, host=True) as host:
            predict(frags[stretch[0]], i, noise_fn)
        run_.update(trace=held.trace, host_trace=host.trace)
        run_["stretch"] = dict(steps=len(stretch), host_steps=1,
                               geometry_s=geometry_seconds(model, cfg, stretch, frags, device),
                               launches={k: after[k] - before[k] for k in after})
    del tester, model, predict
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    r0 = time.perf_counter()
    pairs = [(kept[j], reference_probs(cell, frags, seed, j, Precision("f32"), device))
             for j in picks if j in kept]
    run_["reference_s"] = time.perf_counter() - r0
    run_["pairs"] = len(pairs)
    run_["numbers"] = (compare.prob_numbers(pairs) if pairs
                       else dict(prob_gap=math.inf, prob_rel=math.inf))
    run_["answers"] = [compare.prob_numbers([pair]) for pair in pairs]
    if trace:
        run_["per_fragment"] = fragment_counts(cell, frags, device)
        run_["order"] = [j % len(frags) for j in range(i)]
        run_["stretch"]["fragments"] = stretch
    return run_


def geometry_seconds(model, cfg: Dict, stretch, frags, device):
    """Host seconds of the port's geometry build for each of the stretch's
    fragments, with a synchronize on each side (no profiler)."""
    out = []
    for f in stretch:
        frag = frags[f]
        bucket = scene.collate([frag], bucket_for(cfg, frag["coord"].shape[0]))
        point = program.to_point(bucket, cfg["serialization_depth"], 1, device)
        sync(device)
        t = time.perf_counter()
        model.backbone.precompute_geometry(point)
        sync(device)
        out.append(time.perf_counter() - t)
    return out


def fragment_counts(cell: Dict, frags, device):
    """Per fragment of the cycle: one SSI forward's FLOPs and its attention
    launches' bound seconds, from the reference's pyramid."""
    cfg = cell["cfg"]
    R = manifest.reference(cfg)
    arch = R.Arch(cfg["model"])
    out = []
    for frag in frags:
        n = frag["coord"].shape[0]
        tb = {k: torch.as_tensor(v, device=device)
              for k, v in scene.collate([frag], bucket_for(cfg, n)).items()}
        stats = geo.level_stats(R.pyramid(arch, tb, 1, cfg["serialization_depth"]),
                                max(arch.n_patch))
        out.append(dict(flops=R.forward_flops(arch, stats, False),
                        attention=counts.attention_bounds(R.attention_calls(arch, False),
                                                          stats, cfg["dtype"])))
    return out
