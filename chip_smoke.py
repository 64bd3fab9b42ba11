#!/usr/bin/env python3
"""Drive the PyTorch port (`cdsegnet_torch`) on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``.
Phases, each fatal on failure:

1. card: the GPU's name and power limit, as nvidia-smi reports them;
2. build: compile the kernel of the SSI path from the checkout's source;
3. kernels: each kernel against its plain PyTorch version on the GPU, at
   every shape the SSI path gives it, in bf16 and f32, plus padded
   multi-scene batches; every output row must be finite. Times (CUDA
   events) beside the bound and the time of the equivalent library call;
4. ssi: CDSegNet single-step inference at the full width of
   `configs/scannet/cdsegnet.py` (random weights from a seed) on a
   104,448-point synthetic scene: launches counted, checked against the
   plain attention route (as shipped, with the softmax in f32 on both routes,
   and with the whole model in f32), and timed (3 warm-ups, median of 10).

The last three lines are a JSON summary of the kernels, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Without a GPU, or
outside a checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import os
import runpy
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
NUM_POINTS = 104448  # the bench scene of the JAX package (bench.py)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12
# kernel vs plain version on the same inputs: f32 is f32 arithmetic on both
# sides; in bf16 the plain version rounds p to bf16 before p.v
TOL_F32 = 1e-4            # max abs error
TOL_BF16 = 2e-2           # max abs error / max |o|
# SSI, kernel route vs plain route: max |dlogits| / max |logits| and argmax
# agreement on valid points, each about 3x the gap read on an H100.
# "shipped": the config as it is (bf16, upcast_softmax=False: the plain
# route rounds logits and softmax to bf16, the kernel keeps them in f32);
# "f32_softmax": upcast_softmax=True on both routes; "float32": the whole
# model in f32, which isolates the kernel from bf16 rounding
TOL_SSI = {"shipped": (0.053, 0.967), "f32_softmax": (0.047, 0.968),
           "float32": (3.5e-6, 0.9999)}


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(torch, fn, warmup: int = 3, iters: int = 10) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_launches(backbone_cfg: dict):
    """``(level, curve order, heads, head dim)`` of every launch of the
    patch-attention kernel in one SSI forward: the n-encoder, n-decoder and
    c-encoder blocks (SSI skips the c-decoder)."""
    from cdsegnet_torch.models.ptv3 import _cumshift

    b = backbone_cfg
    n_orders = len(b["order"])
    n_shift, c_shift = _cumshift(b["n_stride"]), _cumshift(b["c_stride"])
    n_dec_ch = list(b["n_dec_channels"]) + [b["n_enc_channels"][-1]]
    stages = [(n_shift[s], b["n_enc_num_head"][s], b["n_enc_channels"][s], d)
              for s, d in enumerate(b["n_enc_depths"])]
    stages += [(n_shift[s], b["n_dec_num_head"][s], n_dec_ch[s], d)
               for s, d in enumerate(b["n_dec_depths"])]
    stages += [(c_shift[s], b["c_enc_num_head"][s], b["c_enc_channels"][s], d)
               for s, d in enumerate(b["c_enc_depths"])]
    return [(level, i % n_orders, h, c // h)
            for level, h, c, depth in stages for i in range(depth)]


def scene_layout(torch, n: int, scene_sizes, device):
    """Sorted scene ids and validity: scenes back to back, padding (with the
    sentinel scene id) at the tail."""
    batch = np.full(n, len(scene_sizes), np.int32)
    start = 0
    for s, size in enumerate(scene_sizes):
        batch[start:start + size] = s
        start += size
    valid = np.arange(n) < start
    return (torch.as_tensor(batch, device=device),
            torch.as_tensor(valid, device=device))


def check_kernel_case(torch, batch, valid, h, d, patch, dtype, gen):
    """Kernel vs plain version on random q, k, v with the given scene ids and
    validity; returns the measurements."""
    import torch.nn.functional as F

    from cdsegnet_torch.ops.attention import patch_attention
    from cdsegnet_torch.ops.flash_attention import patch_attention_fwd

    n = batch.shape[0]
    q, k, v = (torch.randn((n, h, d), generator=gen, device=batch.device).to(dtype)
               for _ in range(3))
    scale = d ** -0.5
    out = patch_attention_fwd(q, k, v, batch, valid, patch, scale)
    torch.cuda.synchronize()
    want = patch_attention(q, k, v, batch, valid, patch, scale, upcast_softmax=True)
    name = str(dtype).replace("torch.", "")
    if not torch.isfinite(out.float()).all():
        fail(f"kernel output has non-finite rows at {(n, h, d)} {name}")
    err = (out.float() - want.float())[valid].abs().max().item()
    ref = want.float()[valid].abs().max().item()
    if err > (TOL_F32 if dtype == torch.float32 else TOL_BF16 * ref):
        fail(f"kernel disagrees with plain at {(n, h, d)} {name}: "
             f"max abs err {err:.3e} (max |o| {ref:.3e})")

    p = n // patch
    bp = batch.view(p, patch)
    allowed = (bp[:, :, None] == bp[:, None, :]) & valid.view(p, 1, patch)
    pairs = int(allowed.sum().item())  # (query, key) pairs this data needs
    to4 = lambda x: x.view(p, patch, h, d).transpose(1, 2).contiguous()
    q4, k4, v4, m4 = to4(q), to4(k), to4(v), allowed[:, None]
    kernel_ms = cuda_ms(torch, lambda: patch_attention_fwd(q, k, v, batch, valid,
                                                           patch, scale))
    plain_ms = cuda_ms(torch, lambda: patch_attention(q, k, v, batch, valid, patch,
                                                      scale, upcast_softmax=True))
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=m4, scale=scale))
    flops = 4.0 * d * h * pairs
    nbytes = 4.0 * n * h * d * q.element_size() + 5.0 * n
    ops_ms = flops / PEAK_FLOPS[name] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return dict(shape=[n, h, d], patch=patch, dtype=name, max_abs_err=err,
                max_abs_out=ref, ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=max(ops_ms, bytes_ms),
                ops_ms=ops_ms, bytes_ms=bytes_ms, exps=h * pairs,
                valid_rows=int(valid.sum().item()))


SUMMED = ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms", "exps")


def phase_kernels(torch, levels, launches, patch):
    """Every distinct launch of the SSI path (level, curve order, heads,
    head dim), on that level's real scene ids and validity, in bf16 and f32;
    then padded multi-scene batches. Returns the main-path rows, each with
    its launch count per SSI forward."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    counts: dict = {}
    for key in launches:
        counts[key] = counts.get(key, 0) + 1
    rows = []
    for (level, oi, h, d), count in counts.items():
        pt = levels[level].point
        for dtype in (torch.bfloat16, torch.float32):
            r = check_kernel_case(torch, pt.batch_sorted[oi], pt.mask_sorted[oi],
                                  h, d, patch, dtype, gen)
            r.update(level=level, order=oi, launches_per_ssi=count)
            rows.append(r)
            print("kernel patch_attention_fwd " + json.dumps(r), flush=True)
    # three scenes crossing patch boundaries with 10% padding (rows without
    # an allowed key), and the D=32 shape of the JAX bench's parity check
    for n, h, d, p, sizes in ((8192, 2, 16, 1024, [2500, 3100, 1772]),
                              (2048, 4, 32, 512, [922, 921])):
        batch, valid = scene_layout(torch, n, sizes, "cuda")
        for dtype in (torch.bfloat16, torch.float32):
            r = check_kernel_case(torch, batch, valid, h, d, p, dtype, gen)
            print("kernel patch_attention_fwd extra " + json.dumps(r), flush=True)
    # per main-path shape: sums over that shape's launches in one forward
    for dtype in ("bfloat16", "float32"):
        shapes: dict = {}
        for r in rows:
            if r["dtype"] != dtype:
                continue
            agg = shapes.setdefault(tuple(r["shape"]), dict(
                {k: 0.0 for k in SUMMED}, launches=0, max_abs_err=0.0))
            agg["launches"] += r["launches_per_ssi"]
            agg["max_abs_err"] = max(agg["max_abs_err"], r["max_abs_err"])
            for k in SUMMED:
                agg[k] += r[k] * r["launches_per_ssi"]
        for shape, agg in shapes.items():
            agg["bound_by"] = "operations" if agg["ops_ms"] >= agg["bytes_ms"] else "bytes"
            print("shape " + json.dumps(dict(shape=list(shape), dtype=dtype, **agg)),
                  flush=True)
    return rows


def phase_ssi(torch, cfg, model, point, n_launches, card):
    from cdsegnet_torch.models.builder import build_model
    from cdsegnet_torch.ops.flash_attention import patch_attention_fwd

    noise = torch.randn((NUM_POINTS, 6), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(7))
    valid = point.mask
    n_valid = int(valid.sum().item())

    patch_attention_fwd.launches = 0
    logits = model.inference(point, noise=noise)["seg_logits"]
    torch.cuda.synchronize()
    launches = patch_attention_fwd.launches
    print(f"ssi kernel launches per forward {launches} (expected {n_launches})",
          flush=True)
    if launches != n_launches:
        fail(f"SSI launched the attention kernel {launches} times, "
             f"expected {n_launches}")
    if tuple(logits.shape) != (NUM_POINTS, 20):
        fail(f"logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits[valid]).all():
        fail("non-finite logits on valid points")

    def route(route_cfg, use_pallas):
        c = copy.deepcopy(route_cfg)
        c["backbone"]["use_pallas"] = use_pallas
        m = build_model(c, device="cuda", generator=torch.Generator().manual_seed(0))
        return m.inference(point, noise=noise)["seg_logits"]

    def gap(got, want):
        return dict(max_abs_dlogits=(got - want)[valid].abs().max().item(),
                    max_abs_logits=want[valid].abs().max().item(),
                    argmax_agree=(got.argmax(1) == want.argmax(1))[valid]
                    .float().mean().item())

    # same weights (seed 0) and noise on every route
    f32_softmax = copy.deepcopy(cfg)
    f32_softmax["backbone"]["upcast_softmax"] = True
    float32 = copy.deepcopy(f32_softmax)
    float32["backbone"]["dtype"] = "float32"
    plain_shipped, plain_f32_softmax = route(cfg, False), route(f32_softmax, False)
    gaps = dict(shipped=gap(logits, plain_shipped),
                f32_softmax=gap(route(f32_softmax, None), plain_f32_softmax),
                float32=gap(route(float32, None), route(float32, False)))
    # the bf16 noise floor: two plain routes that differ only in where they
    # round; reported beside the kernel's gaps, not held to a tolerance
    floor = gap(plain_f32_softmax, plain_shipped)
    for name, g in list(gaps.items()) + [("plain_floor", floor)]:
        rel = g["max_abs_dlogits"] / g["max_abs_logits"]
        print(f"ssi route gap {name}: max |dlogits| "
              f"{g['max_abs_dlogits']:.4e} (max |logits| {g['max_abs_logits']:.4e}, "
              f"{rel:.4%}), argmax agreement {g['argmax_agree']:.5f}", flush=True)
    for name, g in gaps.items():
        tol_rel, tol_agree = TOL_SSI[name]
        if (g["max_abs_dlogits"] > tol_rel * g["max_abs_logits"]
                or g["argmax_agree"] < tol_agree):
            fail(f"SSI kernel route disagrees with the plain route ({name})")

    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(13):  # 3 warm-ups, then 10 timed steps, geometry included
        t0 = time.perf_counter()
        model.inference(point, noise=noise)
        torch.cuda.synchronize()
        if i >= 3:
            times.append(time.perf_counter() - t0)
    step_ms = statistics.median(times) * 1e3
    result = dict(step_ms=step_ms, step_ms_all=[t * 1e3 for t in times],
                  points_per_s=n_valid / (step_ms / 1e3), n_valid=n_valid,
                  launches=launches, route_gaps=dict(gaps, plain_floor=floor),
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  card=card)
    print("ssi " + json.dumps(result), flush=True)
    return result


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    config = os.path.join(ROOT, "configs", "scannet", "cdsegnet.py")
    if not os.path.isdir(os.path.join(ROOT, "cdsegnet_torch")) or not os.path.isfile(config):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from cdsegnet_torch.ops.flash_attention import KERNEL
    from cdsegnet_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card {card}", flush=True)

    t0 = time.perf_counter()
    cuda_build.build(KERNEL)
    print(f"build {KERNEL} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in cuda_build.build_log(KERNEL).splitlines():
        if "registers" in line or "spill" in line:
            print(f"build ptxas {line.strip()}", flush=True)

    from cdsegnet_torch.models.builder import build_model
    from cdsegnet_torch.utils.synthetic import synthetic_point_batch

    cfg = runpy.run_path(config)["model"]
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    point = synthetic_point_batch(NUM_POINTS, 1, depth=10, seed=0, device="cuda")
    levels, _ = model.backbone.precompute_geometry(point)
    drops = [lv.dropped for lv in levels[1:]]
    n_valid = int(point.mask.sum().item())
    print(f"scene {NUM_POINTS} points, {n_valid} valid, level sizes "
          f"{[lv.size for lv in levels]}, dropped per level {drops}", flush=True)
    if drops != [0, 0, 0, 0] or n_valid != 94003:
        fail("the bench scene is not the expected one")

    launches = attention_launches(cfg["backbone"])
    rows = phase_kernels(torch, levels, launches,
                         max(cfg["backbone"]["n_enc_patch_size"]))
    ssi = phase_ssi(torch, cfg, model, point, len(launches), card)

    main_rows = [r for r in rows if r["dtype"] == "bfloat16"]
    per_ssi = lambda key: sum(r[key] * r["launches_per_ssi"] for r in main_rows)
    kernel = dict(
        name="patch_attention_fwd", route="cuda",
        source="cdsegnet_torch/csrc/patch_attention_fwd.cu",
        replaces="cdsegnet_tpu/ops/pallas/flash_attention.py:45",
        launches=ssi["launches"],
        max_abs_err=max(r["max_abs_err"] for r in main_rows),
        # per SSI forward: summed over the main path's launches, each timed
        # on its level's real scene ids and validity
        ms=per_ssi("ms"), plain_ms=per_ssi("plain_ms"),
        bound_ms=per_ssi("bound_ms"),
        bound_by="operations" if per_ssi("ops_ms") >= per_ssi("bytes_ms") else "bytes",
        library_ms=per_ssi("library_ms"),
    )
    print(json.dumps({"kernels": [kernel]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
