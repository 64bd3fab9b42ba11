"""Profile CDSegNet single-step inference of the port on one GPU.

Usage, from the root of a checkout::

    python -m cdsegnet_torch.tools.profile_ssi --out DIR [--config FILE]

Builds the model of ``--config`` (`configs/scannet/cdsegnet.py` by default;
e.g. `configs/scannet/ptv2.py`; random weights from a seed) on the
synthetic 104,448-point bench scene, then reports, for one SSI step (a
model without SSI, such as PTv2, its eval forward):

- host-clock times (median of 10 after 3 warm-ups, each ending in a
  synchronize) of the geometry build alone, the forward on precomputed
  geometry, and the whole step;
- from `torch.profiler` over 3 steps: the device time per step summed over
  all kernels, the device's idle share of the unprofiled step time, and the
  device time by kernel family and by kernel.

The full kernel table, and the host operators by self CPU time, go to
``<out>/profile_ssi.txt`` (``profile_ssi_<config name>.txt`` for another
config). `profile_train` shares this code.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import torch

from cdsegnet_torch.engine.config import Config
from cdsegnet_torch.models.builder import build_model
from cdsegnet_torch.utils.synthetic import synthetic_point_batch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NUM_POINTS = 104448  # the bench scene of the JAX package (bench.py)
# kernel-name substrings -> family, first match wins
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


def host_ms(fn, warmup: int = 3, iters: int = 10) -> float:
    times = []
    for i in range(warmup + iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


DEFAULT_CONFIG = os.path.join("configs", "scannet", "cdsegnet.py")


def load_config(path: str):
    """A config file (relative to the checkout's root, or absolute) with its
    ``_base_`` chain merged, and the name of its profile tables' suffix:
    empty for the default config, else ``_<file stem>``."""
    full = path if os.path.isabs(path) else os.path.join(ROOT, path)
    same = os.path.abspath(full) == os.path.join(ROOT, DEFAULT_CONFIG)
    return Config.fromfile(full), "" if same else \
        "_" + os.path.splitext(os.path.basename(full))[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="directory for profile_ssi.txt")
    ap.add_argument("--config", default=DEFAULT_CONFIG, help="the model's config file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_ssi needs a CUDA device")
    card = card_name()

    conf, suffix = load_config(args.config)
    model = build_model(dict(conf.model), device="cuda",
                        generator=torch.Generator().manual_seed(0))
    point = synthetic_point_batch(NUM_POINTS, 1, depth=10, seed=0, device="cuda")
    noise = torch.randn((NUM_POINTS, 6), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(7))
    n_valid = int(point.mask.sum().item())
    geometry = model.backbone.precompute_geometry(point)

    @torch.no_grad()
    def run(geometry=None):
        if hasattr(type(model), "inference"):
            return model.inference(point, noise=noise, geometry=geometry)
        return model(point, geometry=geometry)

    res = dict(
        card=card, config=args.config, points=NUM_POINTS, n_valid=n_valid,
        geometry_ms=host_ms(lambda: model.backbone.precompute_geometry(point)),
        forward_ms=host_ms(lambda: run(geometry)),
        step_ms=host_ms(run),
    )

    profile_steps(run, 3, res, os.path.join(args.out, f"profile_ssi{suffix}.txt"))


def profile_steps(step, steps: int, res: dict, path: str) -> None:
    """Run ``step`` ``steps`` times under `torch.profiler` and add to ``res``
    the device time per step, the device's idle share against the
    unprofiled ``res["step_ms"]`` (the profiler slows the host, not the
    kernels) and under the profiler, launches per step and the time by
    kernel family; write the kernel table and the host operators with the
    most self CPU time to ``path``."""
    torch.cuda.synchronize()
    with make_profiler() as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    report(prof, steps, wall_ms, res, path)


def make_profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])


def report(prof, steps: int, wall_ms: float, res: dict, path: str) -> None:
    """Add to ``res`` what `profile_steps` adds, from a finished profile of
    ``steps`` steps that took ``wall_ms`` each; write and print the tables."""
    kernels, host = {}, {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            host[evt.key] = (evt.self_cpu_time_total / 1e3 / steps, evt.count // steps)
            continue
        if getattr(evt, "is_user_annotation", False):
            continue  # a range on the device's timeline (the optimizer step), not a kernel
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels[evt.key] = (us / 1e3 / steps, evt.count // steps)
    device_ms = sum(ms for ms, _ in kernels.values())
    fams = {}
    for name, (ms, _) in kernels.items():
        fams[family(name)] = fams.get(family(name), 0.0) + ms
    res.update(profiled_wall_ms=wall_ms, device_ms=device_ms,
               idle_share=max(0.0, 1.0 - device_ms / res["step_ms"]),
               idle_share_profiled=max(0.0, 1.0 - device_ms / wall_ms),
               kernel_launches=sum(c for _, c in kernels.values()),
               families_ms=dict(sorted(fams.items(), key=lambda kv: -kv[1])))

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    ranked_host = sorted(host.items(), key=lambda kv: -kv[1][0])
    with open(path, "w") as f:
        f.write(f"{res['card']}\n{json.dumps(res)}\n\nms/step  launches/step  family  kernel\n")
        for name, (ms, cnt) in ranked:
            f.write(f"{ms:9.4f}  {cnt:6d}  {family(name):18s}  {name}\n")
        f.write("\nself CPU ms/step  calls/step  host operator\n")
        for name, (ms, cnt) in ranked_host:
            f.write(f"{ms:9.4f}  {cnt:6d}  {name}\n")
    for name, (ms, cnt) in ranked[:15]:
        print(f"profile kernel {ms:8.3f} ms  x{cnt:<5d} {family(name):18s} {name[:110]}")
    for name, (ms, cnt) in ranked_host[:10]:
        print(f"profile host {ms:8.3f} ms  x{cnt:<5d} {name[:110]}")
    print("profile " + json.dumps(res))


if __name__ == "__main__":
    main()
