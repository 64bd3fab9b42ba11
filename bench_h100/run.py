"""Run one cell of the benchmark once:

    python3 -m bench_h100.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
It prints the compared numbers beside their limits as its last lines on
standard error, and one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` a ``breakdown``, and ``checks`` last.

Two further modes print one JSON line per seed and no result:
``--control 1`` puts the reference, one step of precision below the
configuration's, in the program's place; ``--fault <name>`` breaks the
timed path underneath (``frozen``, ``half_batch``, ``altered``);
``--readings <k>`` runs seeds ``seed .. seed + k - 1`` in one process.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "cdsegnet_tpu")
# build and kernel caches at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".bench_cache", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".bench_cache", "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def finite(x):
    """``x`` with every infinite or NaN float replaced by the largest float,
    so that the line is strict JSON."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return sys.float_info.max
    return x


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None)
    p.add_argument("--readings", type=int, default=0)
    return p.parse_args(argv)


def result(cell, run, trace: bool, device_info) -> dict:
    from bench_h100 import compare, manifest

    metrics = {}
    for m in manifest.metrics_for(cell["name"], trace):
        value = manifest.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    correct, checks = compare.judge(run["numbers"], cell["limits"])
    answers = run.get("answers", [run["numbers"]])
    failed = sum(not compare.judge(a, cell["limits"])[0] for a in answers)
    out = dict(correct=correct and bool(answers), attempted=run["attempted"], failed=failed,
               metrics=metrics, device=device_info)
    if trace:
        tr = run["trace"]
        out["device"] = dict(device_info, busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = dict(device_ops=tr.device_ops(),
                                idle_gaps=run["host_trace"].idle_gaps())
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from bench_h100 import manifest

    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    loop = manifest.loop(manifest.traffic_kind(cell["traffic"]))
    seeds = [args.seed + k for k in range(max(args.readings, 1))]
    if args.control or args.fault or args.readings:
        for seed in seeds:
            t0 = time.perf_counter() if seed != args.seed else T0
            run = loop.run(cell, seed, args.seconds, False, "cuda", t0, fault=args.fault,
                             control=bool(args.control))
            line = dict(seed=seed, control=bool(args.control), fault=args.fault,
                        numbers=run["numbers"], attempted=run["attempted"])
            if run.get("window"):
                w = run["window"]
                line.update(setup_s=run["setup_s"], reference_s=run.get("reference_s"),
                            window={k: v for k, v in w.items() if k != "latencies"})
                if "latencies" in w:
                    line["p95_ms"] = manifest.reader("fragment_p95_ms.infer")(run)
            line["detail"] = run.get("detail")
            line["phases"] = run.get("phases")
            print(json.dumps(finite(line)), flush=True)
            del run
        return 0
    run = loop.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}", file=sys.stderr)
        return 3
    device_info = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=cell["chips"],
                       memory_peak_bytes=run["window"]["peak_bytes"])
    out = result(cell, run, bool(args.trace), device_info)
    print("set-up phases (s from start): " + json.dumps(run["phases"]), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(finite(out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
