"""Time variants of the bf16 attention kernels, backward and forward, on one GPU.

Usage, from the root of a checkout::

    python -m cdsegnet_torch.tools.bwd_variants --out DIR [--baseline CSRC]

Each variant is a kernel source of `cdsegnet_torch/csrc/`
(`patch_attention_bwd.cu` or `patch_attention_fwd.cu`, with the shared
header `attention_tiles.cuh`) with text substitutions: the tile size, the
warps per block, the forward's online softmax rescaled every 16 or 64 keys
or once per 128-key tile in place of every 32 keys, or, for timing only,
the exponential replaced by
the identity (which shows how much the SFU binds). ``--baseline`` adds each
source as another directory holds it, e.g. the ``csrc/`` of the parent
commit's checkout, to show whether a change left a kernel's results
bit-equal. Every variant builds with nvcc, all in parallel, in a directory
of its own under DIR with its copy of the headers. For each, the tool prints
ptxas's registers and spills of the bf16 kernels, then the time (CUDA
events, mean of 20 launches after 3 warm-ups) of the dq and the dk/dv
kernel, or of the forward without and with the log-sum-exp, at
training-step shapes with scenes back to back and padding at the tail, and
whether its results are bit-equal to the source as it is.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

from cdsegnet_torch.ops import flash_attention as fa
from cdsegnet_torch.tools.profile_ssi import card_name
from cdsegnet_torch.utils.cuda_build import CSRC, NVCC_FLAGS, _nvcc

NO_EXP = ('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));', "y = x;")
# source -> variant -> (old, new) substitutions, each made in whichever of
# the variant's files holds the text
VARIANTS = {
    fa.BWD_KERNEL: {
        "as_is": [],
        "no_exp": [NO_EXP],
        "tile_64": [("constexpr int kCols = 128;", "constexpr int kCols = 64;")],
        "warps_4": [("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")],
        "warps_16": [("constexpr int kWarps = 8;", "constexpr int kWarps = 16;")],
    },
    fa.KERNEL: {
        "as_is": [],
        "no_exp": [NO_EXP],
        "tile_64": [("constexpr int kCols = 128;", "constexpr int kCols = 64;")],
        "warps_4": [("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")],
        "warps_16": [("constexpr int kWarps = 8;", "constexpr int kWarps = 16;")],
        "chunk_16": [("constexpr int kChunk = 32;", "constexpr int kChunk = 16;")],
        "chunk_64": [("constexpr int kChunk = 32;", "constexpr int kChunk = 64;")],
        "chunk_128": [("constexpr int kChunk = 32;", "constexpr int kChunk = 128;")],
    },
}
# (N, H, D, patch, scene sizes): level-0, level-2 and level-4 shapes of the
# training step, and scenes cut at offsets that are not multiples of 8
SHAPES = ((204800, 2, 16, 1024, [92160, 92160]), (51200, 8, 16, 1024, [23040, 23040]),
          (4096, 32, 16, 1024, [1843, 1843]), (8192, 2, 16, 1024, [2500, 3100, 1772]))
_P, _I = ctypes.c_void_p, ctypes.c_int
SYMBOLS = {fa.BWD_KERNEL: {"cdseg_patch_attention_bwd_dq": 10,
                           "cdseg_patch_attention_bwd_dkdv": 10},
           fa.KERNEL: {"cdseg_patch_attention_fwd": 7}}


def kernel_label(mangled: str) -> str:
    """``fwd``, ``fwd_lse``, ``dq`` or ``dkdv``, and the head dim, of a bf16
    kernel's mangled name."""
    dim = re.search(r"ILi(\d+)E", mangled).group(1)
    if "fwd_mma" in mangled:
        which = "fwd_lse" if re.search(r"ILi\d+ELb1E", mangled) else "fwd"
    else:
        which = "dq" if "dq_mma" in mangled else "dkdv"
    return f"{which} D={dim}"


def write_variant(out: Path, source: str, src_dir: Path, subs) -> Path:
    """Copy ``source``.cu and the headers of ``src_dir`` into ``out`` with
    the substitutions made; returns the .cu path."""
    out.mkdir(parents=True, exist_ok=True)
    files = {p.name: p.read_text() for p in [src_dir / f"{source}.cu",
                                               *sorted(src_dir.glob("*.cuh"))]}
    for old, new in subs:
        holders = [name for name, text in files.items() if old in text]
        if not holders:
            raise RuntimeError(f"{out}: {old!r} not in {sorted(files)}")
        for name in holders:
            files[name] = files[name].replace(old, new)
    for name, text in files.items():
        (out / name).write_text(text)
    return out / f"{source}.cu"


def build(out: str, baseline: str | None):
    """Build every variant in parallel; returns {source: {variant: CDLL}}."""
    procs = {}
    for source, variants in VARIANTS.items():
        cases = {name: (CSRC, subs) for name, subs in variants.items()}
        if baseline:
            cases["baseline"] = (Path(baseline), [])
        for name, (src_dir, subs) in cases.items():
            shutil.rmtree(Path(out) / source / name, ignore_errors=True)
            cu = write_variant(Path(out) / source / name, source, src_dir, subs)
            procs[source, name] = (cu.with_suffix(".so"), subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs: dict = {source: {} for source in VARIANTS}
    for (source, name), (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source} {name}:\n{log}")
        kernel = None
        for line in log.splitlines():
            m = re.search(r"entry function '(\S+)'", line)
            kernel = m.group(1) if m else kernel
            if kernel and "_mma_" in kernel and ("registers" in line or "spill" in line):
                print(f"ptxas {name} {kernel_label(kernel)}: {line.strip()}", flush=True)
        lib = libs[source][name] = ctypes.CDLL(str(so))
        for symbol, n_ptrs in SYMBOLS[source].items():
            fn = getattr(lib, symbol)
            fn.argtypes = [_P] * n_ptrs + [_I] * 4 + [ctypes.c_float, _I, _P]
            fn.restype = _I
    return libs


def event_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_backward(libs, shape, q, k, v, g, batch, valid, patch, scale, stream):
    n, h, d = shape
    out, lse = fa._launch_fwd(q, k, v, batch, valid, patch, scale, with_lse=True)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((n, h), device="cuda")
    ref = None
    for name, lib in libs.items():
        run_dq = lambda: lib.cdseg_patch_attention_bwd_dq(  # noqa: E731
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
            lse.data_ptr(), batch.data_ptr(), valid.data_ptr(), dq.data_ptr(),
            delta.data_ptr(), n, h, d, patch, scale, 1, stream)
        run_dkdv = lambda: lib.cdseg_patch_attention_bwd_dkdv(  # noqa: E731
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), batch.data_ptr(), valid.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), n, h, d, patch, scale, 1, stream)
        if run_dq() or run_dkdv():
            raise RuntimeError(f"variant {name} failed to launch")
        grads = tuple(x.clone() for x in (dq, delta, dk, dv))
        ref = grads if ref is None else ref
        same = all(torch.equal(a, b) for a, b in zip(ref, grads))
        print(f"{shape} bwd {name}: dq {event_ms(run_dq):.4f} ms, dk/dv "
              f"{event_ms(run_dkdv):.4f} ms, bit-equal to as_is: {same}", flush=True)


def time_forward(libs, shape, q, k, v, batch, valid, patch, scale, stream):
    n, h, d = shape
    out, out_lse = torch.empty_like(q), torch.empty_like(q)
    lse = torch.empty((n, h), device="cuda")
    ref = None
    for name, lib in libs.items():
        def run(o, lse_ptr):
            return lib.cdseg_patch_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), batch.data_ptr(),
                valid.data_ptr(), o.data_ptr(), lse_ptr, n, h, d, patch, scale, 1, stream)
        run_plain = lambda: run(out, None)  # noqa: E731
        run_lse = lambda: run(out_lse, lse.data_ptr())  # noqa: E731
        if run_plain() or run_lse():
            raise RuntimeError(f"variant {name} failed to launch")
        results = tuple(x.clone() for x in (out, out_lse, lse))
        ref = results if ref is None else ref
        same = all(torch.equal(a, b) for a, b in zip(ref, results))
        print(f"{shape} fwd {name}: fwd {event_ms(run_plain):.4f} ms, fwd with lse "
              f"{event_ms(run_lse):.4f} ms, bit-equal to as_is: {same}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="directory for the variants' builds")
    ap.add_argument("--baseline", help="a csrc/ directory to build each source from "
                    "as well, e.g. the parent commit's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bwd_variants needs a CUDA device")
    os.makedirs(args.out, exist_ok=True)
    print(card_name(), flush=True)
    libs = build(args.out, args.baseline)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for n, h, d, patch, sizes in SHAPES:
        batch = torch.full((n,), len(sizes), dtype=torch.int32)
        start = 0
        for s, size in enumerate(sizes):
            batch[start:start + size] = s
            start += size
        batch, valid = batch.cuda(), torch.arange(n, device="cuda") < start
        q, k, v, g = (torch.randn((n, h, d), generator=gen, device="cuda").bfloat16()
                      for _ in range(4))
        g = torch.where(valid[:, None, None], g, 0.0).bfloat16()
        scale = d ** -0.5
        time_backward(libs[fa.BWD_KERNEL], (n, h, d), q, k, v, g, batch, valid, patch,
                      scale, stream)
        time_forward(libs[fa.KERNEL], (n, h, d), q, k, v, batch, valid, patch, scale,
                     stream)


if __name__ == "__main__":
    main()
