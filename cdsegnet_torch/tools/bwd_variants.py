"""Time variants of the bf16 attention-backward kernels on one GPU.

Usage, from the root of a checkout::

    python -m cdsegnet_torch.tools.bwd_variants --out DIR

Each variant is `cdsegnet_torch/csrc/patch_attention_bwd.cu` with text
substitutions: the tile size, the warps per block, or, for timing only, the
exponential replaced by the identity (which shows how much the SFU binds).
All variants build with nvcc in parallel into DIR. For each, the tool prints
ptxas's registers and spills of the bf16 kernels, then the time of the dq
and the dk/dv kernel (CUDA events, mean of 20 launches after 3 warm-ups) at
training-step shapes with scenes back to back and padding at the tail, and
whether its gradients are bit-equal to the source as it is.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess

import torch

from cdsegnet_torch.ops import flash_attention as fa
from cdsegnet_torch.tools.profile_ssi import card_name
from cdsegnet_torch.utils.cuda_build import CSRC, NVCC_FLAGS, _nvcc

VARIANTS = {
    "as_is": [],
    "no_exp": [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));', "y = x;")],
    "tile_64": [("constexpr int kCols = 128;", "constexpr int kCols = 64;")],
    "warps_4": [("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")],
    "warps_16": [("constexpr int kWarps = 8;", "constexpr int kWarps = 16;")],
}
# (N, H, D, patch, scene sizes): level-0, level-2 and level-4 shapes of the
# training step, and scenes cut at offsets that are not multiples of 8
SHAPES = ((204800, 2, 16, 1024, [92160, 92160]), (51200, 8, 16, 1024, [23040, 23040]),
          (4096, 32, 16, 1024, [1843, 1843]), (8192, 2, 16, 1024, [2500, 3100, 1772]))


def build(out: str):
    src = (CSRC / "patch_attention_bwd.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        path = os.path.join(out, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        kernel = None
        for line in log.splitlines():
            m = re.search(r"entry function '(\S+)'", line)
            kernel = m.group(1) if m else kernel
            if kernel and "_mma_" in kernel and ("registers" in line or "spill" in line):
                which = "dq" if "dq_mma" in kernel else "dkdv"
                dim = re.search(r"ILi(\d+)E", kernel).group(1)
                print(f"ptxas {name} {which} D={dim}: {line.strip()}", flush=True)
        libs[name] = ctypes.CDLL(os.path.join(out, f"{name}.so"))
        for symbol in ("cdseg_patch_attention_bwd_dq", "cdseg_patch_attention_bwd_dkdv"):
            fn = getattr(libs[name], symbol)
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="directory for the variants' builds")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bwd_variants needs a CUDA device")
    os.makedirs(args.out, exist_ok=True)
    print(card_name(), flush=True)
    libs = build(args.out)
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
            grads = tuple(x.clone() for x in (dq, dk, dv))
            ref = grads if ref is None else ref
            same = all(torch.equal(a, b) for a, b in zip(ref, grads))
            print(f"{(n, h, d)} {name}: dq {event_ms(run_dq):.4f} ms, dk/dv "
                  f"{event_ms(run_dkdv):.4f} ms, bit-equal to as_is: {same}", flush=True)


if __name__ == "__main__":
    main()
