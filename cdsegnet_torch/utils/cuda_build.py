"""Build the port's CUDA sources with ``nvcc``, load and bind them with
ctypes, and keep the kernels' launch counters.

Each ``cdsegnet_torch/csrc/<name>.cu`` has a plain C interface and compiles
into ``cdsegnet_torch/_build/<name>-<hash>.so``, where the hash covers the
source, the shared headers (``csrc/*.cuh``) and the compiler flags, so an
edited source or header builds anew. Builds happen at first use.

The kernel wrappers (`cdsegnet_torch.ops`) launch through `bind`, `stream`,
`DTYPE_CODES` and `check_launch`, and list their launch counters (attributes
of their own functions) with `register_launches`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the dtype argument of the attention and conv kernels
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LOADED: Dict[str, ctypes.CDLL] = {}
_COUNTERS: Dict[str, Tuple[object, str]] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: the hash covers the source, every
    shared header ``csrc/*.cuh`` and the compiler flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the build of ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(*names: str) -> Dict[str, float]:
    """Compile each ``csrc/<name>.cu`` that is not built yet, one ``nvcc``
    per source, all started together. Returns the seconds each build took
    (0 for a source that was built already)."""
    start = time.perf_counter()
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running[name] = (proc, tmp, out)
    took = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in running.items():
        log = proc.communicate()[0]
        took[name] = time.perf_counter() - start
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return took


def sass_counts(name: str, opcode: str) -> Dict[str, int]:
    """Instructions with ``opcode`` (e.g. ``HMMA``, the tensor-core product)
    in each kernel of the built ``csrc/<name>.cu``, from ``cuobjdump -sass``:
    mangled kernel name -> count."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(library_path(name))], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    counts: Dict[str, int] = {}
    fn = None
    pattern = re.compile(rf"\b{re.escape(opcode)}\b")
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function : "):
            fn = line[len("Function : "):]
            counts[fn] = 0
        elif fn is not None and pattern.search(line):
            counts[fn] += 1
    return counts


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if missing."""
    lib = _LOADED.get(name)
    if lib is None:
        build(name)
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib


@functools.lru_cache(maxsize=None)
def bind(name: str, symbol: str, argtypes: Tuple[type, ...]):
    """The C function ``symbol`` of ``csrc/<name>.cu`` (built if missing),
    taking ``argtypes`` (ctypes types) and returning an ``int``."""
    fn = getattr(load_library(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def stream(x: torch.Tensor) -> int:
    """The handle of the current CUDA stream of ``x``'s device."""
    return torch.cuda.current_stream(x.device).cuda_stream


def check_launch(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def register_launches(name: str, owner, attr: str = "launches") -> None:
    """Set ``owner.<attr>``, a wrapper's launch count, to 0 and list it as
    counter ``name`` of `launch_counts`."""
    setattr(owner, attr, 0)
    _COUNTERS[name] = (owner, attr)


def launch_counts() -> Dict[str, int]:
    """Every registered launch counter by name."""
    return {name: getattr(owner, attr) for name, (owner, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    """Set every registered launch counter to 0."""
    for owner, attr in _COUNTERS.values():
        setattr(owner, attr, 0)
