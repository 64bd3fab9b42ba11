"""Masked patch attention forward as a hand-written CUDA kernel.

Port of `cdsegnet_tpu/ops/pallas/flash_attention.py` (forward only; the
backward kernel comes with training). The kernel is
`cdsegnet_torch/csrc/patch_attention_fwd.cu`; this module checks its inputs,
launches it on the current stream and counts the launches. On a CPU tensor
the wrapper runs the plain version, `ops.attention.patch_attention`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from cdsegnet_torch.ops.attention import patch_attention
from cdsegnet_torch.utils.cuda_build import load_library

KERNEL = "patch_attention_fwd"
HEAD_DIMS = (16, 32)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library(KERNEL).cdseg_patch_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, batch_sorted, valid_sorted, patch_size):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (N, H, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    n, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (built for {HEAD_DIMS})")
    if n == 0 or patch_size <= 0 or n % patch_size:
        raise ValueError(f"N={n} must be a positive multiple of "
                         f"patch_size={patch_size}")
    if n // patch_size > 65535 or h > 65535:
        raise ValueError(f"grid too large: {n // patch_size} patches, {h} heads")
    if batch_sorted.dtype != torch.int32 or batch_sorted.shape != (n,):
        raise TypeError("batch_sorted must be int32 of shape (N,)")
    if valid_sorted.dtype != torch.bool or valid_sorted.shape != (n,):
        raise TypeError("valid_sorted must be bool of shape (N,)")
    for name, t in (("q", q), ("k", k), ("v", v), ("batch_sorted", batch_sorted),
                    ("valid_sorted", valid_sorted)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def patch_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    batch_sorted: torch.Tensor,
    valid_sorted: torch.Tensor,
    patch_size: int,
    scale: float,
    upcast_softmax: bool = True,
) -> torch.Tensor:
    """Drop-in for `patch_attention` (same contract).

    On a CUDA tensor it launches the kernel, which computes the softmax in
    float32 whatever ``upcast_softmax`` says (as the TPU kernel does) and
    writes zeros on rows that have no allowed key; it raises on inputs the
    kernel does not take. On a CPU tensor it runs `patch_attention`.
    """
    if q.device.type == "cpu":
        return patch_attention(q, k, v, batch_sorted, valid_sorted,
                               patch_size, scale,
                               upcast_softmax=upcast_softmax)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, batch_sorted, valid_sorted, patch_size)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("patch_attention_fwd has no backward kernel yet; "
                           "call it under torch.no_grad()")
    n, h, d = q.shape
    out = torch.empty_like(v)
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), batch_sorted.data_ptr(),
        valid_sorted.data_ptr(), out.data_ptr(), n, h, d, patch_size,
        float(scale), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"patch_attention_fwd launch failed: CUDA error {err}")
    patch_attention_fwd.launches += 1
    return out


patch_attention_fwd.launches = 0


def attention_impl(use_pallas: Optional[bool] = None):
    """The attention implementation: the kernel wrapper by default (which
    runs the plain version on CPU tensors), the plain version when
    ``use_pallas`` is False."""
    return patch_attention if use_pallas is False else patch_attention_fwd
