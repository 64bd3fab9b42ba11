"""Masked patch attention as hand-written CUDA kernels, forward and backward.

Port of `cdsegnet_tpu/ops/pallas/flash_attention.py`. The forward kernel is
`cdsegnet_torch/csrc/patch_attention_fwd.cu`; the backward is two kernels in
`cdsegnet_torch/csrc/patch_attention_bwd.cu` (dq with the row sums delta,
then dk and dv). Each takes bf16 on the tensor cores and f32 on the CUDA
cores, chosen by dtype.
`patch_attention_fwd` is the drop-in for the plain
`ops.attention.patch_attention`: on a CUDA tensor that needs a gradient it
runs the forward kernel with the row log-sum-exp inside a
`torch.autograd.Function` whose backward launches the two backward kernels;
otherwise it launches the forward kernel alone. Each wrapper checks its
inputs, launches on the current stream and counts its launches. On a CPU
tensor the plain version runs instead, under ordinary autograd.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from cdsegnet_torch.ops.attention import patch_attention
from cdsegnet_torch.utils.cuda_build import (
    DTYPE_CODES,
    bind,
    check_launch,
    register_launches,
    stream,
)

KERNEL = "patch_attention_fwd"
BWD_KERNEL = "patch_attention_bwd"
SOURCES = (KERNEL, BWD_KERNEL)
HEAD_DIMS = (16, 32)
_P, _I = ctypes.c_void_p, ctypes.c_int
# after the pointers: N, H, D, patch size, scale, dtype code, stream
_SHAPE_ARGS = (_I,) * 4 + (ctypes.c_float, _I, _P)
_FWD_ARGS = (_P,) * 7 + _SHAPE_ARGS
_BWD_ARGS = (_P,) * 10 + _SHAPE_ARGS


def _check(q, k, v, batch_sorted, valid_sorted, patch_size, *more):
    """Raise on inputs the kernels do not take. ``more`` are further
    ``(name, tensor)`` pairs that must match q (o and g in the backward)."""
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (N, H, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    for name, t in more:
        if t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{name} must match q: {t.dtype} {tuple(t.shape)}")
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
                    ("valid_sorted", valid_sorted)) + tuple(more):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch_fwd(q, k, v, batch_sorted, valid_sorted, patch_size, scale,
                with_lse: bool):
    """The forward kernel: ``(out, lse)``, lse (N, H) f32 or None."""
    n, h, d = q.shape
    out = torch.empty_like(v)
    lse = torch.empty((n, h), dtype=torch.float32, device=q.device) if with_lse else None
    check_launch(bind(KERNEL, "cdseg_patch_attention_fwd", _FWD_ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), batch_sorted.data_ptr(),
        valid_sorted.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), n, h, d, patch_size,
        float(scale), DTYPE_CODES[q.dtype], stream(q)), KERNEL)
    patch_attention_fwd.launches += 1
    patch_attention_fwd.lse_launches += int(with_lse)
    return out, lse


def patch_attention_bwd_dq(q, k, v, out, g, lse, batch_sorted, valid_sorted,
                           patch_size: int, scale: float):
    """The dq kernel: ``(dq, delta)`` with delta = rowsum(g * out), (N, H)
    f32. CUDA tensors only."""
    _check(q, k, v, batch_sorted, valid_sorted, patch_size, ("out", out), ("g", g))
    n, h, d = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty((n, h), dtype=torch.float32, device=q.device)
    check_launch(bind(BWD_KERNEL, "cdseg_patch_attention_bwd_dq", _BWD_ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
        lse.data_ptr(), batch_sorted.data_ptr(), valid_sorted.data_ptr(),
        dq.data_ptr(), delta.data_ptr(), n, h, d, patch_size, float(scale),
        DTYPE_CODES[q.dtype], stream(q)), "patch_attention_bwd_dq")
    patch_attention_bwd_dq.launches += 1
    return dq, delta


def patch_attention_bwd_dkdv(q, k, v, g, lse, delta, batch_sorted, valid_sorted,
                             patch_size: int, scale: float):
    """The dk/dv kernel, after `patch_attention_bwd_dq`: ``(dk, dv)``. CUDA
    tensors only."""
    _check(q, k, v, batch_sorted, valid_sorted, patch_size, ("g", g))
    n, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    check_launch(bind(BWD_KERNEL, "cdseg_patch_attention_bwd_dkdv", _BWD_ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), batch_sorted.data_ptr(), valid_sorted.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), n, h, d, patch_size, float(scale),
        DTYPE_CODES[q.dtype], stream(q)), "patch_attention_bwd_dkdv")
    patch_attention_bwd_dkdv.launches += 1
    return dk, dv


class _PatchAttention(torch.autograd.Function):
    """Forward kernel with the row log-sum-exp; backward kernels for the
    gradients of q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, batch_sorted, valid_sorted, patch_size, scale):
        out, lse = _launch_fwd(q, k, v, batch_sorted, valid_sorted, patch_size,
                               scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, batch_sorted, valid_sorted)
        ctx.patch_size, ctx.scale = patch_size, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, batch_sorted, valid_sorted = ctx.saved_tensors
        g = g.contiguous()
        dq, delta = patch_attention_bwd_dq(q, k, v, out, g, lse, batch_sorted,
                                           valid_sorted, ctx.patch_size, ctx.scale)
        dk, dv = patch_attention_bwd_dkdv(q, k, v, g, lse, delta, batch_sorted,
                                          valid_sorted, ctx.patch_size, ctx.scale)
        return dq, dk, dv, None, None, None, None


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
    """Drop-in for `patch_attention` (same contract), differentiable.

    On a CUDA tensor it launches the kernels, which compute the softmax in
    float32 whatever ``upcast_softmax`` says (as the TPU kernels do) and
    treat rows that have no allowed key as zeros (forward) with zero
    gradient (backward); it raises on inputs the kernels do not take. When
    autograd needs a gradient of q, k or v, the forward also writes the row
    log-sum-exp for the backward kernels. On a CPU tensor it runs
    `patch_attention` under ordinary autograd.
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
        return _PatchAttention.apply(q, k, v, batch_sorted, valid_sorted,
                                     patch_size, float(scale))
    return _launch_fwd(q, k, v, batch_sorted, valid_sorted, patch_size, scale,
                       with_lse=False)[0]


register_launches("fwd", patch_attention_fwd)
register_launches("fwd_lse", patch_attention_fwd, "lse_launches")
register_launches("dq", patch_attention_bwd_dq)
register_launches("dkdv", patch_attention_bwd_dkdv)


def attention_impl(use_pallas: Optional[bool] = None):
    """The attention implementation: the kernel wrapper by default (which
    runs the plain version on CPU tensors), the plain version when
    ``use_pallas`` is False."""
    return patch_attention if use_pallas is False else patch_attention_fwd
