"""Masked patch attention over serialized order: the plain PyTorch versions.

Port of `cdsegnet_tpu/ops/attention.py`. Every level keeps one flat sorted
array, reshaped to ``(num_patches, patch_size)``; cross-scene and padding keys
are masked out. `patch_attention` is the reference that the CUDA kernel
(`cdsegnet_torch.ops.flash_attention`) is held against, and the route the
port takes on the CPU. With ``bias=`` (the relative-position bias of
``enable_rpe``) it is the only route on any device, as in JAX, where the
biased attention is XLA and never the Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9


def _logits(qp, kp, scale, upcast_softmax):
    acc_t = torch.float32 if upcast_softmax else qp.dtype
    logits = torch.einsum("pihd,pjhd->phij", qp.to(acc_t), kp.to(acc_t))
    return logits * torch.tensor(scale, dtype=acc_t, device=logits.device)


def patch_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    batch_sorted: torch.Tensor,
    valid_sorted: torch.Tensor,
    patch_size: int,
    scale: float,
    upcast_softmax: bool = True,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked patch attention over serialized order.

    Args:
      q, k, v: (N, H, D) in serialized order.
      batch_sorted: (N,) scene ids in serialized order (pads carry the
        sentinel id).
      valid_sorted: (N,) bool validity in serialized order.
      patch_size: window size K; N must be a multiple of K.
      scale: softmax scale (usually D**-0.5).
      upcast_softmax: compute logits and softmax in float32.
      bias: optional (P, H, K, K) additive logit bias, added in the logits'
        dtype after the scale.

    Returns:
      (N, H, D) attention output in serialized order, dtype of ``v``.
    """
    n, h, d = q.shape
    if n % patch_size:
        raise ValueError(f"N={n} is not a multiple of patch_size={patch_size}")
    p = n // patch_size
    qp = q.reshape(p, patch_size, h, d)
    kp = k.reshape(p, patch_size, h, d)
    vp = v.reshape(p, patch_size, h, d)
    bp = batch_sorted.reshape(p, patch_size)
    mp = valid_sorted.reshape(p, patch_size)

    logits = _logits(qp, kp, scale, upcast_softmax)
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    allowed = (bp[:, :, None] == bp[:, None, :]) & mp[:, None, :]
    logits = logits.masked_fill(~allowed[:, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("phij,pjhd->pihd", probs, vp)
    return out.reshape(n, h, d)


def cross_patch_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_batch_sorted: torch.Tensor,
    q_valid_sorted: torch.Tensor,
    kv_batch_sorted: torch.Tensor,
    kv_valid_sorted: torch.Tensor,
    q_patch_size: int,
    kv_patch_size: int,
    scale: float,
    upcast_softmax: bool = True,
) -> torch.Tensor:
    """Masked cross attention between two serialized point sets.

    Queries come from one branch and keys/values from the other, each in its
    own serialized order and windowed into the same number of patches.
    """
    del q_valid_sorted  # invalid query rows are unspecified, as in JAX
    nq, h, d = q.shape
    nk = k.shape[0]
    pq = nq // q_patch_size
    if nk // kv_patch_size != pq:
        raise ValueError(f"patch counts differ: {pq} vs {nk // kv_patch_size}")
    qp = q.reshape(pq, q_patch_size, h, d)
    kp = k.reshape(pq, kv_patch_size, h, d)
    vp = v.reshape(pq, kv_patch_size, h, d)
    qb = q_batch_sorted.reshape(pq, q_patch_size)
    kb = kv_batch_sorted.reshape(pq, kv_patch_size)
    kv_ok = kv_valid_sorted.reshape(pq, kv_patch_size)

    logits = _logits(qp, kp, scale, upcast_softmax)
    allowed = (qb[:, :, None] == kb[:, None, :]) & kv_ok[:, None, :]
    logits = logits.masked_fill(~allowed[:, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    # a query whose scene has no key in the aligned window would get a
    # uniform distribution over masked slots; zero it instead
    any_ok = allowed.any(dim=-1)  # (P, Kq)
    probs = torch.where(any_ok[:, None, :, None], probs,
                        torch.zeros_like(probs)).to(v.dtype)
    out = torch.einsum("phij,pjhd->pihd", probs, vp)
    return out.reshape(nq, h, d)
