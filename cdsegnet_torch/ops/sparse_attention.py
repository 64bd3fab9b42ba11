"""Exact sparse attention over per-query key lists.

Port of `cdsegnet_tpu/ops/sparse_attention.py` (reference `libs/pointops2`
``attention_v2``): each query attends an explicit, private key set, given
as a static-width table ``key_idx (N, S)`` whose missing slots hold N. One
gather and one masked softmax; autograd gives the backward. A learned
relative-position bias over the (query - key) coordinate deltas composes
through the ``rel_bias_fn`` hook (the ``rpe_v2`` analogue).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from cdsegnet_torch.ops.pointops import grouping


def exact_sparse_attention(
    q: torch.Tensor,  # (N, H, D)
    k: torch.Tensor,  # (N, H, D)
    v: torch.Tensor,  # (N, H, D)
    key_idx: torch.Tensor,  # (N, S) key indices; N = missing
    scale: Optional[float] = None,
    rel_bias_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    coords: Optional[torch.Tensor] = None,  # (N, 3) for rel_bias_fn
    upcast_softmax: bool = True,
) -> torch.Tensor:
    """Attention where query i attends keys ``key_idx[i]`` only: ``(N, H,
    D)`` in ``v``'s dtype. ``rel_bias_fn`` takes the (N, S, 3) deltas
    (query - key) and returns an (N, H, S) bias. Missing keys are -inf
    before the softmax and zero after it, so a query with no key gives
    zeros (and a zero gradient)."""
    n, h, d = q.shape
    s = key_idx.shape[1]
    scale = scale if scale is not None else d ** -0.5
    valid = key_idx < n
    kk = grouping(k.reshape(n, h * d), key_idx).reshape(n, s, h, d)
    vv = grouping(v.reshape(n, h * d), key_idx).reshape(n, s, h, d)
    logits = torch.einsum("nhd,nshd->nhs", q * scale, kk)
    if rel_bias_fn is not None:
        if coords is None:
            raise ValueError("rel_bias_fn needs coords")
        kc = grouping(coords, key_idx)
        logits = logits + rel_bias_fn(coords[:, None, :] - kc)
    if upcast_softmax:
        logits = logits.float()
    logits = logits.masked_fill(~valid[:, None, :], float("-inf"))
    attn = torch.softmax(logits, dim=-1)
    attn = torch.where(valid[:, None, :], attn, torch.zeros_like(attn)).to(vv.dtype)
    return torch.einsum("nhs,nshd->nhd", attn, vv)
