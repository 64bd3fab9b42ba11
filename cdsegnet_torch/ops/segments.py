"""Sorted-segment reductions with static capacity.

Port of `cdsegnet_tpu/ops/segments.py`. Segment ids come from sorted keys by
a boundary cumsum; reductions scatter into ``num_segments`` rows. Ids must lie
in ``[0, num_segments)`` (callers clamp them, as the JAX package does).
"""

from __future__ import annotations

from typing import Optional

import torch


def sorted_segment_ids(keys_sorted: torch.Tensor) -> torch.Tensor:
    """Segment index per sorted position: 0,0,1,1,1,2,... for equal-key runs."""
    boundary = torch.ones_like(keys_sorted, dtype=torch.int64)
    boundary[1:] = (keys_sorted[1:] != keys_sorted[:-1]).to(torch.int64)
    return torch.cumsum(boundary, 0) - 1


def _bc(valid: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return valid.reshape(valid.shape + (1,) * (ref.dim() - valid.dim()))


def segment_any(
    valid: torch.Tensor, seg_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    cnt = torch.zeros(num_segments, dtype=torch.int32, device=valid.device)
    cnt.index_add_(0, seg_ids, valid.to(torch.int32))
    return cnt > 0


def _sum_in_order(values_sorted: torch.Tensor, seg_ids: torch.Tensor,
                  num_segments: int, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Per segment, the sum of its valid rows taken one after another in
    their order on every device, so that it repeats from run to run (the
    kNN tables of a metric level rank near-ties by its mean's bits). The
    CPU's ``index_add_`` adds in order; on CUDA its atomics add in any
    order, so the accumulating ``index_put_`` sorts the ids stably and sums
    each run in one thread, bit-equal to the CPU. There an invalid row goes
    to a row of its own past the segments, so that no long run of padding
    is summed serially."""
    if valid is not None:
        values_sorted = torch.where(_bc(valid, values_sorted), values_sorted,
                                    torch.zeros_like(values_sorted))
    tail = tuple(values_sorted.shape[1:])
    if not values_sorted.is_cuda:
        s = torch.zeros((num_segments,) + tail, dtype=values_sorted.dtype,
                        device=values_sorted.device)
        return s.index_add_(0, seg_ids, values_sorted)
    n = values_sorted.shape[0]
    ids = seg_ids.long()
    if valid is not None:
        ids = torch.where(valid, ids,
                          num_segments + torch.arange(n, device=values_sorted.device))
    s = torch.zeros((num_segments + n,) + tail, dtype=values_sorted.dtype,
                    device=values_sorted.device)
    return s.index_put_((ids,), values_sorted, accumulate=True)[:num_segments]


def segment_reduce(
    values_sorted: torch.Tensor,
    seg_ids: torch.Tensor,
    num_segments: int,
    reduce: str = "max",
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reduce ``values_sorted`` over segment ids into ``num_segments`` rows.

    Invalid rows (``valid=False``) never contribute; empty segments yield 0.
    """
    shape = (num_segments,) + tuple(values_sorted.shape[1:])
    if reduce == "max":
        if valid is not None:
            neutral = torch.finfo(values_sorted.dtype).min
            values_sorted = torch.where(
                _bc(valid, values_sorted), values_sorted,
                torch.full((), neutral, dtype=values_sorted.dtype,
                           device=values_sorted.device),
            )
        # -inf, never a row's value: the backward splits the gradient among
        # the rows equal to the max and would count an equal initial value
        # as one of them, though include_self=False leaves it out of the
        # max. An empty segment keeps -inf, made 0 below.
        out = torch.full(shape, float("-inf"), dtype=values_sorted.dtype,
                         device=values_sorted.device)
        idx = _bc(seg_ids.long(), values_sorted).expand_as(values_sorted)
        out.scatter_reduce_(0, idx, values_sorted, "amax", include_self=False)
        out = torch.where(torch.isfinite(out.float()), out, torch.zeros_like(out))
        if valid is not None:
            has = segment_any(valid, seg_ids, num_segments)
            out = torch.where(_bc(has, out), out, torch.zeros_like(out))
        return out
    if reduce == "mean":
        ones = torch.ones(values_sorted.shape[:1], dtype=values_sorted.dtype,
                          device=values_sorted.device)
        if valid is not None:
            ones = torch.where(valid, ones, torch.zeros_like(ones))
        cnt = torch.zeros(num_segments, dtype=values_sorted.dtype,
                          device=values_sorted.device)
        cnt.index_add_(0, seg_ids, ones)
        s = _sum_in_order(values_sorted, seg_ids, num_segments, valid)
        return s / _bc(torch.clamp(cnt, min=1), s)
    raise ValueError(f"unsupported reduce {reduce!r}")


def segment_first_position(
    seg_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """First sorted position of each segment (its 'head'); n-1 for empty ones."""
    n = seg_ids.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=seg_ids.device)
    out = torch.full((num_segments,), n - 1, dtype=torch.int64,
                     device=seg_ids.device)
    out.scatter_reduce_(0, seg_ids.long(), pos, "amin", include_self=True)
    return out
