"""Submanifold sparse convolution as a neighbor gather plus one matmul.

Port of `cdsegnet_tpu/ops/subm_conv.py`. Outputs exist only at input sites.
The weight layout is ``(K, C_in, C_out)`` with K in `kernel_offsets` order;
a missing neighbor (index N in the table) reads a zero row appended to the
features, so no index ever falls outside the gathered tensor.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from cdsegnet_torch.models.structure import _parity_bits, _parity_select_tables


class _GatherRows(torch.autograd.Function):
    """``table.index_select(0, idx)`` for a table whose row ``skip`` is a
    constant (the zero row that missing neighbors read). The backward
    scatters with `index_add_` and drops the entries that read ``skip``:
    they are most of a sparse table's entries, and autograd's own backward
    of ``table[idx]`` sums each run of equal indices serially on the GPU,
    which made the training step some 75 times slower (PERF.md, PR 2)."""

    @staticmethod
    def forward(ctx, table, idx, skip):
        ctx.save_for_backward(idx)
        ctx.rows, ctx.skip = table.shape[0], skip
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        keep = idx != ctx.skip
        # a dropped entry adds zero to a row of its own choosing, so no row
        # collects a long run; the sums are taken in float32
        spread = torch.arange(idx.numel(), device=idx.device) % ctx.rows
        target = torch.where(keep, idx.long(), spread)
        vals = torch.where(keep.reshape((-1,) + (1,) * (g.dim() - 1)), g.float(), 0.0)
        out = torch.zeros((ctx.rows,) + tuple(g.shape[1:]), dtype=torch.float32,
                          device=g.device).index_add_(0, target, vals)
        return out.to(g.dtype), None, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor, skip: int) -> torch.Tensor:
    """``table[idx]`` for 1-d ``idx``, where row ``skip`` of ``table`` is a
    constant that receives no gradient."""
    return _GatherRows.apply(table, idx, skip)


def _gather_rows(feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``feat[idx]`` where index ``len(feat)`` reads a zero row."""
    padded = torch.cat([feat, feat.new_zeros((1,) + tuple(feat.shape[1:]))])
    return gather_rows(padded, idx.reshape(-1), len(feat))


def subm_conv_apply(
    feat: torch.Tensor,
    neighbor_idx: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Apply a submanifold conv.

    Args:
      feat: (N, C_in) features.
      neighbor_idx: (N, K) int; value N marks missing neighbors.
      weight: (K, C_in, C_out).
      bias: optional (C_out,).

    Returns:
      (N, C_out) in ``feat.dtype`` (float32 accumulation).
    """
    n, c_in = feat.shape
    k = neighbor_idx.shape[1]
    if weight.shape[0] != k:
        raise ValueError(f"weight taps {weight.shape[0]} != table width {k}")
    g = _gather_rows(feat, neighbor_idx).reshape(n, k * c_in)
    out = g @ weight.reshape(k * c_in, -1).to(feat.dtype)
    if bias is not None:
        out = out + bias.to(feat.dtype)
    return out


def _block_diagonal(weight_a, weight_b, dtype):
    """(K, Ca, Coa), (K, Cb, Cob) -> (K, Ca+Cb, Coa+Cob) with zero
    off-diagonal blocks."""
    k, ca, coa = weight_a.shape
    _, cb, cob = weight_b.shape
    w = weight_a.new_zeros((k, ca + cb, coa + cob), dtype=dtype)
    w[:, :ca, :coa] = weight_a.to(dtype)
    w[:, ca:, coa:] = weight_b.to(dtype)
    return w


def dual_subm_conv_apply(
    feat_a: torch.Tensor,
    feat_b: torch.Tensor,
    neighbor_idx: torch.Tensor,
    weight_a: torch.Tensor,
    weight_b: torch.Tensor,
):
    """Two submanifold convs over the SAME neighbor table with one gather:
    concatenated channels and a block-diagonal weight."""
    coa = weight_a.shape[2]
    cat = torch.cat([feat_a, feat_b.to(feat_a.dtype)], dim=-1)
    w = _block_diagonal(weight_a, weight_b, feat_a.dtype)
    out = subm_conv_apply(cat, neighbor_idx, w)
    return out[:, :coa], out[:, coa:]


def _blocked_stem(cat, pb, row, nbr_rows, w_all, m):
    """Gather + matmul core of the blocked conv: scatter features into an
    (M+1, 8, C) cluster-member table (row M is the empty sentinel), gather
    each point's R adjacent member rows, one matmul, then keep each point's
    own parity slice of the 8 output groups."""
    n, c = cat.shape
    r = nbr_rows.shape[1]
    co = w_all.shape[1] // 8
    members = cat.new_zeros((m + 1, 8, c))
    members[row, pb] = torch.where((row < m)[:, None], cat, torch.zeros_like(cat))
    members[m] = 0  # re-arm the empty sentinel row
    blocks = gather_rows(members.reshape(m + 1, 8 * c), nbr_rows.reshape(-1), m)
    out_all = blocks.reshape(n, r * 8 * c) @ w_all
    ar = torch.arange(n, device=cat.device)
    return out_all.reshape(n, 8, co)[ar, pb]


def blocked_subm_conv_apply(
    feat: torch.Tensor,
    weight: torch.Tensor,
    *,
    grid_coord: torch.Tensor,
    mask: torch.Tensor,
    parent_inverse: torch.Tensor,
    child_nbr: torch.Tensor,
) -> torch.Tensor:
    """k5 (125-tap) submanifold conv via the stride-2 parity structure:
    27 block-row gathers per point instead of 125 row gathers.

    Exact under the same preconditions as the parity neighbor tables: no
    pooled-level overflow and unique voxels per scene. Callers route
    overflowed batches to the gather form.

    Args:
      feat: (N, C) features.
      weight: (125, C, C_out), `kernel_offsets(5)` order.
      grid_coord/mask: level-0 voxels.
      parent_inverse: (N,) level-0 point -> level-1 cluster slot.
      child_nbr: (M1, 27) the level-1 k3 table (missing = M1).
    Returns: (N, C_out) in ``feat.dtype``.
    """
    sel = torch.as_tensor(_parity_select_tables(5), device=feat.device)
    c, co = feat.shape[1], weight.shape[2]
    m = child_nbr.shape[0]

    pb = _parity_bits(grid_coord).long()
    # overflow-cluster parents (slot m-1) and padding go to the trash row
    row = torch.where(mask & (parent_inverse < m - 1), parent_inverse.long(), m)
    nbr_rows = child_nbr[row.clamp(max=m - 1)].long()
    nbr_rows = torch.where((row < m)[:, None], nbr_rows, m)  # (N, 27)

    # parity-scatter the weight to the (216, C) block layout: slot
    # sel[g, k] of parity class g holds kernel tap k
    g_idx = torch.arange(8, device=feat.device).repeat_interleave(125)
    k_idx = torch.arange(125, device=feat.device).repeat(8)
    w_all = feat.new_zeros((216, c, 8, co))
    w_all[sel.reshape(-1), :, g_idx, :] = weight.to(feat.dtype)[k_idx]
    return _blocked_stem(feat, pb, row, nbr_rows,
                         w_all.reshape(216 * c, 8 * co), m)


def blocked_stem_apply(
    feat_a: torch.Tensor,
    feat_b: torch.Tensor,
    weight_a: torch.Tensor,
    weight_b: torch.Tensor,
    *,
    grid_coord: torch.Tensor,
    mask: torch.Tensor,
    parent_inverse: torch.Tensor,
    child_nbr: torch.Tensor,
):
    """Dual-branch k5 stem via `blocked_subm_conv_apply`: concatenated
    branch channels, block-diagonal weight, one shared block gather."""
    coa = weight_a.shape[2]
    cat = torch.cat([feat_a, feat_b.to(feat_a.dtype)], dim=-1)
    w = _block_diagonal(weight_a, weight_b, cat.dtype)
    out = blocked_subm_conv_apply(
        cat, w, grid_coord=grid_coord, mask=mask,
        parent_inverse=parent_inverse, child_nbr=child_nbr,
    )
    return out[:, :coa], out[:, coa:]


@functools.lru_cache(maxsize=None)
def _blocked_k3_tables():
    """Static tables of the k3 blocked form: ``cols8[g]``, the 8 of the
    child k3 row's 27 columns that are the parity-relevant octant of parity
    class g (per axis the offsets {pb-1, pb}: a point's 27 taps lie in those
    clusters); ``sel[g, k]``, the flat (local cluster * 8 + parity) slot of
    tap k for parity class g (injective per g)."""
    offs = [(x, y, z) for x in (-1, 0, 1) for y in (-1, 0, 1) for z in (-1, 0, 1)]
    cols8 = np.zeros((8, 8), np.int64)
    sel = np.zeros((8, 27), np.int64)
    for g in range(8):
        pb = ((g >> 2) & 1, (g >> 1) & 1, g & 1)
        for loc in range(8):
            b = ((loc >> 2) & 1, (loc >> 1) & 1, loc & 1)
            e = [pb[a] - 1 + b[a] for a in range(3)]
            cols8[g, loc] = ((e[0] + 1) * 3 + (e[1] + 1)) * 3 + (e[2] + 1)
        for k, d in enumerate(offs):
            e = [(pb[a] + d[a]) // 2 for a in range(3)]
            r = [(pb[a] + d[a]) % 2 for a in range(3)]
            b = [e[a] - (pb[a] - 1) for a in range(3)]
            loc = (b[0] << 2) | (b[1] << 1) | b[2]
            sel[g, k] = loc * 8 + ((r[0] << 2) | (r[1] << 1) | r[2])
    return cols8, sel


def blocked_k3_conv_apply(
    feat: torch.Tensor,
    weight: torch.Tensor,
    *,
    grid_coord: torch.Tensor,
    mask: torch.Tensor,
    parent_inverse: torch.Tensor,
    child_nbr: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """k3 (27-tap) submanifold conv via the stride-2 parity structure: 8
    block-row gathers of 8C channels per point instead of 27 row gathers,
    and one parity-scattered (64C, 8 C_out) matmul (the k3 form of
    `blocked_subm_conv_apply`; the xCPE of ``xcpe_mode`` "blocked" and
    "cond"). Exact under the same preconditions: no pooled-level overflow.

    Args:
      feat: (N, C); weight: (27, C, C_out) in `kernel_offsets(3)` order.
      grid_coord/mask: this level's voxels (level L).
      parent_inverse: (N,) level-L point -> level-(L+1) cluster slot.
      child_nbr: (M, 27) the level-(L+1) k3 table (missing = M).
    Returns: (N, C_out) in ``feat.dtype``.
    """
    cols8_np, sel_np = _blocked_k3_tables()
    cols8 = torch.as_tensor(cols8_np, device=feat.device)
    sel = torch.as_tensor(sel_np, device=feat.device)
    c, co = feat.shape[1], weight.shape[2]
    m = child_nbr.shape[0]

    pb = _parity_bits(grid_coord).long()
    row = torch.where(mask & (parent_inverse < m - 1), parent_inverse.long(), m)
    nbr27 = child_nbr[row.clamp(max=m - 1)].long()
    nbr27 = torch.where((row < m)[:, None], nbr27, m)  # (N, 27)
    # each point's parity-relevant octant of its cluster's k3 row
    nbr8 = torch.gather(nbr27, 1, cols8[pb])

    g_idx = torch.arange(8, device=feat.device).repeat_interleave(27)
    k_idx = torch.arange(27, device=feat.device).repeat(8)
    w_all = feat.new_zeros((64, c, 8, co))
    w_all[sel.reshape(-1), :, g_idx, :] = weight.to(feat.dtype)[k_idx]
    out = _blocked_stem(feat, pb, row, nbr8, w_all.reshape(64 * c, 8 * co), m)
    return out if bias is None else out + bias.to(out.dtype)
