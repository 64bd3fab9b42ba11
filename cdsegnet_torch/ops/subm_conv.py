"""Submanifold sparse convolution: a neighbor gather plus one matmul on the
CPU, hand-written implicit-GEMM kernels on the GPU.

Port of `cdsegnet_tpu/ops/subm_conv.py`. Outputs exist only at input sites.
The weight layout is ``(K, C_in, C_out)`` with K in `kernel_offsets` order;
a missing neighbor (index N in the table) reads a zero row.

On a CPU tensor `subm_conv_apply` is the plain version: the gathered
``(N, K C_in)`` rows times the flattened weight, under ordinary autograd. On
a CUDA tensor it launches `cdsegnet_torch/csrc/subm_conv.cu` inside a
`torch.autograd.Function`: the forward kernel reads each neighbor row into
shared memory inside the product and skips the taps that no row of a 64-row
tile reads (bfloat16; float32 keeps the gather + matmul forward, see
`_forward`); the input gradient is the same kernel over the output gradient
with the reflected weight (`reflected_weight`: the tables are symmetric);
the weight gradient is a kernel that sums over the rows of the tiles that
read each tap, in row splits that the wrapper adds in a fixed order. What
autograd keeps is the features, the table and the weight, not the gathered
rows.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from cdsegnet_torch.models.structure import _parity_bits, _parity_select_tables
from cdsegnet_torch.utils.cuda_build import (
    DTYPE_CODES,
    bind,
    check_launch,
    register_launches,
    stream,
)

KERNEL = "subm_conv"
TILE_ROWS = 64  # rows of a tile whose taps a launch skips together
MAX_TAPS = 128
_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = (_P,) * 7 + (_I,) * 7 + (_P,)
_WGRAD_ARGS = (_P,) * 5 + (_I,) * 6 + (_P,)
_SPLITS_ARGS = (_I,) * 6  # N, K, C_in, C_out, dtype code, SMs


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


def _plain_conv(feat, neighbor_idx, weight, bias):
    """The plain version: gather the neighbor rows, one matmul."""
    n, c_in = feat.shape
    k = neighbor_idx.shape[1]
    g = _gather_rows(feat, neighbor_idx).reshape(n, k * c_in)
    out = g @ weight.reshape(k * c_in, -1).to(feat.dtype)
    if bias is not None:
        out = out + bias.to(feat.dtype)
    return out


def subm_conv_apply(
    feat: torch.Tensor,
    neighbor_idx: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Apply a submanifold conv.

    Args:
      feat: (N, C_in) features.
      neighbor_idx: (N, K) int; value N marks missing neighbors. On the GPU
        the table must be symmetric (row i reads j at tap k exactly when j
        reads i at tap K-1-k), as every table `models.structure` builds is.
      weight: (K, C_in, C_out).
      bias: optional (C_out,).

    Returns:
      (N, C_out) in ``feat.dtype`` (float32 accumulation).
    """
    k = neighbor_idx.shape[1]
    if weight.shape[0] != k:
        raise ValueError(f"weight taps {weight.shape[0]} != table width {k}")
    if feat.device.type == "cpu":
        return _plain_conv(feat, neighbor_idx, weight, bias)
    if feat.device.type != "cuda":
        raise ValueError(f"no kernel for device {feat.device}")
    feat, neighbor_idx = feat.contiguous(), neighbor_idx.to(torch.int32).contiguous()
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (feat, weight, bias)):
        return _SubMConvGemm.apply(feat, neighbor_idx, weight, bias)
    return _forward(feat, neighbor_idx, weight, bias, None)


def _forward(feat, neighbor_idx, weight, bias, taps):
    """The conv's value on CUDA tensors; ``taps`` (uint8, when given)
    receives `tile_taps`. bfloat16 runs the forward kernel. float32 keeps
    the plain gather + matmul, whose product is the library's to the bit:
    a sound change of the order of the float32 sums (the kernel's, or the
    plain form's own taken tap by tap) moves SpUNet's first gradients of
    its BatchNorm parameters by about 1e-3 of their norm, past what the
    benchmark's float32 reference allows (PERF.md §6); both gradients
    still run the kernels."""
    if feat.dtype != torch.float32:
        return subm_conv_gemm_fwd(feat, neighbor_idx, weight, bias, tile_taps=taps)
    if taps is not None:
        taps.copy_(tile_taps(neighbor_idx))
    return _plain_conv(feat, neighbor_idx, weight, bias)


# ---------------------------------------------------------------------------
# the kernels' wrappers (CUDA tensors only)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x, neighbor_idx, c_in, what):
    """Raise on inputs the kernels do not take; ``x`` is (N, c_in)."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: features must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != c_in:
        raise ValueError(f"{what}: features {tuple(x.shape)} do not have {c_in} channels")
    if neighbor_idx.dtype != torch.int32 or neighbor_idx.dim() != 2 \
            or neighbor_idx.shape[0] != x.shape[0]:
        raise TypeError(f"{what}: the table must be int32 of shape (N, K), got "
                        f"{neighbor_idx.dtype} {tuple(neighbor_idx.shape)}")
    if not 0 < neighbor_idx.shape[1] <= MAX_TAPS:
        raise ValueError(f"{what}: {neighbor_idx.shape[1]} taps (at most {MAX_TAPS})")
    for name, t in (("features", x), ("table", neighbor_idx)):
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, features on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _launch_fwd(x, neighbor_idx, w, bias, tile_taps):
    """The forward kernel: ``conv(x) + bias`` with ``w`` (K, C_in, C_out)
    in x's dtype; fills ``tile_taps`` when given. Where the kernel splits
    its blocks' taps (few rows, wide channels), the splits' float32 shares
    are summed here in a fixed order."""
    n, (k, c_in, c_out) = x.shape[0], w.shape
    _check(x, neighbor_idx, c_in, "subm_conv_gemm_fwd")
    if n == 0:
        return torch.empty((n, c_out), dtype=x.dtype, device=x.device)
    if bias is not None:
        bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    is_bf16, sms = DTYPE_CODES[x.dtype], _sms(x.device.index or 0)
    splits = bind(KERNEL, "cdseg_subm_conv_gemm_fwd_splits", _SPLITS_ARGS)(
        n, k, c_in, c_out, is_bf16, sms)
    y = partial = None
    if splits > 1:
        partial = torch.empty((splits, n, c_out), dtype=torch.float32, device=x.device)
    else:
        y = torch.empty((n, c_out), dtype=x.dtype, device=x.device)
    check_launch(bind(KERNEL, "cdseg_subm_conv_gemm_fwd", _FWD_ARGS)(
        x.data_ptr(), neighbor_idx.data_ptr(), w.data_ptr(),
        None if bias is None else bias.data_ptr(), None if y is None else y.data_ptr(),
        None if partial is None else partial.data_ptr(),
        None if tile_taps is None else tile_taps.data_ptr(), n, k, c_in, c_out, splits,
        is_bf16, sms, stream(x)), "subm_conv_gemm_fwd")
    return y if partial is None else partial.sum(0).to(x.dtype)


def subm_conv_gemm_fwd(feat, neighbor_idx, weight, bias=None, tile_taps=None):
    """The forward kernel: ``subm_conv_apply``'s value on CUDA tensors.
    ``tile_taps``, a uint8 ``(ceil(N / 64), K)`` tensor, receives which taps
    each 64-row tile reads (the weight gradient's input)."""
    w = weight.detach().to(feat.dtype).contiguous()
    y = _launch_fwd(feat, neighbor_idx, w, bias, tile_taps)
    subm_conv_gemm_fwd.launches += 1
    return y


def subm_conv_gemm_dgrad(grad_out, neighbor_idx, weight):
    """The input gradient: the forward kernel over ``grad_out`` with the
    reflected weight (`reflected_weight`)."""
    w = reflected_weight(weight.detach().to(grad_out.dtype)).contiguous()
    dx = _launch_fwd(grad_out, neighbor_idx, w, None, None)
    subm_conv_gemm_dgrad.launches += 1
    return dx


def subm_conv_gemm_wgrad(feat, neighbor_idx, grad_out, tile_taps):
    """The weight-gradient kernel: (K, C_in, C_out) in float32, summed over
    the rows of the tiles that ``tile_taps`` marks for each tap."""
    n, c_in = feat.shape
    k, c_out = neighbor_idx.shape[1], grad_out.shape[1]
    _check(feat, neighbor_idx, c_in, "subm_conv_gemm_wgrad")
    _check(grad_out, neighbor_idx, c_out, "subm_conv_gemm_wgrad")
    if grad_out.dtype != feat.dtype:
        raise TypeError(f"gradient {grad_out.dtype} and features {feat.dtype} differ")
    if n == 0:
        return torch.zeros((k, c_in, c_out), dtype=torch.float32, device=feat.device)
    is_bf16 = DTYPE_CODES[feat.dtype]
    splits = bind(KERNEL, "cdseg_subm_conv_gemm_splits", _SPLITS_ARGS)(
        n, k, c_in, c_out, is_bf16, _sms(feat.device.index or 0))
    partial = torch.empty((splits, k, c_in, c_out), dtype=torch.float32, device=feat.device)
    check_launch(bind(KERNEL, "cdseg_subm_conv_gemm_wgrad", _WGRAD_ARGS)(
        feat.data_ptr(), neighbor_idx.data_ptr(), grad_out.data_ptr(), tile_taps.data_ptr(),
        partial.data_ptr(), n, k, c_in, c_out, splits, is_bf16, stream(feat)),
        "subm_conv_gemm_wgrad")
    subm_conv_gemm_wgrad.launches += 1
    return partial.sum(0)


register_launches("conv_fwd", subm_conv_gemm_fwd)
register_launches("conv_dgrad", subm_conv_gemm_dgrad)
register_launches("conv_wgrad", subm_conv_gemm_wgrad)


class _SubMConvGemm(torch.autograd.Function):
    """`_forward`; the input gradient through the forward kernel and the
    reflected weight, the weight gradient through its own kernel. Saves
    the features, the table, the weight and the tiles' taps."""

    @staticmethod
    def forward(ctx, feat, neighbor_idx, weight, bias):
        taps = None
        if ctx.needs_input_grad[2]:
            taps = torch.empty((-(-feat.shape[0] // TILE_ROWS), neighbor_idx.shape[1]),
                               dtype=torch.uint8, device=feat.device)
        out = _forward(feat, neighbor_idx, weight, bias, taps)
        ctx.save_for_backward(feat, neighbor_idx, weight, taps)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        feat, neighbor_idx, weight, taps = ctx.saved_tensors
        g = g.contiguous()
        d_feat = d_weight = d_bias = None
        if ctx.needs_input_grad[0]:
            d_feat = subm_conv_gemm_dgrad(g, neighbor_idx, weight)
        if ctx.needs_input_grad[2]:
            d_weight = subm_conv_gemm_wgrad(feat, neighbor_idx, g, taps).to(weight.dtype)
        if ctx.needs_input_grad[3]:
            d_bias = g.float().sum(0).to(ctx.bias_dtype)
        return d_feat, None, d_weight, d_bias


# ---------------------------------------------------------------------------
# the kernels' arithmetic in plain PyTorch (tests, chip_smoke.py)


def reflected_weight(weight: torch.Tensor) -> torch.Tensor:
    """``W'[k] = W[K-1-k]^T``, (K, C_out, C_in): over a symmetric table the
    input gradient of a conv is the conv of the output gradient with W'."""
    return weight.flip(0).transpose(1, 2)


def tile_taps(neighbor_idx: torch.Tensor, block_rows: int = TILE_ROWS) -> torch.Tensor:
    """(ceil(N / block_rows), K) bool: whether some row of each tile of
    ``block_rows`` rows has a neighbor at each tap."""
    n, k = neighbor_idx.shape
    tiles = -(-n // block_rows)
    hit = torch.zeros((tiles * block_rows, k), dtype=torch.bool, device=neighbor_idx.device)
    hit[:n] = neighbor_idx != n
    return hit.reshape(tiles, block_rows, k).any(1)


def tile_tap_share(neighbor_idx: torch.Tensor, block_rows: int = TILE_ROWS) -> float:
    """The share of (tile, tap) pairs that a launch over ``neighbor_idx``
    runs with tiles of ``block_rows`` rows (reads the answer to the host)."""
    return tile_taps(neighbor_idx, block_rows).float().mean().item()


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
