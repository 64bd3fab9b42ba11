"""Swin3D: window attention with contextual relative signal encoding (cRSE).

Port of `cdsegnet_tpu/models/swin3d.py` (reference `pointcept/models/swin3d/`),
with the flax module and parameter names, so that
`utils.weights.load_jax_variables` maps a JAX checkpoint name for name.
Windows are serialized patches of ``patch_size`` points on two curves
taken in turn. cRSE adds per-head lookup tables indexed by the quantized
relative position, color and normal of every query-key pair: per signal
group and axis a, with ``idx = clip(floor(delta * scale) + L, 0, 2L - 1)``,

    logit(i, j) += q_i . Tq[a, idx(i, j)] + k_j . Tk[a, idx(i, j)]
    out_i       += sum_j attn(i, j) Tv[a, idx(i, j)]

The tables are ``(3, 2L, H, D)``; positions are in voxel units of
``base_grid_size * 2^level``, colors and normals in [-1, 1]. Keys of
another scene or invalid are -1e9 before the softmax over the keys.

Both table terms are summed without any ``(P, K, K, H, D)`` or ``(P, K, K,
H, 2L)`` tensor, and the training step keeps neither a per-pair gather nor
the tables' products for the backward (JAX's literal value gather keeps
2.5 GB per (group, axis) at level 0 of the 204,800-slot bucket, some 400
GB over the shipped depths):

- the logit terms contract the head dim against the tables first, ``(P,
  H, K, L)``, then gather along L with the pair index broadcast over the
  heads (`crse_logits`, whose backward scatters into the ``(P, H, K, L)``
  gradients and keeps only the indices);
- the value term bins the attention per table row, ``A[h, p, i, l] =
  sum_j attn[p, h, i, j] [idx(p, i, j) = l]`` (one ``scatter_add_`` per
  (group, axis), each into its own rows of one concatenated table), then
  ``out += A @ Tv`` (`binned_value`, whose backward bins the attention
  again from the probabilities and indices that the step keeps anyway).

The pair indices depend on the level and the curve only, so the model
computes them once per (level, curve) and every block there shares them.
The tests hold both functions, values and gradients, against the literal
gather.

Positions and the pooled signals of the coarser levels are cluster means.
A floor of a signal delta turns one ulp of a mean into another table row,
so `ordered_mean` sums each cluster's rows in their sorted order, one row
at a time: the bits of the CPU's sequential sum (and of JAX's) on any
device, where the card's atomic adds would order them otherwise.

- Stem: a k27 submanifold conv with BatchNorm; with
  ``stem_transformer=False`` SpUNet's `BasicBlock` follows (``stem_res``).
- Downsample: max-pool, Dense, BatchNorm, relu; upsample: Dense, parent
  broadcast, plus the skip; head: Dense, BatchNorm, relu, Dense in f32.

Registered as ``Swin3D-v1m1``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cdsegnet_torch.models import pyramid as pyr
from cdsegnet_torch.models.modules import (
    Dense,
    LayerNorm,
    MaskedBatchNorm,
    Mlp,
    SubMConv,
    drop_path,
)
from cdsegnet_torch.models.spunet import BasicBlock
from cdsegnet_torch.models.structure import PointBatch
from cdsegnet_torch.ops import segments as seg_ops

ORDERS = ("z", "z-trans")


def signal_groups(crse: str, window_size: int, quant_size: int
                  ) -> List[Tuple[str, Tuple[int, int], int, float]]:
    """``(name, signal columns, L, delta scale)`` per enabled signal group:
    positions (table half-width ``window_size * quant_size``, scale
    ``quant_size``), then colors and normals (half-width ``4 * quant_size``,
    scale ``2 * quant_size``)."""
    groups, col = [], 0
    if "XYZ" in crse:
        groups.append(("xyz", (col, col + 3), window_size * quant_size, float(quant_size)))
        col += 3
    for name in ("RGB", "NORM"):
        if name in crse:
            groups.append((name.lower(), (col, col + 3), 2 * (2 * quant_size),
                           float(2 * quant_size)))
            col += 3
    return groups


def pair_indices(signals: torch.Tensor, order: torch.Tensor, patch: int, groups
                 ) -> torch.Tensor:
    """``(G·3, P, K, K)`` int64 table rows of every (group, axis) pair in
    the windows of ``order``, each offset into the concatenation of all
    pairs' tables (group-major, then axis)."""
    n = signals.shape[0]
    sig = signals[order].reshape(n // patch, patch, -1)
    out, off = [], 0
    for _, (c0, c1), length, scale in groups:
        s = sig[:, :, c0:c1].float() * scale
        delta = s[:, :, None, :] - s[:, None, :, :]  # (P, K, K, 3)
        idx = torch.clamp(torch.floor(delta).long() + length, 0, 2 * length - 1)
        for a in range(3):
            out.append(idx[..., a] + off)
            off += 2 * length
    return torch.stack(out)


def _pair_view(ia: torch.Tensor, h: int, transpose: bool = False) -> torch.Tensor:
    """A pair's ``(P, K, K)`` rows as a ``(P, H, K, K)`` stride-0 view over
    the heads (its key-major transpose for the key term)."""
    if transpose:
        ia = ia.transpose(1, 2)
    p, k, _ = ia.shape
    return ia[:, None].expand(p, h, k, k)


class _CrseLogits(torch.autograd.Function):
    """``extra[p, h, i, j] = sum_pairs qdot[p, h, i, idx] + kdot[p, h, j,
    idx]`` with ``idx = pairs[pair, p, i, j]``, summed in JAX's order (each
    pair's query term, then its key term); the backward keeps only the
    indices."""

    @staticmethod
    def forward(ctx, qdot, kdot, pairs):
        h = qdot.shape[1]
        extra = None
        for ia in pairs:
            tq = qdot.gather(3, _pair_view(ia, h))
            extra = tq if extra is None else extra + tq
            extra = extra + kdot.gather(3, _pair_view(ia, h, True)).transpose(2, 3)
        ctx.save_for_backward(pairs)
        ctx.shapes = (qdot.shape, kdot.shape)
        return extra

    @staticmethod
    def backward(ctx, g):
        (pairs,) = ctx.saved_tensors
        qshape, kshape = ctx.shapes
        h = qshape[1]
        gq, gk = g.new_zeros(qshape), g.new_zeros(kshape)
        gt = g.transpose(2, 3)
        for ia in pairs:
            gq.scatter_add_(3, _pair_view(ia, h), g)
            gk.scatter_add_(3, _pair_view(ia, h, True), gt)
        return gq, gk, None


def crse_logits(qdot: torch.Tensor, kdot: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    """The cRSE logit terms ``(P, H, K, K)`` from ``qdot``/``kdot`` ``(P, H,
    K, L)`` (queries and keys contracted with the concatenated tables) and
    the `pair_indices`."""
    return _CrseLogits.apply(qdot, kdot, pairs)


def _bin(attn: torch.Tensor, pairs: torch.Tensor, rows: int) -> torch.Tensor:
    """``A (H, P, K, rows)``: the attention ``(P, H, K, K)`` summed per
    table row of every pair."""
    p, h, k, _ = attn.shape
    binned = attn.new_zeros((h, p, k, rows))
    src = attn.transpose(0, 1)
    for ia in pairs:
        binned.scatter_add_(3, ia[None].expand(h, p, k, k), src)
    return binned


class _BinnedValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, attn, pairs, table):
        p, h, k, _ = attn.shape
        binned = _bin(attn, pairs, table.shape[0]).reshape(h, p * k, -1)
        out = torch.bmm(binned, table.transpose(0, 1))  # (H, P·K, D)
        ctx.save_for_backward(attn, pairs, table)
        return out.reshape(h, p, k, -1).permute(1, 2, 0, 3)

    @staticmethod
    def backward(ctx, g):
        attn, pairs, table = ctx.saved_tensors
        p, h, k, _ = attn.shape
        gh = g.permute(2, 0, 1, 3).reshape(h, p * k, -1)  # (H, P·K, D)
        binned = _bin(attn, pairs, table.shape[0]).reshape(h, p * k, -1)
        gtable = torch.bmm(binned.transpose(1, 2), gh).transpose(0, 1)
        del binned
        gbin = torch.bmm(gh, table.permute(1, 2, 0)).reshape(h, p, k, -1)
        gattn = None
        for ia in pairs:
            t = gbin.gather(3, ia[None].expand(h, p, k, k))
            gattn = t if gattn is None else gattn + t
        return gattn.transpose(0, 1), None, gtable


def binned_value(attn: torch.Tensor, pairs: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``out[p, i, h] = sum_pairs sum_j attn[p, h, i, j] table[idx, h]``
    with ``idx = pairs[pair, p, i, j]``, for ``attn (P, H, K, K)`` and the
    concatenated ``table (L, H, D)``: the attention binned per table row,
    then one product with the table, ``(P, K, H, D)``. The backward keeps
    the probabilities and indices (which the attention keeps anyway) and
    bins again."""
    return _BinnedValue.apply(attn, pairs, table)


def ordered_mean(values: torch.Tensor, level: pyr.Level) -> torch.Tensor:
    """``pyramid.pool_features(values, level, "mean")`` with each cluster's
    rows (contiguous in the pooling order) added one at a time in that
    order: the bits of the CPU's sequential sum on every device. One host
    read: the largest cluster."""
    m = level.size
    valid = level.pool_valid
    xs = torch.where(valid[:, None], values[level.pool_sort], 0.0)
    seg = level.pool_seg.long()
    cnt = xs.new_zeros(m).index_add_(0, seg, valid.to(xs.dtype))
    first = seg_ops.segment_first_position(seg, m)
    n = xs.shape[0]
    total = xs.new_zeros((m,) + xs.shape[1:])
    for j in range(int(cnt.max().item())):
        row = xs.index_select(0, torch.clamp(first + j, max=n - 1))
        total = total + torch.where((j < cnt)[:, None], row, 0.0)
    return total / torch.clamp(cnt, min=1.0)[:, None]


class SwinWindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, patch_size: int, window_size: int,
                 quant_size: int, order_index: int = 0, cRSE: str = "XYZ_RGB",
                 qkv_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.num_heads, self.patch_size = dim, num_heads, patch_size
        self.order_index = order_index
        self.dtype = dtype
        self.groups = signal_groups(cRSE, window_size, quant_size)
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        d = dim // num_heads
        # `utils.weights.init_weights` draws them (flax truncated normal 0.02)
        for name, _, length, _ in self.groups:
            for t in ("query", "key", "value"):
                self.register_parameter(f"{t}_{name}_table",
                                        nn.Parameter(torch.empty(3, 2 * length, num_heads, d)))
        self.proj = Dense(dim, dim, dtype=dtype)

    def tables(self, kind: str) -> torch.Tensor:
        """The ``kind`` tables of every (group, axis) pair concatenated
        along the rows, in `pair_indices`' order: ``(L, H, D)``."""
        return torch.cat([getattr(self, f"{kind}_{name}_table").flatten(0, 1)
                          for name, _, _, _ in self.groups])

    def forward(self, feat, level: pyr.Level, pairs: torch.Tensor) -> torch.Tensor:
        """``pairs``: `pair_indices` of this block's curve on ``level``."""
        c, h, k = self.dim, self.num_heads, self.patch_size
        d = c // h
        pp = level.point
        n = pp.num_points
        p = n // k
        o = self.order_index % pp.orders.shape[0]
        order = pp.orders[o]
        qkv = self.qkv(feat[order]).reshape(p, k, 3, h, d).float()
        q, kk, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        scale = d ** -0.5
        logits = torch.einsum("pihd,pjhd->phij", q, kk) * scale
        # the logit terms: contract D first, then gather along the rows
        qdot = torch.einsum("pihd,lhd->phil", q * scale, self.tables("query"))
        kdot = torch.einsum("pjhd,lhd->phjl", kk, self.tables("key"))
        logits = logits + crse_logits(qdot, kdot, pairs)
        bs = pp.batch[order].reshape(p, k)
        ms = pp.mask[order].reshape(p, k)
        valid = ms[:, :, None] & ms[:, None, :] & (bs[:, :, None] == bs[:, None, :])
        logits = torch.where(valid[:, None], logits, -1e9)
        attn = torch.softmax(logits, dim=-1)  # over the keys
        out = torch.einsum("phij,pjhd->pihd", attn, v)
        out = out + binned_value(attn, pairs, self.tables("value"))
        out = out.reshape(n, c)
        out = torch.where(pp.mask[order][:, None], out, 0.0)
        return self.proj(out[pp.inverses[o]].to(self.dtype))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, patch_size: int, window_size: int,
                 quant_size: int, order_index: int = 0, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0, cRSE: str = "XYZ_RGB",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = SwinWindowAttention(dim, num_heads, patch_size, window_size, quant_size,
                                        order_index, cRSE, dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype=dtype)

    def forward(self, feat, level, pairs, generator=None):
        det = not self.training
        f = self.attn(self.norm1(feat), level, pairs)
        feat = feat + drop_path(f, self.drop_path_rate, det, generator)
        g = self.mlp(self.norm2(feat), generator)
        return feat + drop_path(g, self.drop_path_rate, det, generator)


class Swin3DUNet(nn.Module):
    def __init__(
        self,
        in_channels: int = 9,
        num_classes: int = 20,
        base_grid_size: float = 0.02,
        depths: Sequence[int] = (2, 4, 9, 4, 4),
        channels: Sequence[int] = (48, 96, 192, 384, 384),
        num_heads: Sequence[int] = (6, 6, 12, 24, 24),
        window_sizes: Sequence[int] = (5, 7, 7, 7, 7),
        quant_size: int = 4,
        drop_path_rate: float = 0.2,
        stem_transformer: bool = True,
        patch_size: int = 64,
        capacity_div: Sequence[int] = (1, 2, 4, 16, 64),
        cRSE: str = "XYZ_RGB",
        color_slice: Tuple[int, int] = (0, 3),
        normal_slice: Tuple[int, int] = (3, 6),
        mlp_ratio: float = 4.0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.depths, self.channels = tuple(depths), tuple(channels)
        self.window_sizes = tuple(window_sizes)
        self.quant_size = quant_size
        self.base_grid_size = base_grid_size
        self.patch_size = patch_size
        self.capacity_div = tuple(capacity_div)
        self.cRSE = cRSE
        self.color_slice, self.normal_slice = tuple(color_slice), tuple(normal_slice)
        self.dtype = dtype
        nl = len(self.depths)
        c0 = self.channels[0]
        self.stem_conv = SubMConv(in_channels, c0, 27, use_bias=False, dtype=dtype)
        self.stem_bn = MaskedBatchNorm(c0, dtype=dtype)
        self.stem_res = None if stem_transformer else BasicBlock(c0, dtype=dtype)
        dpr = np.linspace(0, drop_path_rate, sum(self.depths))
        for li in range(nl):
            base = sum(self.depths[:li])
            for b in range(self.depths[li]):
                self.add_module(f"layer{li}_block{b}", SwinBlock(
                    self.channels[li], num_heads[li], patch_size, self.window_sizes[li],
                    quant_size, order_index=b % 2, mlp_ratio=mlp_ratio,
                    drop_path_rate=float(dpr[base + b]), cRSE=cRSE, dtype=dtype))
            if li < nl - 1:
                self.add_module(f"down{li}", Dense(self.channels[li], self.channels[li + 1],
                                                   dtype=dtype))
                self.add_module(f"down{li}_bn", MaskedBatchNorm(self.channels[li + 1],
                                                                dtype=dtype))
        for li in range(nl - 2, -1, -1):
            self.add_module(f"up{li}", Dense(self.channels[li + 1], self.channels[li],
                                             dtype=dtype))
        self.cls_fc1 = Dense(c0, c0)
        self.cls_bn = MaskedBatchNorm(c0)
        self.cls_fc2 = Dense(c0, num_classes)

    def precompute_geometry(self, point: PointBatch, perms=None):
        """``(levels, stem_nbr)``: the serialization pyramid on two curves
        (stride 2 per level, capacities ``n / capacity_div`` rounded to
        ``patch_size``), each pooled level's ``dropped`` a Python int.
        ``perms`` must be None: the curves are not shuffled."""
        if perms is not None:
            raise ValueError("Swin3D takes no curve permutations")
        if point.num_points % self.patch_size:
            raise ValueError(f"bucket size {point.num_points} is not a multiple of "
                             f"patch_size {self.patch_size}")
        n0, k = point.num_points, self.patch_size
        caps = [pyr.round_up(max(n0 // d, k), k)
                for d in self.capacity_div[1:len(self.depths)]]
        return pyr.build_pyramid(point, strides=(2,) * (len(self.depths) - 1),
                                 capacities=caps, orders=ORDERS, stem_kernel=3)

    def shuffle_perms(self, generator=None):
        """None: the blocks take the two curves in turn, unshuffled."""
        return None

    def _signals(self, coord, level_idx: int, feat_sig) -> torch.Tensor:
        """A level's cRSE signals: the position in voxel units of
        ``base_grid_size * 2^level`` (sub-voxel fraction kept), then colors
        and normals."""
        cols = []
        if "XYZ" in self.cRSE:
            # XLA divides by a constant as a product with its float32
            # reciprocal; so does the port, for the same table rows
            inv = np.float32(1.0) / np.float32(self.base_grid_size * (2 ** level_idx))
            cols.append(coord.float() * torch.full_like(coord, float(inv), dtype=torch.float32))
        if "RGB" in self.cRSE:
            cols.append(feat_sig[:, self.color_slice[0]:self.color_slice[1]])
        if "NORM" in self.cRSE:
            cols.append(feat_sig[:, self.normal_slice[0]:self.normal_slice[1]])
        return torch.cat(cols, dim=-1).float()

    def forward(self, point: PointBatch, geometry=None, generator=None) -> torch.Tensor:
        """Logits ``(N, num_classes)`` in float32. ``geometry`` is a
        precomputed `precompute_geometry`; ``generator`` draws the
        stochastic-depth masks in training."""
        levels, _ = geometry if geometry is not None else self.precompute_geometry(point)
        nl = len(self.depths)
        nbr0 = levels[0].point.neighbor_idx
        f = F.relu(self.stem_bn(self.stem_conv(point.feat, nbr0), point.mask))
        if self.stem_res is not None:
            f = self.stem_res(f, nbr0, point.mask)
        skips = []
        with torch.no_grad():  # the levels' positions (the pyramid's) and signals
            coords, sig_levels = [point.coord.float()], [point.feat.float()]
            for li in range(1, nl):
                coords.append(ordered_mean(coords[-1], levels[li]))
                sig_levels.append(ordered_mean(sig_levels[-1], levels[li]))
        for li in range(nl):
            lvl = levels[li]
            groups = signal_groups(self.cRSE, self.window_sizes[li], self.quant_size)
            with torch.no_grad():
                sigs = self._signals(coords[li], li, sig_levels[li])
                pairs = [pair_indices(sigs, lvl.point.orders[o % lvl.point.orders.shape[0]],
                                      self.patch_size, groups)
                         for o in range(min(2, self.depths[li]))]
            for b in range(self.depths[li]):
                f = getattr(self, f"layer{li}_block{b}")(f, lvl, pairs[b % 2], generator)
            skips.append(f)
            if li < nl - 1:
                nxt = levels[li + 1]
                f = getattr(self, f"down{li}")(pyr.pool_features(f, nxt, "max"))
                f = F.relu(getattr(self, f"down{li}_bn")(f, nxt.point.mask))
        f = skips[-1]
        for li in range(nl - 2, -1, -1):
            f = pyr.unpool_features(getattr(self, f"up{li}")(f), levels[li + 1]) + skips[li]
        f = F.relu(self.cls_bn(self.cls_fc1(f.float()), point.mask))
        return self.cls_fc2(f)
