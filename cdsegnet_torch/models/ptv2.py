"""Point Transformer V2: grouped vector attention over kNN graphs.

Port of `cdsegnet_tpu/models/ptv2.py` (reference
`pointcept/models/point_transformer_v2/*`), with the flax module and
parameter names, so that `utils.weights.load_jax_variables` maps a JAX
checkpoint name for name.

- `GroupedVectorAttention`: channel groups share attention weights, the
  relative position encoded into the relation (``pe_multiplier``,
  ``pe_bias``) and the values (``pe_bias``); the weight encoding is a Dense
  to the groups ("linear", m2) or a per-channel weight summed within each
  group ("grouped", m1's GroupedLinear). Softmax over the K neighbors in
  float32, -1e9 on guard slots.
- `BlockV2`: attention, norm, relu, Dense, norm, residual relu.
- `PointTransformerV2` (registered names ``PT-v2m2``, ``PT-v2m1``: grouped
  weights, ``PT-v2m3``: prompt-driven norms with ``condition`` and
  ``context`` at call time): a metric grid-pooling UNet. One kNN table per
  level, scene-separated, shared by every block there (`ops.pointops.knn`).
  GridPool is Dense, norm, relu, segment max; UnpoolWithSkip a Dense, norm,
  relu broadcast plus the skip's Dense, norm, relu. ``grid_sizes=None``
  falls back to the power-of-two serialization pyramid.
- `PointTransformerV2Pointcept` (registered ``PT-v2m2-pointcept``):
  Pointcept's PT-v2m2 as published, which these equations depart from
  (normed q and k, BN-ReLU position and weight encodings, ``k - q``, the
  block's fc1/fc3, the normed patch embed at 8 neighbours, a two-layer
  head, stochastic depth): `PointceptGVA`, `PointceptBlock`. It has no JAX
  counterpart; ``bench_h100/reference/ptv2.py`` is its plain reference.

Each geometry build runs as span ``geometry`` (`utils.tracing`), each kNN
table inside it as ``pointops.knn``, each attention forward of the
Pointcept model as ``ptv2.attention``.

With ``num_classes == 0`` (feature mode) the model builds no head and
returns the last decoder block's features, ``dec_channels[0]`` wide, as the
reference does; JAX's module builds ``nn.Dense(0)`` there and fails.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cdsegnet_torch.models import pyramid as pyr
from cdsegnet_torch.models.modules import (
    Dense, MaskedBatchNorm, apply_norm, drop_path, make_norm)
from cdsegnet_torch.models.structure import PointBatch
from cdsegnet_torch.ops.pointops import grouping, knn
from cdsegnet_torch.utils import tracing

_gelu = lambda x: F.gelu(x, approximate="tanh")  # flax `nn.gelu`


def _capacities(n0: int, capacity_div: Sequence[int]):
    return [pyr.round_up(max(n0 // d, 8), 8) for d in capacity_div]


def metric_levels(point: PointBatch, grid_sizes: Sequence[float], caps: Sequence[int]):
    """The metric pyramid with each pooled level's ``dropped`` read to a
    Python int (one host read), counted as ``pyramid.dropped_l<i>``."""
    levels = pyr.build_metric_pyramid(point, grid_sizes, caps)
    drops = torch.stack([lv.dropped for lv in levels[1:]]).tolist()
    if tracing.enabled():
        for i, d in enumerate(drops, 1):
            tracing.count(f"pyramid.dropped_l{i}", d)
    return [levels[0]] + [lv.replace(dropped=int(d)) for lv, d in zip(levels[1:], drops)]


def knn_tables(levels, ks: Sequence[int]):
    """One scene-separated kNN table per level, of ``ks[i]`` neighbors in
    ascending (distance, index) order: a block that takes fewer reads the
    first columns."""
    return [knn(lv.point.coord, lv.point.coord, k, lv.point.mask, lv.point.mask,
                query_batch=lv.point.batch, ref_batch=lv.point.batch)[0]
            for lv, k in zip(levels, ks)]


class GroupedVectorAttention(nn.Module):
    def __init__(self, channels: int, groups: int, k_neighbors: int = 16,
                 pe_multiplier: bool = False, pe_bias: bool = True,
                 weight_encoding: str = "linear", dtype: torch.dtype = torch.float32):
        super().__init__()
        if weight_encoding not in ("linear", "grouped"):
            raise ValueError(f"unknown weight_encoding {weight_encoding!r}")
        c = channels
        self.channels, self.groups, self.k_neighbors = c, groups, k_neighbors
        self.dtype = dtype
        self.linear_q = Dense(c, c, dtype=dtype)
        self.linear_k = Dense(c, c, dtype=dtype)
        self.linear_v = Dense(c, c, bias=False, dtype=dtype)
        if pe_multiplier:  # flax `nn.Sequential([Dense(3), gelu, Dense(c)])`,
            # whose layers take the parent's auto names
            self.Dense_0 = Dense(3, 3, dtype=dtype)
            self.Dense_1 = Dense(3, c, dtype=dtype)
        else:
            self.Dense_0 = self.Dense_1 = None
        if pe_bias:
            self.pe_bias1 = Dense(3, 3, dtype=dtype)
            self.pe_bias2 = Dense(3, c, dtype=dtype)
        else:
            self.pe_bias1 = self.pe_bias2 = None
        self.weight_fc1 = Dense(c, c, dtype=dtype)
        if weight_encoding == "grouped":
            # `utils.weights.init_weights` draws it (flax variance_scaling(1/3))
            self.grouped_weight = nn.Parameter(torch.empty(1, c))
            self.weight_fc2 = None
        else:
            self.grouped_weight = None
            self.weight_fc2 = Dense(c, groups, dtype=dtype)

    def forward(self, feat: torch.Tensor, coord: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
        c, g, k = self.channels, self.groups, self.k_neighbors
        n = feat.shape[0]
        q = self.linear_q(feat)
        k_n = grouping(self.linear_k(feat), idx)  # (N, K, C)
        v_n = grouping(self.linear_v(feat), idx)
        pos = (grouping(coord, idx) - coord[:, None, :]).to(self.dtype)
        relation = q[:, None, :] - k_n
        if self.Dense_0 is not None:
            relation = relation * self.Dense_1(_gelu(self.Dense_0(pos)))
        if self.pe_bias1 is not None:
            peb = self.pe_bias2(_gelu(self.pe_bias1(pos)))
            relation = relation + peb
            v_n = v_n + peb
        w = _gelu(self.weight_fc1(relation))
        if self.grouped_weight is not None:
            w = (w * self.grouped_weight.to(self.dtype)).reshape(n, k, g, c // g).sum(-1)
        else:
            w = self.weight_fc2(w)  # (N, K, G)
        w = torch.where((idx < n)[..., None], w.float(), -1e9)
        w = torch.softmax(w, dim=1).to(v_n.dtype)
        return (v_n.reshape(n, k, g, c // g) * w[..., None]).sum(1).reshape(n, c)


class BlockV2(nn.Module):
    def __init__(self, channels: int, groups: int, k_neighbors: int = 16,
                 weight_encoding: str = "linear", num_conditions: int = 0,
                 pdnorm_adaptive: bool = False, context_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = channels
        pd = dict(num_conditions=num_conditions, adaptive=pdnorm_adaptive,
                  context_channels=context_channels, dtype=dtype)
        self.attn = GroupedVectorAttention(c, groups, k_neighbors,
                                           weight_encoding=weight_encoding, dtype=dtype)
        self.bn = make_norm(c, **pd)
        self.fc = Dense(c, c, dtype=dtype)
        self.bn2 = make_norm(c, **pd)

    def forward(self, feat, coord, mask, idx, condition: int = 0, context=None):
        f = self.attn(feat, coord, idx)
        f = F.relu(apply_norm(self.bn, f, mask, condition, context))
        f = apply_norm(self.bn2, self.fc(f), mask, condition, context)
        return F.relu(feat + f)


class PointTransformerV2(nn.Module):
    """PTv2 segmentor (or feature extractor at ``num_classes=0``): GVA
    blocks on a grid-pooling UNet."""

    def __init__(
        self,
        in_channels: int = 6,
        num_classes: int = 20,
        patch_embed_channels: int = 48,
        patch_embed_groups: int = 6,
        enc_channels: Sequence[int] = (96, 192, 384, 512),
        enc_depths: Sequence[int] = (2, 2, 6, 2),
        enc_groups: Sequence[int] = (12, 24, 48, 64),
        dec_channels: Sequence[int] = (48, 96, 192, 384),
        dec_depths: Sequence[int] = (1, 1, 1, 1),
        dec_groups: Sequence[int] = (6, 12, 24, 48),
        k_neighbors: int = 16,
        capacity_div: Sequence[int] = (1, 2, 8, 32, 128),
        grid_sizes: Optional[Sequence[float]] = (0.06, 0.12, 0.24, 0.48),
        weight_encoding: str = "linear",
        num_conditions: int = 0,
        pdnorm_adaptive: bool = False,
        context_channels: int = 256,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.enc_depths, self.dec_depths = tuple(enc_depths), tuple(dec_depths)
        self.dec_channels = tuple(dec_channels)
        self.k_neighbors = k_neighbors
        self.capacity_div = tuple(capacity_div)
        self.grid_sizes = None if grid_sizes is None else tuple(grid_sizes)
        self.dtype = dtype
        stages = len(enc_channels)
        blk = dict(k_neighbors=k_neighbors, weight_encoding=weight_encoding,
                   num_conditions=num_conditions, pdnorm_adaptive=pdnorm_adaptive,
                   context_channels=context_channels, dtype=dtype)
        norm = lambda c: make_norm(c, num_conditions=num_conditions,
                                   adaptive=pdnorm_adaptive,
                                   context_channels=context_channels, dtype=dtype)
        self.patch_embed = Dense(in_channels, patch_embed_channels, dtype=dtype)
        self.embed_block = BlockV2(patch_embed_channels, patch_embed_groups, **blk)
        skip_ch = [patch_embed_channels] + list(enc_channels)
        for s in range(stages):
            self.add_module(f"down{s}", Dense(skip_ch[s], enc_channels[s], bias=False,
                                              dtype=dtype))
            self.add_module(f"down{s}_bn", norm(enc_channels[s]))
            for i in range(enc_depths[s]):
                self.add_module(f"enc{s}_block{i}",
                                BlockV2(enc_channels[s], enc_groups[s], **blk))
        up_in = list(dec_channels[1:]) + [enc_channels[-1]]
        for s in reversed(range(stages)):
            self.add_module(f"up{s}", Dense(up_in[s], dec_channels[s], dtype=dtype))
            self.add_module(f"up{s}_bn", norm(dec_channels[s]))
            self.add_module(f"skip{s}", Dense(skip_ch[s], dec_channels[s], dtype=dtype))
            self.add_module(f"skip{s}_bn", norm(dec_channels[s]))
            for i in range(dec_depths[s]):
                self.add_module(f"dec{s}_block{i}",
                                BlockV2(dec_channels[s], dec_groups[s], **blk))
        self.head = Dense(dec_channels[0], num_classes) if num_classes > 0 else None

    def precompute_geometry(self, point: PointBatch, perms=None):
        """``(levels, knn_idx)``: the pyramid (metric grids, or the
        serialization pyramid when ``grid_sizes`` is None) with each pooled
        level's ``dropped`` read to a Python int, and one scene-separated
        kNN table per level. ``perms`` must be None: PTv2 shuffles no curve
        (`shuffle_perms`)."""
        if perms is not None:
            raise ValueError("PTv2 takes no curve permutations")
        stages = len(self.enc_depths)
        caps = _capacities(point.num_points, self.capacity_div[1:stages + 1])
        with tracing.span("geometry"):
            if self.grid_sizes is not None:
                levels = metric_levels(point, self.grid_sizes[:stages], caps)
            else:
                levels, _ = pyr.build_pyramid(point, strides=(2,) * stages, capacities=caps,
                                              orders=("z",), stem_kernel=3)
            return levels, knn_tables(levels[:stages + 1], [self.k_neighbors] * (stages + 1))

    def shuffle_perms(self, generator=None):
        """None: PTv2 has no serialization curves to shuffle."""
        return None

    def _norm_act(self, name, f, mask, condition, context):
        return F.relu(apply_norm(getattr(self, name), f, mask, condition, context))

    def forward(self, point: PointBatch, geometry=None, generator=None,
                condition: int = 0, context: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Logits ``(N, num_classes)`` in float32, or in feature mode the
        last decoder block's output. ``geometry`` is a precomputed
        `precompute_geometry`; ``generator`` is unused (PTv2 draws
        nothing)."""
        levels, tables = geometry if geometry is not None else self.precompute_geometry(point)
        stages = len(self.enc_depths)
        ca = dict(condition=condition, context=context)
        feat = self.patch_embed(point.feat)
        feat = self.embed_block(feat, point.coord, point.mask, tables[0], **ca)
        skips = [feat]
        for s in range(stages):
            lvl = levels[s + 1]
            f = getattr(self, f"down{s}")(skips[-1])
            f = self._norm_act(f"down{s}_bn", f, levels[s].point.mask, **ca)
            f = pyr.pool_features(f, lvl, reduce="max")
            for i in range(self.enc_depths[s]):
                f = getattr(self, f"enc{s}_block{i}")(
                    f, lvl.point.coord, lvl.point.mask, tables[s + 1], **ca)
            skips.append(f)
        f = skips[-1]
        for s in reversed(range(stages)):
            lvl, lo = levels[s + 1], levels[s]
            f = self._norm_act(f"up{s}_bn", getattr(self, f"up{s}")(f), lvl.point.mask, **ca)
            f = pyr.unpool_features(f, lvl)
            skip = self._norm_act(f"skip{s}_bn", getattr(self, f"skip{s}")(skips[s]),
                                  lo.point.mask, **ca)
            f = f + skip
            for i in range(self.dec_depths[s]):
                f = getattr(self, f"dec{s}_block{i}")(
                    f, lo.point.coord, lo.point.mask, tables[s], **ca)
        if self.head is None:
            return f
        return self.head(f.float())


def _torch_bn(c: int, dtype: torch.dtype) -> MaskedBatchNorm:
    """A masked BatchNorm with torch's defaults, as Pointcept's
    ``PointBatchNorm`` (``BatchNorm1d``): eps 1e-5, momentum 0.1."""
    return MaskedBatchNorm(c, eps=1e-5, momentum=0.1, dtype=dtype)


class PointceptGVA(nn.Module):
    """Pointcept's ``GroupedVectorAttention`` of PT-v2m2, as published: q and
    k each a biased Linear, BatchNorm and ReLU, v a biased Linear; keys,
    values and relative positions gathered over the kNN table (a guard slot
    reads zeros, its position 0); relation ``k_j - q_i + peb`` and values
    ``v_j + peb``, with ``peb`` = Linear(C, C) . ReLU . BN . Linear(3, C) of
    the position; weights Linear(G, G) . ReLU . BN . Linear(C, G) of the
    relation, a softmax over the K neighbors, then zero at guard slots (the
    source multiplies by ``sign(idx + 1)`` after the softmax). The output
    sums each group's C/G value channels under its weight. The BatchNorms
    over (N, K, .) take every (valid point, neighbor) row, guard slots
    included, as the source's BatchNorm1d over all N K rows does."""

    def __init__(self, channels: int, groups: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        c, g = channels, groups
        self.channels, self.groups = c, g
        norm = lambda f: _torch_bn(f, dtype)
        self.linear_q, self.norm_q = Dense(c, c, dtype=dtype), norm(c)
        self.linear_k, self.norm_k = Dense(c, c, dtype=dtype), norm(c)
        self.linear_v = Dense(c, c, dtype=dtype)
        self.pe_fc1, self.pe_norm = Dense(3, c, dtype=dtype), norm(c)
        self.pe_fc2 = Dense(c, c, dtype=dtype)
        self.we_fc1, self.we_norm = Dense(c, g, dtype=dtype), norm(g)
        self.we_fc2 = Dense(g, g, dtype=dtype)

    def forward(self, feat: torch.Tensor, coord: torch.Tensor, mask: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
        with tracing.span("ptv2.attention"):
            return self._forward(feat, coord, mask, idx)

    def _forward(self, feat, coord, mask, idx):
        c, g = self.channels, self.groups
        n, k = idx.shape
        q = F.relu(self.norm_q(self.linear_q(feat), mask))
        key = F.relu(self.norm_k(self.linear_k(feat), mask))
        k_n = grouping(key, idx)  # (N, K, C)
        v_n = grouping(self.linear_v(feat), idx)
        real = idx < n
        pos = torch.where(real[..., None], grouping(coord, idx) - coord[:, None, :], 0.0)
        rows = mask[:, None].expand(n, k).reshape(-1)
        peb = self.pe_fc1(pos).reshape(n * k, c)
        peb = self.pe_fc2(F.relu(self.pe_norm(peb, rows))).reshape(n, k, c)
        relation = k_n - q[:, None, :] + peb
        w = self.we_fc1(relation).reshape(n * k, g)
        w = self.we_fc2(F.relu(self.we_norm(w, rows))).reshape(n, k, g)
        w = torch.softmax(w.float(), dim=1) * real[..., None]
        v_n = (v_n + peb).reshape(n, k, g, c // g)
        return (v_n * w[..., None].to(v_n.dtype)).sum(1).reshape(n, c)


class PointceptBlock(nn.Module):
    """Pointcept's PT-v2m2 ``Block``: ``f = ReLU(BN1(fc1 x))``, the GVA,
    ``ReLU(BN2)``, ``BN3(fc3 .)`` (both fc without bias), then ``ReLU(x +
    DropPath(f))``; DropPath keeps or drops whole rows (`modules.drop_path`,
    its masks from the ``"dropout"`` generator or injected)."""

    def __init__(self, channels: int, groups: int, neighbours: int, drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = channels
        norm = lambda: _torch_bn(c, dtype)
        self.neighbours = neighbours
        self.drop_path_rate = drop_path_rate
        self.fc1, self.norm1 = Dense(c, c, bias=False, dtype=dtype), norm()
        self.attn = PointceptGVA(c, groups, dtype=dtype)
        self.norm2 = norm()
        self.fc3, self.norm3 = Dense(c, c, bias=False, dtype=dtype), norm()

    def forward(self, feat, coord, mask, table, generator=None):
        f = F.relu(self.norm1(self.fc1(feat), mask))
        f = self.attn(f, coord, mask, table[:, :self.neighbours])
        f = self.norm3(self.fc3(F.relu(self.norm2(f, mask))), mask)
        return F.relu(feat + drop_path(f, self.drop_path_rate, not self.training, generator))


class PointTransformerV2Pointcept(nn.Module):
    """Pointcept's PT-v2m2 segmentor as published
    (`pointcept/models/point_transformer_v2/point_transformer_v2m2_base.py`),
    registered as ``PT-v2m2-pointcept``: the patch embed (Linear without
    bias, BN, ReLU, then ``patch_embed_depth`` blocks at
    ``patch_embed_neighbours``), encoders of GridPool (Linear without bias,
    BN, ReLU, segment max over metric grid cells) and blocks, decoders of
    UnpoolWithSkip (biased Linear, BN, ReLU of the coarse features mapped
    back by cluster, plus the same of the skip) and blocks, and the head
    Linear, BN, ReLU, Linear. Stochastic-depth rates run ``linspace(0,
    drop_path_rate)`` over the encoder blocks and separately over the
    decoder blocks, stage 0 first; the patch embed has none. Every norm is
    `_torch_bn`.
    One kNN table per level at the largest neighbour count used there
    (`knn_tables`), so the patch embed's 8 neighbours are the first 8
    columns of level 0's 16."""

    def __init__(
        self,
        in_channels: int = 9,
        num_classes: int = 20,
        patch_embed_depth: int = 1,
        patch_embed_channels: int = 48,
        patch_embed_groups: int = 6,
        patch_embed_neighbours: int = 8,
        enc_depths: Sequence[int] = (2, 2, 6, 2),
        enc_channels: Sequence[int] = (96, 192, 384, 512),
        enc_groups: Sequence[int] = (12, 24, 48, 64),
        enc_neighbours: Sequence[int] = (16, 16, 16, 16),
        dec_depths: Sequence[int] = (1, 1, 1, 1),
        dec_channels: Sequence[int] = (48, 96, 192, 384),
        dec_groups: Sequence[int] = (6, 12, 24, 48),
        dec_neighbours: Sequence[int] = (16, 16, 16, 16),
        grid_sizes: Sequence[float] = (0.06, 0.12, 0.24, 0.48),
        drop_path_rate: float = 0.3,
        capacity_div: Sequence[int] = (1, 2, 8, 32, 128),
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        stages = len(enc_depths)
        self.enc_depths, self.dec_depths = tuple(enc_depths), tuple(dec_depths)
        self.patch_embed_depth = patch_embed_depth
        self.grid_sizes = tuple(grid_sizes)
        self.capacity_div = tuple(capacity_div)
        # per level, the largest neighbour count any of its blocks takes
        # (level s + 1 holds encoder stage s and decoder stage s + 1)
        self.level_neighbours = [max(patch_embed_neighbours, dec_neighbours[0])] + [
            max([enc_neighbours[s]] + list(dec_neighbours[s + 1:s + 2])) for s in range(stages)]
        norm = lambda c: _torch_bn(c, dtype)
        # the source's float32 rates, drawn on the host whatever the default device
        enc_dp = torch.linspace(0, drop_path_rate, sum(enc_depths), device="cpu").tolist()
        dec_dp = torch.linspace(0, drop_path_rate, sum(dec_depths), device="cpu").tolist()
        self.patch_embed = Dense(in_channels, patch_embed_channels, bias=False, dtype=dtype)
        self.patch_embed_bn = norm(patch_embed_channels)
        for i in range(patch_embed_depth):
            self.add_module(f"embed_block{i}", PointceptBlock(
                patch_embed_channels, patch_embed_groups, patch_embed_neighbours, dtype=dtype))
        skip_ch = [patch_embed_channels] + list(enc_channels)
        up_in = list(dec_channels[1:]) + [enc_channels[-1]]
        for s in range(stages):
            self.add_module(f"down{s}", Dense(skip_ch[s], enc_channels[s], bias=False,
                                              dtype=dtype))
            self.add_module(f"down{s}_bn", norm(enc_channels[s]))
            for i in range(enc_depths[s]):
                self.add_module(f"enc{s}_block{i}", PointceptBlock(
                    enc_channels[s], enc_groups[s], enc_neighbours[s],
                    enc_dp[sum(enc_depths[:s]) + i], dtype=dtype))
        for s in reversed(range(stages)):
            self.add_module(f"up{s}", Dense(up_in[s], dec_channels[s], dtype=dtype))
            self.add_module(f"up{s}_bn", norm(dec_channels[s]))
            self.add_module(f"skip{s}", Dense(skip_ch[s], dec_channels[s], dtype=dtype))
            self.add_module(f"skip{s}_bn", norm(dec_channels[s]))
            for i in range(dec_depths[s]):
                self.add_module(f"dec{s}_block{i}", PointceptBlock(
                    dec_channels[s], dec_groups[s], dec_neighbours[s],
                    dec_dp[sum(dec_depths[:s]) + i], dtype=dtype))
        c0 = dec_channels[0]
        self.head_fc1, self.head_bn = Dense(c0, c0, dtype=dtype), norm(c0)
        self.head_fc2 = Dense(c0, num_classes, dtype=dtype)

    def precompute_geometry(self, point: PointBatch, perms=None):
        """``(levels, tables)``: the metric pyramid (each pooled level's
        ``dropped`` a Python int) and one kNN table per level, under span
        ``geometry``. ``perms`` must be None: no curve is shuffled."""
        if perms is not None:
            raise ValueError("PTv2 takes no curve permutations")
        stages = len(self.enc_depths)
        caps = _capacities(point.num_points, self.capacity_div[1:stages + 1])
        with tracing.span("geometry"):
            levels = metric_levels(point, self.grid_sizes[:stages], caps)
            return levels, knn_tables(levels, self.level_neighbours)

    def shuffle_perms(self, generator=None):
        """None: PTv2 has no serialization curves to shuffle."""
        return None

    def _bn_relu(self, name, f, mask):
        return F.relu(getattr(self, name)(f, mask))

    def forward(self, point: PointBatch, geometry=None, generator=None) -> torch.Tensor:
        """Logits ``(N, num_classes)`` in float32. ``generator`` (or a
        `modules.DropoutDraws`) gives the stochastic-depth masks in
        training."""
        levels, tables = geometry if geometry is not None else self.precompute_geometry(point)
        stages = len(self.enc_depths)
        f = self._bn_relu("patch_embed_bn", self.patch_embed(point.feat), point.mask)
        for i in range(self.patch_embed_depth):
            f = getattr(self, f"embed_block{i}")(f, point.coord, point.mask, tables[0], generator)
        skips = [f]
        for s in range(stages):
            lvl = levels[s + 1]
            f = self._bn_relu(f"down{s}_bn", getattr(self, f"down{s}")(skips[-1]),
                              levels[s].point.mask)
            f = pyr.pool_features(f, lvl, reduce="max")
            for i in range(self.enc_depths[s]):
                f = getattr(self, f"enc{s}_block{i}")(
                    f, lvl.point.coord, lvl.point.mask, tables[s + 1], generator)
            skips.append(f)
        f = skips[-1]
        for s in reversed(range(stages)):
            lvl, lo = levels[s + 1], levels[s]
            f = self._bn_relu(f"up{s}_bn", getattr(self, f"up{s}")(f), lvl.point.mask)
            f = pyr.unpool_features(f, lvl)
            f = f + self._bn_relu(f"skip{s}_bn", getattr(self, f"skip{s}")(skips[s]),
                                  lo.point.mask)
            for i in range(self.dec_depths[s]):
                f = getattr(self, f"dec{s}_block{i}")(
                    f, lo.point.coord, lo.point.mask, tables[s], generator)
        f = self._bn_relu("head_bn", self.head_fc1(f), point.mask)
        return self.head_fc2(f).float()


# the registered names of the JAX package: m1 is m2 with grouped weights,
# m3 m2 with PDNorm (``num_conditions``/``pdnorm_adaptive`` from the config)
VARIANTS = {"PT-v2m2": {}, "PT-v2m1": dict(weight_encoding="grouped"), "PT-v2m3": {}}


# Pointcept's published PT-v2m2, under a name of its own
POINTCEPT = "PT-v2m2-pointcept"


def build_ptv2(kind: str, **cfg) -> nn.Module:
    """A registered PTv2 variant from reference-style kwargs."""
    if kind == POINTCEPT:
        return PointTransformerV2Pointcept(**cfg)
    kwargs = dict(VARIANTS[kind])
    kwargs.update(cfg)
    return PointTransformerV2(**kwargs)
