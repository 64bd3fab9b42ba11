"""OctFormer: octree attention with dilated z-order windows.

Port of `cdsegnet_tpu/models/octformer.py` (reference
`pointcept/models/octformer/octformer_v1m1_base.py`), with the flax module
and parameter names, so that `utils.weights.load_jax_variables` maps a JAX
checkpoint name for name. An octree level is a z-order-serialized level of
the shared geometry pyramid and an octree window a run of its sorted order;
dilation-D attention regroups the sorted sequence as ``(G, K, D) -> (G, D,
K)``, so that each window takes every D-th point. Capacities are rounded to
``patch_size * dilation`` so that the regroup is a static reshape.

- `OctreeAttention`: qkv, the (dilated) window attention with a
  relative-position bias (`ptv3.RPE` over grid deltas, floor-divided by the
  dilation), proj. The biased attention is the plain `patch_attention`, the
  route PTv3's RPE blocks take on every device (JAX runs it in XLA).
- `OctFormerBlock`: a depthwise k27 conv (``dw_weight`` (27, C) over the
  level's neighbor table, guard index N reading zeros) with BatchNorm as
  the positional encoding, then prenorm attention and MLP with stochastic
  depth.
- `OctFormer` (registered ``OctFormer-v1m1``): PatchEmbed (k27 convs and
  strided max-pool downsamples), four attention stages with alternating
  dilation, an FPN decoder that lifts each stage's conv output by parent
  broadcast, and ``head_up`` Dense + BatchNorm stages back to level 0.
"""

from __future__ import annotations

from typing import Sequence

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
from cdsegnet_torch.models.ptv3 import RPE
from cdsegnet_torch.models.structure import PointBatch
from cdsegnet_torch.ops.attention import patch_attention
from cdsegnet_torch.ops.pointops import grouping


class OctreeAttention(nn.Module):
    def __init__(self, dim: int, patch_size: int, num_heads: int, dilation: int = 1,
                 qkv_bias: bool = True, use_rpe: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.patch_size, self.num_heads = dim, patch_size, num_heads
        self.dilation = dilation
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.rpe = RPE(patch_size, num_heads) if use_rpe else None
        self.proj = Dense(dim, dim, dtype=dtype)

    def _regroup(self, x, order):
        n, k, dil = x.shape[0], self.patch_size, self.dilation
        x = x[order]
        if dil > 1:  # (G, K, D, ...) -> (G, D, K, ...): window (g, d)
            x = x.reshape((n // (k * dil), k, dil) + x.shape[1:]).transpose(1, 2)
            x = x.reshape((n,) + x.shape[3:])
        return x

    def _ungroup(self, x, inverse):
        n, k, dil = x.shape[0], self.patch_size, self.dilation
        if dil > 1:
            x = x.reshape((n // (k * dil), dil, k) + x.shape[1:]).transpose(1, 2)
            x = x.reshape((n,) + x.shape[3:])
        return x[inverse]

    def forward(self, feat: torch.Tensor, level: pyr.Level) -> torch.Tensor:
        c, h, k = self.dim, self.num_heads, self.patch_size
        pp = level.point
        n = pp.num_points
        order, inverse = pp.orders[0], pp.inverses[0]
        qkv = self.qkv(self._regroup(feat, order)).reshape(n, 3, h, c // h)
        q, kk, v = (qkv[:, i].contiguous() for i in range(3))
        bias = None
        if self.rpe is not None:
            gc = self._regroup(pp.grid_coord, order).reshape(n // k, k, 3)
            rel = gc[:, :, None, :] - gc[:, None, :, :]
            if self.dilation > 1:  # JAX's // floors negative deltas
                rel = torch.div(rel, self.dilation, rounding_mode="floor")
            bias = self.rpe(rel)
        out = patch_attention(q, kk, v, self._regroup(pp.batch, order),
                              self._regroup(pp.mask, order), k, (c // h) ** -0.5, bias=bias)
        return self._ungroup(self.proj(out.reshape(n, c)), inverse)


class OctFormerBlock(nn.Module):
    """Depthwise-conv positional encoding, prenorm window attention, MLP."""

    def __init__(self, dim: int, num_heads: int, patch_size: int, dilation: int = 1,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.0, use_rpe: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        # `utils.weights.init_weights` draws it (flax variance_scaling fan-in)
        self.dw_weight = nn.Parameter(torch.empty(27, dim))
        self.dw_bn = MaskedBatchNorm(dim, dtype=dtype)
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attention = OctreeAttention(dim, patch_size, num_heads, dilation,
                                         use_rpe=use_rpe, dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype=dtype)

    def forward(self, feat, level: pyr.Level, generator=None):
        pp = level.point
        det = not self.training
        g = grouping(feat, pp.neighbor_idx)  # (N, 27, C), guard rows zero
        dw = (g * self.dw_weight.to(feat.dtype)[None]).sum(1)
        feat = feat + self.dw_bn(dw, pp.mask)
        f = self.attention(self.norm1(feat), level)
        feat = feat + drop_path(f, self.drop_path_rate, det, generator)
        f = self.mlp(self.norm2(feat), generator)
        return feat + drop_path(f, self.drop_path_rate, det, generator)


class OctFormer(nn.Module):
    def __init__(
        self,
        in_channels: int = 6,
        num_classes: int = 20,
        fpn_channels: int = 168,
        channels: Sequence[int] = (96, 192, 384, 384),
        num_blocks: Sequence[int] = (2, 2, 18, 2),
        num_heads: Sequence[int] = (6, 12, 24, 24),
        patch_size: int = 32,
        stem_down: int = 2,
        head_up: int = 2,
        dilation: int = 4,
        drop_path: float = 0.5,
        use_rpe: bool = True,
        orders: Sequence[str] = ("z",),
        capacity_div: Sequence[int] = (1, 4, 8, 16, 32, 64),
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.channels, self.num_blocks = tuple(channels), tuple(num_blocks)
        self.patch_size, self.dilation = patch_size, dilation
        self.stem_down, self.head_up = stem_down, head_up
        self.orders = tuple(orders)
        self.capacity_div = tuple(capacity_div)
        self.dtype = dtype
        fpn = fpn_channels
        stages = len(self.channels)
        stem_cs = [int(self.channels[0] * 2 ** i) for i in range(-stem_down, 1)]
        c_in = in_channels
        for i in range(stem_down):
            self.add_module(f"embed_conv{i}", SubMConv(c_in, stem_cs[i], 27, use_bias=False,
                                                       dtype=dtype))
            self.add_module(f"embed_bn{i}", MaskedBatchNorm(stem_cs[i], dtype=dtype))
            self.add_module(f"embed_down{i}", Dense(stem_cs[i], stem_cs[i + 1], bias=False,
                                                    dtype=dtype))
            self.add_module(f"embed_down{i}_bn", MaskedBatchNorm(stem_cs[i + 1], dtype=dtype))
            c_in = stem_cs[i + 1]
        self.embed_proj = SubMConv(stem_cs[-1], self.channels[0], 27, use_bias=False,
                                   dtype=dtype)
        self.embed_proj_bn = MaskedBatchNorm(self.channels[0], dtype=dtype)
        dp = np.linspace(0, drop_path, sum(self.num_blocks))
        for s in range(stages):
            c = self.channels[s]
            if s > 0:
                self.add_module(f"down{s}_proj", Dense(self.channels[s - 1], c, dtype=dtype))
                self.add_module(f"down{s}_bn", MaskedBatchNorm(c, dtype=dtype))
            for b in range(self.num_blocks[s]):
                self.add_module(f"stage{s}_block{b}", OctFormerBlock(
                    c, num_heads[s], patch_size, dilation=1 if b % 2 == 0 else dilation,
                    drop_path_rate=float(dp[sum(self.num_blocks[:s]) + b]),
                    use_rpe=use_rpe, dtype=dtype))
        for i in range(stages):
            s = stages - 1 - i
            self.add_module(f"fpn_1x1_{i}", Dense(self.channels[s], fpn, dtype=dtype))
            self.add_module(f"fpn_3x3_{i}", SubMConv(fpn, fpn, 27, use_bias=False, dtype=dtype))
            self.add_module(f"fpn_3x3_{i}_bn", MaskedBatchNorm(fpn, dtype=dtype))
        for i in range(head_up):
            self.add_module(f"head_up{i}", Dense(fpn, fpn, dtype=dtype))
            self.add_module(f"head_up{i}_bn", MaskedBatchNorm(fpn, dtype=dtype))
        self.head = Dense(fpn, num_classes)

    def precompute_geometry(self, point: PointBatch, perms=None):
        """``(levels, stem_nbr)``: the serialization pyramid (stride 2 per
        level, capacities ``n / capacity_div`` rounded to ``patch_size *
        dilation``) with each pooled level's ``dropped`` a Python int.
        ``perms`` must be None: OctFormer shuffles no curve."""
        if perms is not None:
            raise ValueError("OctFormer takes no curve permutations")
        n_levels = self.stem_down + len(self.channels) - 1
        unit = self.patch_size * self.dilation
        n0 = point.num_points
        caps = [pyr.round_up(max(n0 // d, unit), unit)
                for d in self.capacity_div[1:n_levels + 1]]
        return pyr.build_pyramid(point, strides=(2,) * n_levels, capacities=caps,
                                 orders=self.orders, stem_kernel=3)

    def shuffle_perms(self, generator=None):
        """None: OctFormer does not shuffle its curve."""
        return None

    def _bn_relu(self, name, f, mask):
        return F.relu(getattr(self, name)(f, mask))

    def forward(self, point: PointBatch, geometry=None, generator=None) -> torch.Tensor:
        """Logits ``(N, num_classes)`` in float32. ``geometry`` is a
        precomputed `precompute_geometry`; ``generator`` draws the
        stochastic-depth masks in training (a torch.Generator or
        `DropoutDraws`)."""
        levels, _ = geometry if geometry is not None else self.precompute_geometry(point)
        stages, sd = len(self.channels), self.stem_down
        pts = [lv.point for lv in levels]
        f = point.feat
        for i in range(sd):
            f = getattr(self, f"embed_conv{i}")(f, pts[i].neighbor_idx)
            f = self._bn_relu(f"embed_bn{i}", f, pts[i].mask)
            f = pyr.pool_features(getattr(self, f"embed_down{i}")(f), levels[i + 1], "max")
            f = self._bn_relu(f"embed_down{i}_bn", f, pts[i + 1].mask)
        f = self.embed_proj(f, pts[sd].neighbor_idx)
        f = self._bn_relu("embed_proj_bn", f, pts[sd].mask)

        stage_feats = []
        for s in range(stages):
            lvl = levels[sd + s]
            if s > 0:
                f = pyr.pool_features(getattr(self, f"down{s}_proj")(f), lvl, "max")
                f = getattr(self, f"down{s}_bn")(f, lvl.point.mask)
            for b in range(self.num_blocks[s]):
                f = getattr(self, f"stage{s}_block{b}")(f, lvl, generator)
            stage_feats.append(f)

        def lift(x, from_l):
            for lv in range(from_l, sd, -1):
                x = pyr.unpool_features(x, levels[lv])
            return x

        top = stages - 1
        feature = self.fpn_1x1_0(stage_feats[top])
        li = sd + top
        conv_out = self._bn_relu("fpn_3x3_0_bn", self.fpn_3x3_0(feature, pts[li].neighbor_idx),
                                 pts[li].mask)
        out = lift(conv_out, li)
        for i in range(1, stages):
            s = top - i
            li = sd + s
            feature = pyr.unpool_features(feature, levels[li + 1])
            feature = getattr(self, f"fpn_1x1_{i}")(stage_feats[s]) + feature
            conv_out = getattr(self, f"fpn_3x3_{i}")(feature, pts[li].neighbor_idx)
            conv_out = self._bn_relu(f"fpn_3x3_{i}_bn", conv_out, pts[li].mask)
            out = out + lift(conv_out, li)
        for i in range(self.head_up):
            li = sd - i
            out = getattr(self, f"head_up{i}")(pyr.unpool_features(out, levels[li]))
            out = self._bn_relu(f"head_up{i}_bn", out, pts[li - 1].mask)
        return self.head(out.float())
