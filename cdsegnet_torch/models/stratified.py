"""Stratified Transformer: window attention with stratified coarse keys.

Port of `cdsegnet_tpu/models/stratified.py` (reference
`pointcept/models/stratified_transformer/stratified_transformer_v1m1_origin.py`),
with the flax module and parameter names, so that
`utils.weights.load_jax_variables` maps a JAX checkpoint name for name.

- Fine windows are serialized patches of ``patch_size`` points; each block
  takes the next of the four curves (``order_index = i % 4``), which stands
  in for the reference's shifted windows.
- The stratified distant keys of fine patch p are the aligned slots ``[p
  kc, (p + 1) kc)`` of the next level's order on the same curve (``kc = M
  // P``; the tail past ``P kc`` is trimmed), carrying that level's
  max-pooled features through their own projection ``kv_coarse`` (built
  even when ``kc == 0``, so that the parameters do not depend on the
  bucket).
- The logits take a learned relative-position bias (`ptv3.RPE`, table
  sized for ``patch_size``) over grid deltas, the coarse grid coordinates
  doubled. Keys of another scene or invalid are -inf, and the
  probabilities are zeroed after the softmax, so a row with no visible key
  gives zeros and a zero gradient.
- The KPConv stem is a k27 submanifold conv; TransitionDown is Dense,
  max-pool, BatchNorm, relu; the decoder adds a Dense of the skip to the
  broadcast of a Dense of the coarser level.

Registered as ``StratifiedTransformer`` and ``StratifiedTransformer-v1m1``.
"""

from __future__ import annotations

from typing import Optional, Sequence

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
from cdsegnet_torch.models.ptv3 import DEFAULT_ORDERS, RPE
from cdsegnet_torch.models.structure import PointBatch


class StratifiedAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, patch_size: int, order_index: int = 0,
                 use_rpe: bool = True, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.num_heads, self.patch_size = dim, num_heads, patch_size
        self.order_index = order_index
        self.q = Dense(dim, dim, bias=qkv_bias, dtype=dtype)
        self.kv = Dense(dim, 2 * dim, bias=qkv_bias, dtype=dtype)
        self.kv_coarse = Dense(dim, 2 * dim, bias=qkv_bias, dtype=dtype)
        self.rpe = RPE(patch_size, num_heads) if use_rpe else None
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, feat, level: pyr.Level, coarse: Optional[pyr.Level], coarse_feat):
        c, h, k = self.dim, self.num_heads, self.patch_size
        d = c // h
        pp = level.point
        n = pp.num_points
        p = n // k
        o = self.order_index % pp.orders.shape[0]
        order, inverse = pp.orders[o], pp.inverses[o]
        fs = feat[order]
        q = self.q(fs).reshape(p, k, h, d)
        keys = [self.kv(fs).reshape(p, k, 2, h, d)]
        bs_q = pp.batch[order].reshape(p, k)
        ms_q = pp.mask[order].reshape(p, k)
        gc_q = pp.grid_coord[order].reshape(p, k, 3)
        bs_k, ms_k, gc_k = [bs_q], [ms_q], [gc_q]
        if coarse is not None:
            cp = coarse.point
            kc = cp.num_points // p  # coarse slots aligned to each fine patch
            corder = cp.orders[o % cp.orders.shape[0]]
            kv_coarse = self.kv_coarse(coarse_feat[corder])
            if kc > 0:  # trim the tail past p * kc
                t = p * kc
                keys.append(kv_coarse[:t].reshape(p, kc, 2, h, d))
                bs_k.append(cp.batch[corder][:t].reshape(p, kc))
                ms_k.append(cp.mask[corder][:t].reshape(p, kc))
                gc_k.append((cp.grid_coord[corder] * 2)[:t].reshape(p, kc, 3))
        kv = torch.cat(keys, dim=1)  # (P, K + Kc, 2, H, D)
        bsk, msk, gck = (torch.cat(x, dim=1) for x in (bs_k, ms_k, gc_k))
        logits = torch.einsum("pqhd,pkhd->phqk", q * (d ** -0.5), kv[:, :, 0]).float()
        if self.rpe is not None:
            logits = logits + self.rpe(gc_q[:, :, None, :] - gck[:, None, :, :]).float()
        ok = ((bs_q[:, :, None] == bsk[:, None, :]) & msk[:, None, :])[:, None]
        logits = torch.where(ok, logits, float("-inf"))
        attn = torch.softmax(logits, dim=-1)
        attn = torch.where(ok, attn, 0.0).to(kv.dtype)
        out = torch.einsum("phqk,pkhd->pqhd", attn, kv[:, :, 1]).reshape(n, c)
        return self.proj(out)[inverse]


class StratifiedBlock(nn.Module):
    """LayerNorm, stratified window attention, MLP, with stochastic depth."""

    def __init__(self, dim: int, num_heads: int, patch_size: int, order_index: int = 0,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.0, use_rpe: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = StratifiedAttention(dim, num_heads, patch_size, order_index,
                                        use_rpe=use_rpe, dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype=dtype)

    def forward(self, feat, level, coarse, coarse_feat, generator=None):
        det = not self.training
        f = self.attn(self.norm1(feat), level, coarse, coarse_feat)
        feat = feat + drop_path(f, self.drop_path_rate, det, generator)
        f = self.mlp(self.norm2(feat), generator)
        return feat + drop_path(f, self.drop_path_rate, det, generator)


class StratifiedTransformer(nn.Module):
    def __init__(
        self,
        in_channels: int = 6,
        num_classes: int = 20,
        channels: Sequence[int] = (48, 96, 192, 384),
        depths: Sequence[int] = (2, 2, 6, 2),
        num_heads: Sequence[int] = (3, 6, 12, 24),
        patch_size: int = 128,
        mlp_ratio: float = 4.0,
        drop_path: float = 0.3,
        use_rpe: bool = True,
        orders: Sequence[str] = DEFAULT_ORDERS,
        capacity_div: Sequence[int] = (1, 2, 4, 8, 16),
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.channels, self.depths = tuple(channels), tuple(depths)
        self.patch_size = patch_size
        self.orders = tuple(orders)
        self.capacity_div = tuple(capacity_div)
        self.dtype = dtype
        stages = len(self.channels)
        self.stem_conv = SubMConv(in_channels, self.channels[0], 27, use_bias=False,
                                  dtype=dtype)
        self.stem_bn = MaskedBatchNorm(self.channels[0], dtype=dtype)
        dp = np.linspace(0, drop_path, sum(self.depths))
        for s in range(stages):
            c = self.channels[s]
            if s > 0:
                self.add_module(f"down{s}_proj", Dense(self.channels[s - 1], c, bias=False,
                                                       dtype=dtype))
                self.add_module(f"down{s}_bn", MaskedBatchNorm(c, dtype=dtype))
            for i in range(self.depths[s]):
                self.add_module(f"stage{s}_block{i}", StratifiedBlock(
                    c, num_heads[s], patch_size, order_index=i % len(self.orders),
                    mlp_ratio=mlp_ratio, drop_path_rate=float(dp[sum(self.depths[:s]) + i]),
                    use_rpe=use_rpe, dtype=dtype))
        for s in reversed(range(stages - 1)):
            c = self.channels[s]
            self.add_module(f"up{s}_proj", Dense(self.channels[s + 1], c, dtype=dtype))
            self.add_module(f"up{s}_skip", Dense(c, c, dtype=dtype))
        self.head = Dense(self.channels[0], num_classes)

    def precompute_geometry(self, point: PointBatch, perms=None):
        """``(levels, stem_nbr)``: the serialization pyramid on the four
        curves (stride 2 per stage, capacities ``n / capacity_div`` rounded
        to ``patch_size``; one level past the last stage holds the last
        stage's coarse keys), each pooled level's ``dropped`` a Python int.
        ``perms`` must be None: the curves are not shuffled."""
        if perms is not None:
            raise ValueError("Stratified takes no curve permutations")
        stages, k = len(self.channels), self.patch_size
        n0 = point.num_points
        caps = [pyr.round_up(max(n0 // d, k), k) for d in self.capacity_div[1:stages + 1]]
        return pyr.build_pyramid(point, strides=(2,) * stages, capacities=caps,
                                 orders=self.orders, stem_kernel=3)

    def shuffle_perms(self, generator=None):
        """None: Stratified takes a fixed curve per block."""
        return None

    def forward(self, point: PointBatch, geometry=None, generator=None) -> torch.Tensor:
        """Logits ``(N, num_classes)`` in float32. ``geometry`` is a
        precomputed `precompute_geometry`; ``generator`` draws the
        stochastic-depth masks in training."""
        levels, _ = geometry if geometry is not None else self.precompute_geometry(point)
        stages = len(self.channels)
        f = self.stem_conv(point.feat, levels[0].point.neighbor_idx)
        f = F.relu(self.stem_bn(f, levels[0].point.mask))
        skips = []
        for s in range(stages):
            lvl = levels[s]
            if s > 0:
                f = pyr.pool_features(getattr(self, f"down{s}_proj")(f), lvl, "max")
                f = F.relu(getattr(self, f"down{s}_bn")(f, lvl.point.mask))
            coarse = levels[s + 1]
            coarse_feat = pyr.pool_features(f, coarse, "max")
            for i in range(self.depths[s]):
                f = getattr(self, f"stage{s}_block{i}")(f, lvl, coarse, coarse_feat, generator)
            skips.append(f)
        f = skips[-1]
        for s in reversed(range(stages - 1)):
            f = pyr.unpool_features(getattr(self, f"up{s}_proj")(f), levels[s + 1])
            f = f + getattr(self, f"up{s}_skip")(skips[s])
        return self.head(f.float())
