"""OA-CNNs: omni-adaptive sparse CNNs.

Port of `cdsegnet_tpu/models/oacnns.py` (reference
`pointcept/models/oacnns/oacnns_v1m1_base.py`), with the flax module and
parameter names. The omni-adaptive block aggregates features over several
voxel-grid cluster scales with learned softmax weights, mixes the scales
with a per-point adaptive gate, and runs a submanifold conv pair.

- `grid_clusters`: the reference's ``voxel_grid`` clusters of a level's
  integer voxels. Power-of-two sizes reuse the level's curve-0 z-codes
  right-shifted (no sort); other sizes (the reference's 24/12/6) cluster
  ``grid_coord // size`` with one sort of a packed int64 key. Both give
  the same dense ids as JAX; invalid points take ids above every valid
  point's (their keys sort last).
- the scatter ops of ``torch_geometric`` become `index_add_` (sums) and
  `scatter_reduce` ``"amax"`` (the per-cluster max) over ``m`` static
  segments, in JAX's order of operations; per-point reads of a cluster's
  value are `index_select`s, whose backward scatters with `index_add_`
  (a cluster's many points would form one serial run under ``x[idx]``);
- strided convs are a Dense and the cluster max, inverse convs a Dense and
  the parent broadcast, as in SpUNet.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cdsegnet_torch.models import pyramid as pyr
from cdsegnet_torch.models.modules import Dense, MaskedBatchNorm, SubMConv
from cdsegnet_torch.models.structure import PointBatch
from cdsegnet_torch.ops import segments as seg_ops


def grid_clusters(level: pyr.Level, size: int) -> torch.Tensor:
    """Per-point dense cluster ids (int64, below M) for a ``size``-voxel
    grid at this level, as JAX gives them; invalid points take ids above
    every valid point's (past the level's grid extent a power-of-two shift
    also drops the scene bits, and every point shares one id, as in JAX)."""
    pp = level.point
    m = pp.num_points
    if size & (size - 1) == 0:  # power of two: reuse the z-code sort
        shift = size.bit_length() - 1
        sort0 = pp.orders[0].long()
        keys_sorted = (pp.codes[0] >> (3 * shift))[sort0]
        seg = torch.clamp(seg_ops.sorted_segment_ids(keys_sorted), max=m - 1)
        return torch.zeros(m, dtype=torch.int64, device=seg.device).index_put_(
            (sort0,), seg)
    d = pp.depth  # grid_coord < 2**d per axis, so vox // size fits d bits
    vox = pp.grid_coord.long() // size
    key = ((pp.batch.long() << (3 * d)) | (vox[:, 0] << (2 * d))
           | (vox[:, 1] << d) | vox[:, 2])
    key_bits = 3 * d + max((pp.num_scenes + 1).bit_length(), 1)
    key = torch.where(pp.mask, key, (1 << key_bits) - 1)
    # equal keys share one id whatever their order, so any sort gives
    # JAX's ids
    key_sorted, order = torch.sort(key, stable=True)
    seg = torch.clamp(seg_ops.sorted_segment_ids(key_sorted), max=m - 1)
    return torch.zeros(m, dtype=torch.int64, device=seg.device).index_put_((order,), seg)


def _segment_sum(x: torch.Tensor, ids: torch.Tensor, m: int) -> torch.Tensor:
    """``jax.ops.segment_sum(x, ids, m)``: rows summed into ``m`` segments."""
    return torch.zeros((m,) + x.shape[1:], dtype=x.dtype,
                       device=x.device).index_add_(0, ids, x)


def _segment_max(x: torch.Tensor, ids: torch.Tensor, m: int) -> torch.Tensor:
    """``jax.ops.segment_max(x, ids, m)``: -inf for empty segments."""
    out = torch.full((m,) + x.shape[1:], float("-inf"), dtype=x.dtype, device=x.device)
    return out.scatter_reduce(0, ids[:, None].expand_as(x), x, "amax", include_self=False)


class _LinearBNReLU(nn.Module):
    def __init__(self, in_c: int, out_c: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc = Dense(in_c, out_c, bias=False, dtype=dtype)
        self.bn = MaskedBatchNorm(out_c, dtype=dtype)

    def forward(self, feat, mask):
        return F.relu(self.bn(self.fc(feat), mask))


class OmniAdaptiveBlock(nn.Module):
    """Reference `BasicBlock` (`oacnns_v1m1_base.py:13-111`)."""

    def __init__(self, channels: int, num_scales: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = channels
        self.num_scales = num_scales
        for i in range(num_scales):
            self.add_module(f"l_w{i}", _LinearBNReLU(c, c, dtype))
            self.add_module(f"weight{i}", Dense(c, c, bias=False, dtype=dtype))
            self.add_module(f"proj{i}", _LinearBNReLU(c, c, dtype))
        self.adaptive = Dense(c, num_scales, bias=False, dtype=dtype)
        self.add_module(f"proj{num_scales}", _LinearBNReLU(c, c, dtype))
        self.fuse = _LinearBNReLU(2 * c, c, dtype)
        self.vconv1 = SubMConv(c, c, 27, use_bias=False, dtype=dtype)
        self.vbn1 = MaskedBatchNorm(c, dtype=dtype)
        self.vconv2 = SubMConv(c, c, 27, use_bias=False, dtype=dtype)
        self.vbn2 = MaskedBatchNorm(c, dtype=dtype)

    def forward(self, feat, clusters, nbr, mask):
        m = feat.shape[0]
        valid = mask.to(feat.dtype)[:, None]
        scale_feats = []
        for i, cluster in enumerate(clusters):
            pw = getattr(self, f"l_w{i}")(feat, mask) * valid
            cnt = _segment_sum(valid[:, 0], cluster, m)
            s = _segment_sum(pw, cluster, m)
            pw = pw - (s / torch.clamp(cnt, min=1.0)[:, None]).index_select(0, cluster) * valid
            pw = getattr(self, f"weight{i}")(pw)
            # per-cluster max (scatter_softmax semantics)
            cmax = _segment_max(torch.where(valid > 0, pw, float("-inf")), cluster, m)
            cmax = torch.where(torch.isfinite(cmax), cmax,
                               torch.zeros_like(cmax)).index_select(0, cluster)
            pw = torch.exp(pw - cmax) * valid
            denom = _segment_sum(pw, cluster, m).index_select(0, cluster) + 1e-6
            pw = pw / denom
            pf = getattr(self, f"proj{i}")(feat, mask) * pw
            scale_feats.append(_segment_sum(pf * valid, cluster, m).index_select(0, cluster))
        adp = torch.softmax(self.adaptive(feat).float(), dim=-1).to(feat.dtype)
        mixed = sum(adp[:, i:i + 1] * scale_feats[i] for i in range(self.num_scales))
        f_self = getattr(self, f"proj{self.num_scales}")(feat, mask)
        fused = self.fuse(torch.cat([f_self, mixed], dim=-1), mask) + feat
        f = F.relu(self.vbn1(self.vconv1(fused, nbr), mask))
        f = self.vbn2(self.vconv2(f, nbr), mask)
        return F.relu(f + fused)


class OACNNs(nn.Module):
    """Reference `OACNNs` (`oacnns_v1m1_base.py:214-345`)."""

    def __init__(
        self,
        in_channels: int = 6,
        num_classes: int = 20,
        embed_channels: int = 64,
        enc_channels: Sequence[int] = (64, 64, 128, 256),
        enc_depth: Sequence[int] = (2, 3, 6, 4),
        dec_channels: Sequence[int] = (96, 96, 128, 256),
        point_grid_size: Sequence[Sequence[int]] = (
            (16, 32, 64), (8, 16, 24), (4, 8, 12), (2, 4, 6)),
        orders: Sequence[str] = ("z",),
        capacity_div: Sequence[int] = (1, 2, 4, 16, 64),
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.enc_channels, self.enc_depth = tuple(enc_channels), tuple(enc_depth)
        self.dec_channels = tuple(dec_channels)
        self.point_grid_size = tuple(tuple(g) for g in point_grid_size)
        self.orders = tuple(orders)
        self.capacity_div = tuple(capacity_div)
        self.dtype = dtype
        stages = len(self.enc_channels)
        c_in = in_channels
        for i in range(3):
            self.add_module(f"stem{i}", SubMConv(c_in, embed_channels, 27, use_bias=False,
                                                 dtype=dtype))
            self.add_module(f"stem{i}_bn", MaskedBatchNorm(embed_channels, dtype=dtype))
            c_in = embed_channels
        skip_ch = [embed_channels] + list(self.enc_channels)
        for s in range(stages):
            c = self.enc_channels[s]
            self.add_module(f"down{s}_proj", Dense(skip_ch[s], c, bias=False, dtype=dtype))
            self.add_module(f"down{s}_bn", MaskedBatchNorm(c, dtype=dtype))
            for i in range(self.enc_depth[s]):
                self.add_module(f"enc{s}_block{i}", OmniAdaptiveBlock(
                    c, len(self.point_grid_size[s]), dtype=dtype))
        up_in = list(self.dec_channels[1:]) + [self.enc_channels[-1]]
        for s in reversed(range(stages)):
            c = self.dec_channels[s]
            self.add_module(f"up{s}_proj", Dense(up_in[s], c, bias=False, dtype=dtype))
            self.add_module(f"up{s}_bn", MaskedBatchNorm(c, dtype=dtype))
            self.add_module(f"up{s}_fuse1", _LinearBNReLU(c + skip_ch[s], c, dtype))
            self.add_module(f"up{s}_fuse2", _LinearBNReLU(c, c, dtype))
        self.final = Dense(self.dec_channels[0], num_classes)

    def precompute_geometry(self, point: PointBatch, perms=None):
        """``(levels, clusters)``: the serialization pyramid (stride 2 per
        stage, k3 tables) with each pooled level's ``dropped`` read to a
        Python int, and each stage's `grid_clusters` ids. ``perms`` must be
        None: OA-CNNs shuffles no curve."""
        if perms is not None:
            raise ValueError("OACNNs takes no curve permutations")
        stages = len(self.enc_channels)
        n0 = point.num_points
        caps = [pyr.round_up(max(n0 // d, 8), 8) for d in self.capacity_div[1:stages + 1]]
        levels, _ = pyr.build_pyramid(point, strides=(2,) * stages, capacities=caps,
                                      orders=self.orders, stem_kernel=3)
        clusters = [[grid_clusters(levels[s + 1], gs) for gs in self.point_grid_size[s]]
                    for s in range(stages)]
        return levels, clusters

    def shuffle_perms(self, generator=None):
        """None: OA-CNNs has one curve and does not shuffle it."""
        return None

    def forward(self, point: PointBatch, geometry=None, generator=None) -> torch.Tensor:
        """Logits ``(N, num_classes)`` in float32. ``geometry`` is a
        precomputed `precompute_geometry`; ``generator`` is unused."""
        levels, clusters = (geometry if geometry is not None
                            else self.precompute_geometry(point))
        stages = len(self.enc_channels)
        m0, nbr0 = levels[0].point.mask, levels[0].point.neighbor_idx
        f = point.feat
        for i in range(3):
            f = getattr(self, f"stem{i}")(f, nbr0)
            f = F.relu(getattr(self, f"stem{i}_bn")(f, m0))
        skips = [f]
        for s in range(stages):
            lvl = levels[s + 1]
            f = getattr(self, f"down{s}_proj")(f)
            f = pyr.pool_features(f, lvl, reduce="max")
            f = F.relu(getattr(self, f"down{s}_bn")(f, lvl.point.mask))
            for i in range(self.enc_depth[s]):
                f = getattr(self, f"enc{s}_block{i}")(
                    f, clusters[s], lvl.point.neighbor_idx, lvl.point.mask)
            skips.append(f)
        f = skips.pop()
        for s in reversed(range(stages)):
            skip = skips.pop()
            lo = levels[s].point.mask
            f = getattr(self, f"up{s}_proj")(f)
            f = pyr.unpool_features(f, levels[s + 1])
            f = F.relu(getattr(self, f"up{s}_bn")(f, lo))
            g = torch.cat([f, skip.to(f.dtype)], dim=-1)
            g = getattr(self, f"up{s}_fuse1")(g, lo)
            g = getattr(self, f"up{s}_fuse2")(g, lo)
            f = g + f
        return self.final(f.float())
