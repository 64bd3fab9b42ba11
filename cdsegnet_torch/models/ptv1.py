"""Point Transformer V1: vector attention over kNN graphs with
farthest-point-sampling downsampling.

Port of `cdsegnet_tpu/models/ptv1.py` (reference
`pointcept/models/point_transformer/point_transformer_seg.py`), with the
flax module and parameter names, so that `utils.weights.load_jax_variables`
maps a JAX checkpoint name for name.

- `PointTransformerLayer`: share_planes vector attention. The reference's
  ``LayerNorm1d`` is a transposed BatchNorm1d, so the norms inside
  ``linear_p``/``linear_w`` are masked BatchNorms over the (N·K) neighbor
  rows, at torch's defaults (eps 1e-5, momentum 0.1). The softmax over the
  K neighbors runs in float32, -1e9 on guard slots.
- `TransitionDown`: kNN grouping of ``[rel_xyz, feat]`` around each FPS
  sample, Dense, BatchNorm, relu, max over the neighbors (-inf on guard
  rows; `amax` splits a tie's gradient evenly, as JAX's max does).
- `Bottleneck` and `PointTransformerV1` (registered ``PT-v1``;
  ``PointTransformer-Seg26``/``-Seg38``/``-Seg50`` are its depths): a
  5-stage UNet. The geometry is built once per forward: the per-scene FPS
  chain (`ops.pointops.farthest_point_sampling_batched`, stride 4), one
  down-kNN table per level and one self-kNN table per level shared by
  every block there. The head TransitionUp concatenates the masked scene
  mean; the fusion ones add a 3-NN interpolation of the coarse features.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cdsegnet_torch.models import pyramid as pyr
from cdsegnet_torch.models.modules import Dense, MaskedBatchNorm
from cdsegnet_torch.models.structure import PointBatch
from cdsegnet_torch.ops.pointops import (
    farthest_point_sampling_batched,
    grouping,
    knn,
    three_interpolation,
)


def _bn(c: int, dtype: torch.dtype) -> MaskedBatchNorm:
    """torch BatchNorm1d's defaults, which the reference uses throughout."""
    return MaskedBatchNorm(c, eps=1e-5, momentum=0.1, dtype=dtype)


def _bn_flat(bn: MaskedBatchNorm, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked BatchNorm over the channel dim of an (..., C) tensor."""
    return bn(x.reshape(-1, x.shape[-1]), mask.reshape(-1)).reshape(x.shape)


class PointTransformerLayer(nn.Module):
    def __init__(self, channels: int, share_planes: int = 8, nsample: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c, sp = channels, share_planes
        self.channels, self.share_planes, self.nsample = c, sp, nsample
        self.dtype = dtype
        self.linear_q = Dense(c, c, dtype=dtype)
        self.linear_k = Dense(c, c, dtype=dtype)
        self.linear_v = Dense(c, c, dtype=dtype)
        self.linear_p1 = Dense(3, 3, dtype=dtype)
        self.linear_p_bn = _bn(3, dtype)
        self.linear_p2 = Dense(3, c, dtype=dtype)
        self.linear_w_bn1 = _bn(c, dtype)
        self.linear_w1 = Dense(c, c // sp, dtype=dtype)
        self.linear_w_bn2 = _bn(c // sp, dtype)
        self.linear_w2 = Dense(c // sp, c // sp, dtype=dtype)

    def forward(self, feat, coord, idx, mask):
        c, sp = self.channels, self.share_planes
        n = feat.shape[0]
        q = self.linear_q(feat)
        k_n = grouping(self.linear_k(feat), idx)  # (N, K, C)
        v_n = grouping(self.linear_v(feat), idx)
        pos = (grouping(coord, idx) - coord[:, None, :]).to(self.dtype)
        nmask = mask[:, None] & (idx < n)
        p = _bn_flat(self.linear_p_bn, self.linear_p1(pos), nmask)
        p_r = self.linear_p2(F.relu(p))
        r = k_n - q[:, None, :] + p_r  # mid == out: the share-reduce is the identity
        w = _bn_flat(self.linear_w_bn1, r, nmask)
        w = _bn_flat(self.linear_w_bn2, self.linear_w1(F.relu(w)), nmask)
        w = self.linear_w2(F.relu(w))
        w = torch.where(nmask[..., None], w.float(), -1e9)
        w = torch.softmax(w, dim=1).to(self.dtype)  # (N, K, C / sp)
        a = (v_n + p_r).reshape(n, idx.shape[1], sp, c // sp)
        return (a * w[:, :, None, :]).sum(1).reshape(n, c)


class Bottleneck(nn.Module):
    """linear1-BN-relu, transformer-BN-relu, linear3-BN, residual relu."""

    def __init__(self, channels: int, share_planes: int = 8, nsample: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = channels
        self.linear1 = Dense(c, c, bias=False, dtype=dtype)
        self.bn1 = _bn(c, dtype)
        self.transformer = PointTransformerLayer(c, share_planes, nsample, dtype=dtype)
        self.bn2 = _bn(c, dtype)
        self.linear3 = Dense(c, c, bias=False, dtype=dtype)
        self.bn3 = _bn(c, dtype)

    def forward(self, feat, coord, idx, mask):
        x = F.relu(self.bn1(self.linear1(feat), mask))
        x = F.relu(self.bn2(self.transformer(x, coord, idx, mask), mask))
        x = self.bn3(self.linear3(x), mask)
        return F.relu(feat + x)


class TransitionDown(nn.Module):
    """kNN group of [rel_xyz, feat] around each sample, Dense, BN, relu,
    max over the neighbors (the reference's stride != 1 branch)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.linear = Dense(3 + in_channels, out_channels, bias=False, dtype=dtype)
        self.bn = _bn(out_channels, dtype)

    def forward(self, parent_feat, parent_coord, new_coord, down_idx, new_mask):
        n = parent_feat.shape[0]
        g = grouping(parent_feat, down_idx)  # (M, K, C_in)
        rel = (grouping(parent_coord, down_idx) - new_coord[:, None, :]).to(self.dtype)
        x = self.linear(torch.cat([rel, g.to(self.dtype)], dim=-1))
        nmask = new_mask[:, None] & (down_idx < n)
        x = F.relu(_bn_flat(self.bn, x, nmask))
        x = torch.where(nmask[..., None], x, float("-inf")).amax(dim=1)
        return torch.where(new_mask[:, None], x, 0.0).to(self.dtype)


def _take(x: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``x[idx]`` with index ``len(x)`` reading ``fill``."""
    pad = torch.full((1,) + x.shape[1:], fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])[idx.long()]


class PointTransformerV1(nn.Module):
    """PointTransformerSeg: a 5-stage FPS UNet of Bottleneck blocks.
    ``depths`` picks the variant: (1,1,1,1,1) Seg26, (1,2,2,2,2) Seg38,
    (1,2,3,5,2) Seg50."""

    def __init__(
        self,
        in_channels: int = 6,
        num_classes: int = 20,
        channels: Sequence[int] = (32, 64, 128, 256, 512),
        depths: Sequence[int] = (1, 2, 2, 2, 2),
        share_planes: int = 8,
        nsample: Sequence[int] = (8, 16, 16, 16, 16),
        stride: int = 4,
        capacity_div: Sequence[int] = (1, 4, 16, 64, 256),
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.channels, self.depths = tuple(channels), tuple(depths)
        self.nsample = tuple(nsample)
        self.stride = stride
        self.capacity_div = tuple(capacity_div)
        self.dtype = dtype
        stages = len(self.channels)
        blk = lambda s: Bottleneck(self.channels[s], share_planes, self.nsample[s], dtype=dtype)
        for s in range(stages):
            c = self.channels[s]
            if s == 0:
                self.enc0_down = Dense(in_channels, c, bias=False, dtype=dtype)
                self.enc0_down_bn = _bn(c, dtype)
            else:
                self.add_module(f"enc{s}_down",
                                TransitionDown(self.channels[s - 1], c, dtype=dtype))
            for i in range(self.depths[s]):
                self.add_module(f"enc{s}_block{i}", blk(s))
        top = stages - 1
        c_top = self.channels[top]
        self.add_module(f"dec{top}_l2", Dense(c_top, c_top, dtype=dtype))
        self.add_module(f"dec{top}_l1", Dense(2 * c_top, c_top, dtype=dtype))
        self.add_module(f"dec{top}_l1_bn", _bn(c_top, dtype))
        self.add_module(f"dec{top}_block0", blk(top))
        for s in reversed(range(stages - 1)):
            c = self.channels[s]
            self.add_module(f"dec{s}_l1", Dense(c, c, dtype=dtype))
            self.add_module(f"dec{s}_l1_bn", _bn(c, dtype))
            self.add_module(f"dec{s}_l2", Dense(self.channels[s + 1], c, dtype=dtype))
            self.add_module(f"dec{s}_l2_bn", _bn(c, dtype))
            self.add_module(f"dec{s}_block0", blk(s))
        c0 = self.channels[0]
        self.cls_fc = Dense(c0, c0, dtype=dtype)
        self.cls_bn = _bn(c0, dtype)
        self.head = Dense(c0, num_classes)

    @torch.no_grad()
    def precompute_geometry(self, point: PointBatch, perms=None):
        """``(levels, down_idx, self_idx)``: per level a `pyramid.Level`
        whose point holds the FPS samples' coords, mask and scene ids (the
        sentinel at unused slots; ``dropped`` 0: FPS drops nothing), the
        down-kNN table from each level into its parent (None at level 0)
        and the self-kNN table of each level. ``perms`` must be None: PTv1
        has no curves to shuffle."""
        if perms is not None:
            raise ValueError("PTv1 takes no curve permutations")
        ns = point.num_scenes
        n0 = point.num_points
        coords = [point.coord.float()]
        batches = [torch.where(point.mask, point.batch.long(), ns)]
        masks = [point.mask]
        down_idx = [None]
        for s in range(1, len(self.channels)):
            cap = pyr.round_up(max(n0 // self.capacity_div[s], 8), 8)
            sel = farthest_point_sampling_batched(coords[-1], batches[-1], masks[-1], cap,
                                                  self.stride, ns)
            new_mask = sel < coords[-1].shape[0]
            coords.append(_take(coords[-1], sel, 0.0))
            batches.append(torch.where(new_mask, _take(batches[-1], sel, ns), ns))
            masks.append(new_mask)
            down_idx.append(knn(coords[-1], coords[-2], self.nsample[s], masks[-1], masks[-2],
                                query_batch=batches[-1], ref_batch=batches[-2])[0])
        self_idx = [knn(c, c, k, m, m, query_batch=b, ref_batch=b)[0]
                    for c, m, b, k in zip(coords, masks, batches, self.nsample)]
        levels = [pyr.Level(
            point=PointBatch(coord=c, grid_coord=torch.zeros_like(c, dtype=torch.int32),
                             feat=c.new_zeros((c.shape[0], 1)), mask=m,
                             batch=b.to(torch.int32), depth=point.depth, num_scenes=ns),
            dropped=0 if s else None)
            for s, (c, m, b) in enumerate(zip(coords, masks, batches))]
        return levels, down_idx, self_idx

    def shuffle_perms(self, generator=None):
        """None: PTv1 has no serialization curves to shuffle."""
        return None

    def _blocks(self, x, s, tag, levels, self_idx):
        pt = levels[s].point
        depth = self.depths[s] if tag == "enc" else 1
        for i in range(depth):
            x = getattr(self, f"{tag}{s}_block{i}")(x, pt.coord, self_idx[s], pt.mask)
        return x

    def forward(self, point: PointBatch, geometry=None, generator=None) -> torch.Tensor:
        """Logits ``(N, num_classes)`` in float32. ``geometry`` is a
        precomputed `precompute_geometry`; ``generator`` is unused (PTv1
        draws nothing)."""
        levels, down_idx, self_idx = (geometry if geometry is not None
                                      else self.precompute_geometry(point))
        stages = len(self.channels)
        pts = [lv.point for lv in levels]
        skips = []
        x = point.feat.to(self.dtype)
        for s in range(stages):
            if s == 0:
                x = F.relu(self.enc0_down_bn(self.enc0_down(x), pts[0].mask))
            else:
                x = getattr(self, f"enc{s}_down")(x, pts[s - 1].coord, pts[s].coord,
                                                   down_idx[s], pts[s].mask)
            x = self._blocks(x, s, "enc", levels, self_idx)
            skips.append(x)

        top = stages - 1
        pt = pts[top]
        ns = point.num_scenes
        b = pt.batch.long()
        xm = x.float() * pt.mask[:, None]
        sums = xm.new_zeros((ns + 1, x.shape[1])).index_add(0, b, xm)
        cnt = xm.new_zeros((ns + 1, 1)).index_add(0, b, pt.mask.float()[:, None])
        mean = (sums / torch.clamp(cnt, min=1.0)).to(self.dtype)
        g = F.relu(getattr(self, f"dec{top}_l2")(mean))
        x = torch.cat([x, g.index_select(0, b)], dim=-1)
        x = F.relu(getattr(self, f"dec{top}_l1_bn")(getattr(self, f"dec{top}_l1")(x),
                                                     pt.mask))
        x = self._blocks(x, top, "dec", levels, self_idx)
        for s in reversed(range(stages - 1)):
            lo, hi = pts[s], pts[s + 1]
            a = F.relu(getattr(self, f"dec{s}_l1_bn")(getattr(self, f"dec{s}_l1")(skips[s]),
                                                       lo.mask))
            c = F.relu(getattr(self, f"dec{s}_l2_bn")(getattr(self, f"dec{s}_l2")(x),
                                                       hi.mask))
            x = a + three_interpolation(lo.coord, hi.coord, c, lo.mask, hi.mask,
                                        target_batch=lo.batch, source_batch=hi.batch)
            x = self._blocks(x, s, "dec", levels, self_idx)
        x = F.relu(self.cls_bn(self.cls_fc(x), pts[0].mask))
        return self.head(x.float())


# the registered names of the JAX package: Seg26/38/50 are PT-v1 at their
# reference depths
VARIANTS = {"PT-v1": {}, "PointTransformer-Seg26": dict(depths=(1, 1, 1, 1, 1)),
            "PointTransformer-Seg38": dict(depths=(1, 2, 2, 2, 2)),
            "PointTransformer-Seg50": dict(depths=(1, 2, 3, 5, 2))}
