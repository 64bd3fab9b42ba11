"""SPVCNN: a sparse-voxel UNet with a high-resolution point branch.

Port of `cdsegnet_tpu/models/spvcnn.py` (reference
`pointcept/models/spvcnn/ts_spvcnn.py`), with the flax module and parameter
names. The torchsparse primitives map onto the shared geometry pyramid as
in JAX:

- ``initial_voxelize`` / ``point_to_voxel``: mean-reduce point features
  into voxel clusters, chained over levels (`_pool_chain`);
- ``voxel_to_point``: the containing voxel's features broadcast back,
  chained over levels (`_unpool_chain`; the reference's ``nearest``
  variant);
- strided convs and deconvs: a Dense and the cluster pool or the parent
  broadcast, then residual submanifold blocks.

The point branch (``pt0``-``pt2``) carries full-resolution features past
every voxel stage. Dropout before the two decoder joins draws its keep mask
from the ``"dropout"`` generator.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cdsegnet_torch.models import pyramid as pyr
from cdsegnet_torch.models.modules import Dense, MaskedBatchNorm, SubMConv, dropout
from cdsegnet_torch.models.structure import PointBatch


def _pool_chain(feat, levels, lo, hi):
    for lv in range(lo + 1, hi + 1):
        feat = pyr.pool_features(feat, levels[lv], reduce="mean")
    return feat


def _unpool_chain(feat, levels, hi, lo):
    for lv in range(hi, lo, -1):
        feat = pyr.unpool_features(feat, levels[lv])
    return feat


class _ConvBNReLU(nn.Module):
    def __init__(self, in_c: int, out_c: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = SubMConv(in_c, out_c, 27, use_bias=False, dtype=dtype)
        self.bn = MaskedBatchNorm(out_c, dtype=dtype)

    def forward(self, feat, nbr, mask):
        return F.relu(self.bn(self.conv(feat, nbr), mask))


class _ResBlock(nn.Module):
    """Residual block with a possible channel change (reference
    `ResidualBlock`, `ts_spvcnn.py:152-175`)."""

    def __init__(self, in_c: int, out_c: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = SubMConv(in_c, out_c, 27, use_bias=False, dtype=dtype)
        self.bn1 = MaskedBatchNorm(out_c, dtype=dtype)
        self.conv2 = SubMConv(out_c, out_c, 27, use_bias=False, dtype=dtype)
        self.bn2 = MaskedBatchNorm(out_c, dtype=dtype)
        if in_c != out_c:
            self.down_proj = Dense(in_c, out_c, bias=False, dtype=dtype)
            self.down_bn = MaskedBatchNorm(out_c, dtype=dtype)
        else:
            self.down_proj = self.down_bn = None

    def forward(self, feat, nbr, mask):
        f = F.relu(self.bn1(self.conv1(feat, nbr), mask))
        f = self.bn2(self.conv2(f, nbr), mask)
        s = feat if self.down_proj is None else self.down_bn(self.down_proj(feat), mask)
        return F.relu(f + s)


class _PointTransform(nn.Module):
    def __init__(self, in_c: int, out_c: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc = Dense(in_c, out_c, dtype=dtype)
        self.bn = MaskedBatchNorm(out_c, dtype=dtype)

    def forward(self, feat, mask):
        return F.relu(self.bn(self.fc(feat), mask))


class SPVCNN(nn.Module):
    """4-stage sparse UNet + point branch (reference `SPVCNN`,
    `ts_spvcnn.py:179-438`)."""

    def __init__(
        self,
        in_channels: int = 4,
        num_classes: int = 19,
        base_channels: int = 32,
        channels: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
        layers: Sequence[int] = (2, 2, 2, 2, 2, 2, 2, 2),
        orders: Sequence[str] = ("z",),
        capacity_div: Sequence[int] = (1, 2, 4, 16, 64),
        drop_rate: float = 0.3,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        ch, ly = tuple(channels), tuple(layers)
        self.channels, self.layers = ch, ly
        self.orders = tuple(orders)
        self.capacity_div = tuple(capacity_div)
        self.drop_rate = drop_rate
        self.dtype = dtype
        base = base_channels
        self.stem1 = _ConvBNReLU(in_channels, base, dtype)
        self.stem2 = _ConvBNReLU(base, base, dtype)
        stage_io = [(base, ch[0]), (ch[0], ch[1]), (ch[1], ch[2]), (ch[2], ch[3])]
        for s, (in_c, out_c) in enumerate(stage_io):
            self.add_module(f"down{s}_proj", Dense(in_c, in_c, dtype=dtype))
            self.add_module(f"down{s}_bn", MaskedBatchNorm(in_c, dtype=dtype))
            self.add_module(f"enc{s}_block0", _ResBlock(in_c, out_c, dtype))
            for i in range(1, ly[s]):
                self.add_module(f"enc{s}_block{i}", _ResBlock(out_c, out_c, dtype))
        self.pt0 = _PointTransform(base, ch[3], dtype)
        self.pt1 = _PointTransform(ch[3], ch[5], dtype)
        self.pt2 = _PointTransform(ch[5], ch[7], dtype)
        # (name, in, out, skip width) of the four decoder stages
        ups = [("up1", ch[3], ch[4], ch[2]), ("up2", ch[4], ch[5], ch[1]),
               ("up3", ch[5], ch[6], ch[0]), ("up4", ch[6], ch[7], base)]
        for s, (name, in_c, out_c, skip_c) in enumerate(ups):
            self.add_module(f"{name}_proj", Dense(in_c, out_c, dtype=dtype))
            self.add_module(f"{name}_bn", MaskedBatchNorm(out_c, dtype=dtype))
            self.add_module(f"{name}_block0", _ResBlock(out_c + skip_c, out_c, dtype))
            for i in range(1, ly[4 + s]):
                self.add_module(f"{name}_block{i}", _ResBlock(out_c, out_c, dtype))
        self.classifier = Dense(ch[7], num_classes)

    def precompute_geometry(self, point: PointBatch, perms=None):
        """``(levels, None)``: the four-level serialization pyramid (k3
        tables) with each pooled level's ``dropped`` read to a Python int.
        ``perms`` must be None: SPVCNN shuffles no curve."""
        if perms is not None:
            raise ValueError("SPVCNN takes no curve permutations")
        n0 = point.num_points
        caps = [pyr.round_up(max(n0 // d, 8), 8) for d in self.capacity_div[1:5]]
        levels, _ = pyr.build_pyramid(point, strides=(2, 2, 2, 2), capacities=caps,
                                      orders=self.orders, stem_kernel=3)
        return levels, None

    def shuffle_perms(self, generator=None):
        """None: SPVCNN has one curve and does not shuffle it."""
        return None

    def _stage(self, s, feat, levels):
        lvl = levels[s + 1].point
        f = getattr(self, f"down{s}_proj")(feat)
        f = _pool_chain(f, levels, s, s + 1)
        f = F.relu(getattr(self, f"down{s}_bn")(f, lvl.mask))
        for i in range(self.layers[s]):
            f = getattr(self, f"enc{s}_block{i}")(f, lvl.neighbor_idx, lvl.mask)
        return f

    def _up(self, s, name, feat, skip, hi, lo, levels):
        lvl = levels[lo].point
        f = getattr(self, f"{name}_proj")(feat)
        f = _unpool_chain(f, levels, hi, lo)
        f = F.relu(getattr(self, f"{name}_bn")(f, lvl.mask))
        f = torch.cat([f, skip.to(f.dtype)], dim=-1)
        for i in range(self.layers[4 + s]):
            f = getattr(self, f"{name}_block{i}")(f, lvl.neighbor_idx, lvl.mask)
        return f

    def forward(self, point: PointBatch, geometry=None, generator=None) -> torch.Tensor:
        """Logits ``(N, num_classes)`` in float32. ``geometry`` is a
        precomputed `precompute_geometry`; in training, dropout draws from
        ``generator`` (a torch generator on the data's device, or a
        `DropoutDraws` with the masks given)."""
        levels, _ = geometry if geometry is not None else self.precompute_geometry(point)
        det = not self.training
        m0, nbr0 = levels[0].point.mask, levels[0].point.neighbor_idx
        x0 = self.stem2(self.stem1(point.feat, nbr0, m0), nbr0, m0)
        z0 = x0  # voxel_to_point at stride 1 is the identity
        x1 = self._stage(0, x0, levels)
        x2 = self._stage(1, x1, levels)
        x3 = self._stage(2, x2, levels)
        x4 = self._stage(3, x3, levels)
        z1 = _unpool_chain(x4, levels, 4, 0) + self.pt0(z0, m0)
        y1_in = dropout(_pool_chain(z1, levels, 0, 4), self.drop_rate, det, generator)
        y1 = self._up(0, "up1", y1_in, x3, 4, 3, levels)
        y2 = self._up(1, "up2", y1, x2, 3, 2, levels)
        z2 = _unpool_chain(y2, levels, 2, 0) + self.pt1(z1, m0)
        y3_in = dropout(_pool_chain(z2, levels, 0, 2), self.drop_rate, det, generator)
        y3 = self._up(2, "up3", y3_in, x1, 2, 1, levels)
        y4 = self._up(3, "up4", y3, x0, 1, 0, levels)
        z3 = y4 + self.pt2(z2, m0)
        return self.classifier(z3.float())
