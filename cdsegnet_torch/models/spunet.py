"""SpUNet: a sparse-conv UNet on the shared geometry pyramid.

Port of `cdsegnet_tpu/models/spunet.py` (reference `SpUNetBase`,
`pointcept/models/sparse_unet/spconv_unet_v1m1_base.py`), with the flax
module and parameter names, so that `utils.weights.load_jax_variables` maps
a JAX checkpoint name for name. A UNet of submanifold ResNet blocks:

- the stem is one k125 (5x5x5) submanifold conv over the level-0 stem
  table, the blocks k27 convs over each level's table (`SubMConv`, gather
  form);
- the strided `SparseConv3d` downsample is a Dense, then the cluster max
  over the pyramid; the `SparseInverseConv3d` upsample is a Dense, then the
  parent broadcast, concatenated with the skip and fused by a Dense;
- BatchNorm is masked, or prompt-driven per condition (``num_conditions``
  > 0, `SpUNet-v1m3`).

Registered as ``SpUNet-v1m1``, ``MinkUNet`` (the same topology) and
``SpUNet-v1m3``. With ``num_classes == 0`` (feature mode) there is no
``final`` head and the model returns the last decoder block's features, as
JAX and the reference do (CAC and PointGroup read them).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cdsegnet_torch.models import pyramid as pyr
from cdsegnet_torch.models.modules import Dense, SubMConv, apply_norm, make_norm
from cdsegnet_torch.models.structure import PointBatch


class BasicBlock(nn.Module):
    """Submanifold ResNet basic block (conv-bn-relu x2 + residual)."""

    def __init__(self, channels: int, num_conditions: int = 0,
                 pdnorm_adaptive: bool = False, context_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = channels
        pd = dict(num_conditions=num_conditions, adaptive=pdnorm_adaptive,
                  context_channels=context_channels, dtype=dtype)
        self.conv1 = SubMConv(c, c, 27, use_bias=False, dtype=dtype)
        self.bn1 = make_norm(c, **pd)
        self.conv2 = SubMConv(c, c, 27, use_bias=False, dtype=dtype)
        self.bn2 = make_norm(c, **pd)

    def forward(self, feat, nbr, mask, condition: int = 0, context=None):
        f = F.relu(apply_norm(self.bn1, self.conv1(feat, nbr), mask, condition, context))
        f = apply_norm(self.bn2, self.conv2(f, nbr), mask, condition, context)
        return F.relu(feat + f)


class SpUNet(nn.Module):
    """SpUNet-v1m1 (and MinkUNet, SpUNet-v1m3): ``channels`` holds the
    encoder stages' widths, then the decoder's from coarse to fine."""

    def __init__(
        self,
        in_channels: int = 6,
        num_classes: int = 20,
        base_channels: int = 32,
        channels: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
        layers: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2),
        orders: Sequence[str] = ("z",),
        capacity_div: Sequence[int] = (1, 2, 4, 16, 64),
        num_conditions: int = 0,
        pdnorm_adaptive: bool = False,
        context_channels: int = 256,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.channels, self.layers = tuple(channels), tuple(layers)
        self.orders = tuple(orders)
        self.capacity_div = tuple(capacity_div)
        self.dtype = dtype
        stages = len(self.channels) // 2
        self.num_stages = stages
        pd = dict(num_conditions=num_conditions, adaptive=pdnorm_adaptive,
                  context_channels=context_channels, dtype=dtype)
        blk = dict(num_conditions=num_conditions, pdnorm_adaptive=pdnorm_adaptive,
                   context_channels=context_channels, dtype=dtype)
        self.stem_conv = SubMConv(in_channels, base_channels, 125, use_bias=False,
                                  dtype=dtype)
        self.stem_bn = make_norm(base_channels, **pd)
        enc_in = [base_channels] + list(self.channels[:stages])
        for s in range(stages):
            c = self.channels[s]
            self.add_module(f"down{s}_proj", Dense(enc_in[s], c, dtype=dtype))
            self.add_module(f"down{s}_bn", make_norm(c, **pd))
            for i in range(self.layers[s]):
                self.add_module(f"enc{s}_block{i}", BasicBlock(c, **blk))
        dec_in = self.channels[stages - 1]
        for s in reversed(range(stages)):
            j = stages + (stages - 1 - s)
            dec_c = self.channels[j]
            self.add_module(f"up{s}_proj", Dense(dec_in, dec_c, dtype=dtype))
            self.add_module(f"up{s}_fuse", Dense(dec_c + enc_in[s], dec_c, dtype=dtype))
            self.add_module(f"up{s}_bn", make_norm(dec_c, **pd))
            for i in range(self.layers[j]):
                self.add_module(f"dec{s}_block{i}", BasicBlock(dec_c, **blk))
            dec_in = dec_c
        self.final = Dense(dec_in, num_classes) if num_classes > 0 else None

    def precompute_geometry(self, point: PointBatch, perms=None):
        """``(levels, stem_nbr)``: the serialization pyramid (stride 2 per
        stage, capacities ``n / capacity_div``) with each pooled level's
        ``dropped`` read to a Python int, and the level-0 k125 stem table.
        ``perms`` must be None: SpUNet shuffles no curve."""
        if perms is not None:
            raise ValueError("SpUNet takes no curve permutations")
        n0 = point.num_points
        caps = [pyr.round_up(max(n0 // d, 8), 8)
                for d in self.capacity_div[1:self.num_stages + 1]]
        return pyr.build_pyramid(point, strides=(2,) * self.num_stages, capacities=caps,
                                 orders=self.orders, stem_kernel=5)

    def shuffle_perms(self, generator=None):
        """None: SpUNet has one curve and does not shuffle it."""
        return None

    def forward(self, point: PointBatch, geometry=None, generator=None,
                condition: int = 0, context: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Logits ``(N, num_classes)`` in float32, or in feature mode the
        last decoder block's output. ``geometry`` is a precomputed
        `precompute_geometry`; ``generator`` is unused (SpUNet draws
        nothing). ``condition`` and ``context`` go to the PDNorm layers."""
        levels, stem_nbr = (geometry if geometry is not None
                            else self.precompute_geometry(point))
        ca = dict(condition=condition, context=context)
        stages = self.num_stages
        feat = self.stem_conv(point.feat, stem_nbr)
        feat = F.relu(apply_norm(self.stem_bn, feat, levels[0].point.mask, **ca))
        skips = [feat]
        for s in range(stages):
            lvl = levels[s + 1]
            f = getattr(self, f"down{s}_proj")(skips[-1])
            f = pyr.pool_features(f, lvl, reduce="max")
            f = F.relu(apply_norm(getattr(self, f"down{s}_bn"), f, lvl.point.mask, **ca))
            for i in range(self.layers[s]):
                f = getattr(self, f"enc{s}_block{i}")(
                    f, lvl.point.neighbor_idx, lvl.point.mask, **ca)
            skips.append(f)
        f = skips[-1]
        for s in reversed(range(stages)):
            j = stages + (stages - 1 - s)
            lo = levels[s].point
            f = getattr(self, f"up{s}_proj")(f)
            f = pyr.unpool_features(f, levels[s + 1])
            f = torch.cat([f, skips[s].to(f.dtype)], dim=-1)
            f = getattr(self, f"up{s}_fuse")(f)
            f = F.relu(apply_norm(getattr(self, f"up{s}_bn"), f, lo.mask, **ca))
            for i in range(self.layers[j]):
                f = getattr(self, f"dec{s}_block{i}")(f, lo.neighbor_idx, lo.mask, **ca)
        if self.final is None:
            return f
        return self.final(f.float())


# the registered names of the JAX package: MinkUNet shares the topology,
# v1m3 is SpUNet with PDNorm (``num_conditions``/``pdnorm_adaptive`` from
# the config, ``condition``/``context`` at call time)
VARIANTS = ("SpUNet-v1m1", "MinkUNet", "SpUNet-v1m3")
