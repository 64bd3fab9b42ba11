"""PointGroup instance segmentation.

Port of `cdsegnet_tpu/models/pointgroup.py` (reference
`pointcept/models/point_group/` and its ``pointgroup_ops`` extension), with
the flax parameter names. The segmentor head gives semantic logits and
per-point centre offsets; `PointGroup.cluster` shifts the coordinates by
the offsets and clusters the points of instance classes into connected
components of the ball-query graph.

`connected_components` is min-label propagation with pointer jumping over
the ball-query neighbours (`ops.pointops.ball_query`): every point starts
as its own label, each round takes the minimum over its neighbours and then
the label of that label. It runs ``n.bit_length()`` rounds, as JAX's
``fori_loop`` does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cdsegnet_torch.models.modules import Dense
from cdsegnet_torch.models.segmentor import _seg_valid
from cdsegnet_torch.models.structure import PointBatch
from cdsegnet_torch.ops.pointops import ball_query


def connected_components(coord: torch.Tensor, valid: torch.Tensor, radius: float = 0.03,
                         nsample: int = 16, num_iters: Optional[int] = None
                         ) -> torch.Tensor:
    """Cluster ids (int64): the minimum point index of each component of
    the ball-query graph; invalid points get id N."""
    n = coord.shape[0]
    idx, _ = ball_query(coord, coord, radius, nsample, valid, valid)
    idx = torch.where(valid[:, None], idx.long(), n)
    iota = torch.arange(n, dtype=torch.int64, device=coord.device)
    labels = torch.where(valid, iota, n)
    fill = torch.full((1,), n, dtype=torch.int64, device=coord.device)
    for _ in range(num_iters or max(n.bit_length(), 1)):
        # min label over the neighbours (index n reads n: the own label wins)
        neigh = torch.cat([labels, fill])[idx]
        lab2 = torch.minimum(labels, neigh.min(1).values)
        # pointer jumping: adopt the label of your label
        lab3 = lab2[lab2.clamp(0, n - 1)]
        labels = torch.where(valid, torch.minimum(lab2, lab3), n)
    return labels


class PointGroup(nn.Module):
    """Instance segmentor: backbone, semantic logits and centre offsets;
    `cluster` makes the proposals."""

    def __init__(self, backbone: nn.Module, num_classes: int = 20,
                 backbone_out_channels: int = 64,
                 instance_ignore: Sequence[int] = (0, 1), cluster_radius: float = 0.03,
                 cluster_nsample: int = 16):
        super().__init__()
        c = backbone_out_channels
        self.backbone = backbone
        self.num_classes = num_classes
        self.instance_ignore = tuple(instance_ignore)  # wall/floor: no instances
        self.cluster_radius = cluster_radius
        self.cluster_nsample = cluster_nsample
        self.seg_head = Dense(c, num_classes)
        self.offset_fc = Dense(c, c)
        self.offset_head = Dense(c, 3)

    def forward(self, point: PointBatch, geometry=None,
                generators=None) -> Dict[str, Any]:
        """Semantic logits ``n_pred``, offsets ``offset_pred`` and the
        targets; ``offset_target`` and ``instance_valid`` when the batch
        has instances. Plus ``pyramid_dropped``."""
        bb = self.backbone
        gens = generators or {}
        if geometry is None:
            geometry = bb.precompute_geometry(point)
        feat = bb(point, geometry=geometry, generator=gens.get("dropout")).float()
        out: Dict[str, Any] = dict(
            n_pred=self.seg_head(feat),
            offset_pred=self.offset_head(F.gelu(self.offset_fc(feat), approximate="none")),
            n_target=point.segment, seg_valid=_seg_valid(point),
            pyramid_dropped=[int(lv.dropped) for lv in geometry[0][1:]])
        if point.instance is not None and point.instance_centroid is not None:
            # offset regression targets: to the instance centroid, on the
            # points that belong to an instance
            out["offset_target"] = point.instance_centroid - point.coord
            out["instance_valid"] = point.mask & (point.instance >= 0)
        return out

    @torch.no_grad()
    def cluster(self, point: PointBatch, sem_pred: torch.Tensor,
                offset_pred: torch.Tensor) -> torch.Tensor:
        """Proposals: per-class connected components of the shifted
        coordinates (ids from `connected_components`)."""
        shifted = point.coord + offset_pred
        ignore = torch.zeros_like(sem_pred, dtype=torch.bool)
        for c in self.instance_ignore:
            ignore = ignore | (sem_pred == c)
        valid = point.mask & ~ignore
        # separate classes by an x offset, so that different classes never
        # connect
        on = torch.where(point.mask[:, None], shifted, torch.zeros_like(shifted))
        span = on.max() - on.min() + 10.0
        keyed = shifted.clone()
        keyed[:, 0] += sem_pred.float() * span
        return connected_components(keyed, valid, self.cluster_radius, self.cluster_nsample)
