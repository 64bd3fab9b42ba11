"""Segmentor wrappers: plain PTv3 and the CNF (CDSegNet) diffusion wrapper.

Port of `cdsegnet_tpu/models/segmentor.py`, inference only. SSI (single-step
inference) feeds the c-branch N(0, 1) noise at t = T-1, runs one forward
pass and reads the n-branch logits; the c-decoder is skipped because SSI
never reads its output.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from cdsegnet_torch.models.diffusion import DiffusionSchedule, calc_t_emb
from cdsegnet_torch.models.structure import PointBatch


def _seg_valid(point: PointBatch) -> torch.Tensor:
    if point.segment is None:
        return point.mask
    return point.mask & (point.segment >= 0)


class PlainSegmentor(nn.Module):
    """Single-branch PTv3 segmentor (reference `DefaultSegmentor`)."""

    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.backbone = backbone

    @torch.no_grad()
    def forward(self, point: PointBatch, geometry=None) -> Dict[str, Any]:
        return dict(n_pred=self.backbone(point, geometry=geometry),
                    n_target=point.segment, seg_valid=_seg_valid(point))


class CNFSegmentor(nn.Module):
    """CNF/CDSegNet segmentor (reference `DefaultSegmentorV2`)."""

    def __init__(self, backbone: nn.Module, num_classes: int = 20, T: int = 1000,
                 beta_start: float = 0.0, beta_end: float = 1000.0,
                 noise_schedule: str = "cosine", t_dim: int = 128,
                 dm: bool = True, dm_input: str = "xt", dm_target: str = "noise",
                 dm_min_snr: Optional[float] = None, condition: bool = True,
                 c_in_channels: int = 6):
        super().__init__()
        self.backbone = backbone
        self.num_classes = num_classes
        self.T = T
        self.t_dim = t_dim
        self.dm = dm
        self.dm_input = dm_input
        self.dm_target = dm_target
        self.condition = condition
        self.c_in_channels = c_in_channels
        self.schedule = (DiffusionSchedule.create(noise_schedule, beta_start,
                                                  beta_end, T, dm_min_snr)
                         if dm else None)

    def _c_x0(self, point: PointBatch) -> torch.Tensor:
        # features when the channel count matches, else coordinates
        if point.feat.shape[-1] == self.c_in_channels:
            return point.feat
        return point.coord

    def _scene_t_emb(self, ts_scene: torch.Tensor, batch: torch.Tensor):
        """Broadcast per-scene step embeddings to points (pads clipped)."""
        emb = calc_t_emb(ts_scene, self.t_dim)
        return emb[batch.clamp(0, ts_scene.shape[0] - 1)]

    @torch.no_grad()
    def inference(self, point: PointBatch, noise: Optional[torch.Tensor] = None,
                  geometry=None,
                  generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """SSI. ``noise`` (N, C) injects the c-branch input; without it the
        noise is drawn from ``generator``. ``geometry`` optionally supplies
        the precomputed pyramid (`PointTransformerV3.precompute_geometry`)."""
        seg_valid = _seg_valid(point)
        if not self.condition:
            return dict(seg_logits=self.backbone(point, geometry=geometry),
                        seg_valid=seg_valid)
        c_x0 = self._c_x0(point)
        t = 0
        c_feat = c_x0
        if self.dm and self.dm_input == "xt":
            if noise is None:
                noise = torch.randn(c_x0.shape, generator=generator,
                                    dtype=torch.float32, device=c_x0.device)
            c_feat = noise
            t = self.T - 1
        ts_scene = torch.full((point.num_scenes,), t, dtype=torch.int32,
                              device=c_x0.device)
        t_emb = (self._scene_t_emb(ts_scene, point.batch)
                 if self.t_dim != -1 else None)
        _, n_logits = self.backbone(point, c_feat, t_emb=t_emb,
                                    geometry=geometry, return_c=False)
        return dict(seg_logits=n_logits, seg_valid=seg_valid)
