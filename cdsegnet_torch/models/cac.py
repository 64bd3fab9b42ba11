"""Context-Aware Classifier segmentor (``CAC-v1m1``).

Port of `cdsegnet_tpu/models/cac.py` (reference
`pointcept/models/context_aware_classifier/context_aware_classifier_v1m1_base.py`),
with the flax parameter names. The linear seg head's weight columns act as
class prototypes; two refinement paths re-classify features by cosine
similarity against contextualized prototypes:

- ``post_refine``: per-scene soft prototypes (softmax-weighted feature
  means per class, a loop over the bucket's scenes) concatenated with the
  global prototypes and projected; gives ``n_pred``;
- ``adaptive_perspective``: ground-truth class means over the batch (a
  one-hot matmul), the detached head prototypes for absent classes; gives
  ``cac_pred``, in training only.

The model returns the logit sets (``n_pred`` refined, ``pre_pred`` the raw
head, ``cac_pred``) and the config's criteria weigh them: three
``CrossEntropyLoss`` entries with ``pred=`` and a ``CACDistillLoss``.
``seg_head_kernel`` is a raw ``(c, num_classes)`` parameter used as ``feat
@ w``, as in JAX (not a Dense: the bridge does not transpose it).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from cdsegnet_torch.models.modules import Dense, MaskedBatchNorm
from cdsegnet_torch.models.segmentor import _seg_valid
from cdsegnet_torch.models.structure import PointBatch


def _cosine(x: torch.Tensor, proto: torch.Tensor) -> torch.Tensor:
    """Cosine-similarity logits ``(n, cls)`` (reference ``get_pred``)."""
    x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
    proto = proto / (torch.linalg.vector_norm(proto, dim=-1, keepdim=True) + 1e-12)
    return x @ proto.t()


class CACSegmentor(nn.Module):
    def __init__(self, backbone: nn.Module, num_classes: int = 20,
                 backbone_out_channels: int = 96, cos_temp: float = 15.0,
                 conf_thresh: float = 0.0, detach_pre_logits: bool = False):
        super().__init__()
        c = backbone_out_channels
        self.backbone = backbone
        self.num_classes = num_classes
        self.cos_temp = cos_temp
        self.conf_thresh = conf_thresh
        self.detach_pre_logits = detach_pre_logits
        self.seg_head_kernel = nn.Parameter(torch.empty(c, num_classes))
        self.seg_head_bias = nn.Parameter(torch.zeros(num_classes))
        # the two projection MLPs: Dense(2c, no bias), relu, Dense(c)
        self.proj_0 = Dense(2 * c, 2 * c, bias=False)
        self.proj_1 = Dense(2 * c, c)
        self.apd_proj_0 = Dense(2 * c, 2 * c, bias=False)
        self.apd_proj_1 = Dense(2 * c, c)
        # feat_proj_layer: Dense(no bias), BN, relu, Dense
        self.feat_proj_0 = Dense(c, c, bias=False)
        self.feat_proj_bn = MaskedBatchNorm(c)
        self.feat_proj_1 = Dense(c, c)

    def _proj(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"{prefix}_1")(F.relu(getattr(self, f"{prefix}_0")(x)))

    def forward(self, point: PointBatch, geometry=None,
                generators=None) -> Dict[str, Any]:
        """The logit sets and targets that `Criteria` reads, plus
        ``pyramid_dropped``. ``geometry`` supplies the backbone's pyramid."""
        bb = self.backbone
        gens = generators or {}
        if geometry is None:
            geometry = bb.precompute_geometry(point)
        feat = bb(point, geometry=geometry, generator=gens.get("dropout")).float()
        w, b = self.seg_head_kernel, self.seg_head_bias
        logits = feat @ w + b
        proto = w.t()  # (cls, c): the head weights are the class prototypes

        fx = self.feat_proj_1(F.relu(self.feat_proj_bn(self.feat_proj_0(feat), point.mask)))

        # post_refine: per-scene softmax-weighted prototypes
        p = logits.detach() if self.detach_pre_logits else logits
        p = torch.softmax(p, dim=-1) * point.mask[:, None]
        if self.conf_thresh > 0:
            p = p * (p.max(-1, keepdim=True).values >= self.conf_thresh)
        refine = torch.zeros_like(logits)
        for s in range(point.num_scenes):
            in_s = (point.batch == s)[:, None]
            ws = p * in_s  # (n, cls)
            denom = ws.sum(0)[:, None]  # (cls, 1)
            proto_s = (ws.t() @ feat) / (denom + 1e-7)
            proto_s = self._proj("proj", torch.cat([proto_s, proto], dim=-1))
            refine = torch.where(in_s, _cosine(fx, proto_s), refine)
        seg_valid = _seg_valid(point)
        out: Dict[str, Any] = dict(
            n_pred=refine * self.cos_temp, pre_pred=logits, n_target=point.segment,
            seg_valid=seg_valid,
            pyramid_dropped=[int(lv.dropped) for lv in geometry[0][1:]])

        # adaptive perspective: ground-truth class means (training only)
        if self.training:
            oh = F.one_hot(point.segment.long().clamp(0, self.num_classes - 1),
                           self.num_classes).float() * seg_valid.float()[:, None]
            cnt = oh.sum(0)  # (cls,)
            gt_proto = (oh.t() @ feat) / (cnt[:, None] + 1e-4)
            new_proto = torch.where((cnt > 0)[:, None], gt_proto, proto.detach())
            new_proto = self._proj("apd_proj", torch.cat([new_proto, proto], dim=-1))
            out["cac_pred"] = _cosine(fx, new_proto) * self.cos_temp
        return out
