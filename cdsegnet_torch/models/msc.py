"""MaskedSceneContrast (MSC): self-supervised cross-view pretraining.

Port of `cdsegnet_tpu/models/msc.py` (reference
`pointcept/models/masked_scene_contrast/masked_scene_contrast_v1m1_base.py`),
registered as ``MSC`` and ``MSC-v1m1``. Two augmented views of a scene get
complementary grid-patch masks; the masked points' features are replaced by
a learned ``mask_token``; the backbone embeds both views; an InfoNCE loss
pulls matched cross-view point pairs together, plus the masked colour and
normal reconstruction through ``color_head`` and ``normal_head``.

The JAX package's static-shape design, kept here:

- cross masks: every ``mask_grid_size`` cell of the origin coordinates is
  hashed (`cell_uniform`, a uint32 splitmix-style hash of the cell, the
  scene id and the step's ``seed``) to a uniform in [0, 1); ``u <
  mask_rate`` masks view 1, ``rate <= u < 2 rate`` view 2;
- pair matching (`MaskedSceneContrast.match_pairs`): the 1-NN of each
  view-1 point among all view-2 points of the bucket by origin coordinates
  (`ops.pointops.knn` without scene ids, as JAX calls it), kept within
  ``matching_max_radius`` and within its scene, then the top
  ``matching_max_pair`` of random ``score``s, ties to the lower row;
- InfoNCE over the static pair table, invalid rows and columns masked.

The step's two draws, the hash ``seed`` and the pair ``score``s, come from
the ``"diffusion"`` generator; tests inject them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from cdsegnet_torch.models.modules import Dense
from cdsegnet_torch.models.structure import PointBatch
from cdsegnet_torch.ops.pointops import knn

_MASK32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2^32`` of uint32 values held in int64, without
    overflowing int64: the product split at 16 bits."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def cell_uniform(grid_cell: torch.Tensor, batch: torch.Tensor,
                 seed: torch.Tensor) -> torch.Tensor:
    """A uniform in [0, 1) per (cell, scene, seed), float32: JAX's
    `_cell_uniform` bit for bit. uint32 arithmetic in int64 (a negative
    cell wraps as two's complement, as ``astype(uint32)`` does), then the
    nearest float32 over 2^32."""
    u32 = lambda x: x.long() & _MASK32
    h = (_mul32(u32(grid_cell[:, 0]), 0x9E3779B1)
         ^ _mul32(u32(grid_cell[:, 1]), 0x85EBCA77)
         ^ _mul32(u32(grid_cell[:, 2]), 0xC2B2AE3D)
         ^ _mul32(u32(batch), 0x27D4EB2F)
         ^ u32(torch.as_tensor(seed, device=batch.device)))
    h = h ^ (h >> 15)
    h = _mul32(h, 0x2C1B3C6D)
    h = h ^ (h >> 12)
    h = _mul32(h, 0x297A2D39)
    h = h ^ (h >> 15)
    return h.to(torch.float32) / np.float32(2 ** 32)


class MaskedSceneContrast(nn.Module):
    def __init__(self, backbone: nn.Module, backbone_in_channels: int = 6,
                 backbone_out_channels: int = 96, mask_grid_size: float = 0.1,
                 mask_rate: float = 0.4, matching_max_radius: float = 0.03,
                 matching_max_pair: int = 8192, nce_t: float = 0.4,
                 contrast_weight: float = 1.0, reconstruct_weight: float = 1.0,
                 reconstruct_color: bool = True, reconstruct_normal: bool = True):
        super().__init__()
        if mask_rate > 0.5:
            raise ValueError(f"mask_rate={mask_rate}: at most 0.5 (complementary masks)")
        self.backbone = backbone
        self.mask_grid_size = mask_grid_size
        self.mask_rate = mask_rate
        self.matching_max_radius = matching_max_radius
        self.matching_max_pair = matching_max_pair
        self.nce_t = nce_t
        self.contrast_weight = contrast_weight
        self.reconstruct_weight = reconstruct_weight
        self.reconstruct_color = reconstruct_color
        self.reconstruct_normal = reconstruct_normal
        self.mask_token = nn.Parameter(torch.zeros(1, backbone_in_channels))
        self.color_head = Dense(backbone_out_channels, 3) if reconstruct_color else None
        self.normal_head = Dense(backbone_out_channels, 3) if reconstruct_normal else None

    def cross_masks(self, v1: PointBatch, v2: PointBatch, v1_origin: torch.Tensor,
                    v2_origin: torch.Tensor, seed) -> tuple:
        """``(m1, m2)``: the complementary masks of the two views' valid
        points."""
        # XLA divides by a constant as a product with its float32
        # reciprocal; so does the port, or a point on a cell boundary flips
        inv = float(np.float32(1.0) / np.float32(self.mask_grid_size))

        def u_of(pt, origin):
            cell = torch.floor(origin.float() * inv).to(torch.int32)
            return cell_uniform(cell, pt.batch, seed)

        u1, u2 = u_of(v1, v1_origin), u_of(v2, v2_origin)
        rate = np.float32(self.mask_rate)
        m1 = (u1 < rate) & v1.mask
        m2 = (u2 >= rate) & (u2 < np.float32(2 * self.mask_rate)) & v2.mask
        return m1, m2

    def match_pairs(self, v1: PointBatch, v2: PointBatch, v1_origin: torch.Tensor,
                    v2_origin: torch.Tensor, score: torch.Tensor) -> tuple:
        """``(pairs (P, 2) int64, valid (P,) bool)``: view-1 rows and their
        view-2 nearest neighbours, the ``P = min(matching_max_pair, N1)``
        valid matches of highest ``score`` ((N1,) uniforms) first."""
        idx, d2 = knn(v1_origin, v2_origin, 1, v1.mask, v2.mask)
        n2 = v2.num_points
        r2 = torch.tensor(self.matching_max_radius ** 2, dtype=torch.float32)
        valid = (d2[:, 0] < r2.to(d2.device)) & v1.mask & (idx[:, 0] < n2)
        # same-scene guard: the 1-NN may cross scenes in a packed bucket
        j = idx[:, 0].clamp(0, n2 - 1)
        valid = valid & (v1.batch == v2.batch[j])
        s = torch.where(valid, score.float(), torch.full_like(score, -1.0, dtype=torch.float32))
        p = min(self.matching_max_pair, v1.num_points)
        # lax.top_k: descending, equal scores (every invalid row) by lower index
        top, rows = torch.sort(s, descending=True, stable=True)
        top, rows = top[:p], rows[:p]
        pairs = torch.stack([rows, j[rows]], dim=1)
        return pairs, top >= 0.0

    def info_nce(self, f1: torch.Tensor, f2: torch.Tensor, pairs: torch.Tensor,
                 pair_valid: torch.Tensor) -> tuple:
        """``(loss, pos_sim, neg_sim)`` over the pair table."""
        # index_select: its backward adds repeated rows without serial runs
        a = f1.index_select(0, pairs[:, 0])
        b = f2.index_select(0, pairs[:, 1])
        a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-7)
        b = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-7)
        sim = (a @ b.T).float()
        p = sim.shape[0]
        eye = torch.eye(p, dtype=torch.bool, device=sim.device)
        col_ok = pair_valid[None, :] | eye
        logits = torch.where(col_ok, sim / self.nce_t,
                             torch.full((), float("-inf"), device=sim.device))
        nll = -torch.diagonal(torch.log_softmax(logits, dim=-1))
        v = pair_valid.float()
        n = torch.clamp(v.sum(), min=1.0)
        loss = (nll * v).sum() / n
        pos = (torch.diagonal(sim) * v).sum() / n
        neg = (sim * v[:, None] * v[None, :] * (~eye).float()).sum() / torch.clamp(
            v.sum() ** 2 - v.sum(), min=1.0)
        return loss, pos, neg

    def forward(self, view1: PointBatch, view2: PointBatch,
                view1_origin_coord: torch.Tensor, view2_origin_coord: torch.Tensor,
                view1_target: Optional[Dict[str, torch.Tensor]] = None,
                view2_target: Optional[Dict[str, torch.Tensor]] = None,
                generators: Optional[Dict[str, torch.Generator]] = None,
                seed: Optional[torch.Tensor] = None,
                score: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """The losses of one view pair (``loss``, which `Criteria` passes
        through, ``nce_loss``, ``pos_sim``, ``neg_sim``, ``color_loss``,
        ``normal_loss``) and the two masks. ``seed`` (a 0-d int in [0,
        2^31 - 1)) and ``score`` ((N1,) uniforms) replace the draws from
        ``generators["diffusion"]``."""
        gen = (generators or {}).get("diffusion")
        dev = view1.feat.device
        if seed is None:
            seed = torch.randint(0, 2 ** 31 - 1, (), generator=gen, device=dev)
        if score is None:
            score = torch.rand(view1.num_points, generator=gen, device=dev)
        m1, m2 = self.cross_masks(view1, view2, view1_origin_coord, view2_origin_coord,
                                  seed)
        f1 = torch.where(m1[:, None], self.mask_token.to(view1.feat.dtype), view1.feat)
        f2 = torch.where(m2[:, None], self.mask_token.to(view2.feat.dtype), view2.feat)
        out1 = self.backbone(view1.replace(feat=f1))
        out2 = self.backbone(view2.replace(feat=f2))

        pairs, pair_valid = self.match_pairs(view1, view2, view1_origin_coord,
                                             view2_origin_coord, score)
        nce, pos, neg = self.info_nce(out1, out2, pairs, pair_valid)
        loss = nce * self.contrast_weight
        result: Dict[str, Any] = dict(nce_loss=nce, pos_sim=pos, neg_sim=neg)

        def masked_mse(pred, target, m):
            err = (pred.float() - target.float()).square().sum(-1)
            return (err * m).sum() / torch.clamp(m.sum(), min=1.0)

        if self.color_head is not None and view1_target and "color" in view1_target:
            closs = 0.5 * (masked_mse(self.color_head(out1.float()), view1_target["color"],
                                      m1.float())
                           + masked_mse(self.color_head(out2.float()),
                                        view2_target["color"], m2.float()))
            loss = loss + closs * self.reconstruct_weight
            result["color_loss"] = closs
        if self.normal_head is not None and view1_target and "normal" in view1_target:
            def nrm(x):
                x = self.normal_head(x.float())
                return x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-10)

            nloss = 0.5 * (masked_mse(nrm(out1), view1_target["normal"], m1.float())
                           + masked_mse(nrm(out2), view2_target["normal"], m2.float()))
            loss = loss + nloss * self.reconstruct_weight
            result["normal_loss"] = nloss
        result.update(loss=loss, view1_mask=m1, view2_mask=m2)
        return result
