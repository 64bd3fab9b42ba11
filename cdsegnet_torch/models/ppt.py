"""Point Prompt Training (PPT): one model trained jointly on several datasets.

Port of `cdsegnet_tpu/models/ppt.py` (reference
`pointcept/models/point_prompt_training/`), with the flax parameter names:

- ``PPT-v1m1`` (`PointPromptTraining`): a learned per-dataset context
  (``embedding_table``) fed to a PDNorm backbone, and language-driven
  categorical alignment: point features (through ``proj_head`` when the
  backbone's width is not ``clip_embed_dim``) cosine-matched against class
  text embeddings, each dataset reading its ``valid_index`` rows, scaled by
  the learned ``exp(logit_scale)``. The embeddings are the ``.npy`` at
  ``class_embedding_path`` (frozen) or else a learned ``class_embedding``
  table. CDSegNet's extension (reference kwarg ``condition``, here
  ``dual_branch``): a dual-branch CNF backbone whose c-branch carries the
  features, with ``dm`` noised by q-sampling per scene in training and fed
  N(0, 1) at t = T - 1 in evaluation (``dm_input="xt"``);
- ``PPT-v1m2`` (`PointPromptTrainingDecoupled`): one linear
  ``seg_head{i}`` per dataset.

The dataset ``condition`` is a Python int argument of the forward (JAX
compiles one step per condition); the parameters do not depend on it:
every head and the whole PDNorm table exist whatever the condition is. A
training step gives every parameter a gradient, zero where the condition
leaves it unused (``zero_unused_grads``), as JAX's does, so that the
optimizer updates them as optax does.

Randomness: the ``"diffusion"`` generator draws the timesteps and noise,
``"shuffle"`` the curve permutations, ``"dropout"`` the backbone's masks;
tests inject ``ts_scene``, ``noise`` and ``perms``.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from cdsegnet_torch.models.diffusion import DiffusionSchedule, calc_t_emb
from cdsegnet_torch.models.modules import Dense
from cdsegnet_torch.models.structure import PointBatch

Generators = Optional[Dict[str, torch.Generator]]

# reference defaults (`point_prompt_training_v1m1_language_guided.py:141-153`)
DEFAULT_CLASS_NAMES = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "bookcase", "picture", "counter", "desk",
    "shelves", "curtain", "dresser", "pillow", "mirror", "ceiling",
    "refrigerator", "television", "shower curtain", "nightstand", "toilet",
    "sink", "lamp", "bathtub", "garbagebin", "board", "beam", "column",
    "clutter", "otherstructure", "otherfurniture", "otherprop",
)
DEFAULT_VALID_INDEX = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21, 23,
     25, 26, 33, 34, 35),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 12, 13, 15, 20, 22, 24, 25, 27, 34),
    (0, 1, 4, 5, 6, 7, 8, 10, 19, 29, 30, 31, 32),
)


def _takes_condition(backbone: nn.Module) -> bool:
    return "condition" in inspect.signature(type(backbone).forward).parameters


def _feature_width(backbone: nn.Module, default: int) -> int:
    """The width of the backbone's (n-branch) output: its head's, else the
    last decoder width of a headless SpUNet, else ``default``."""
    for name in ("n_head", "final", "head"):
        head = getattr(backbone, name, None)
        if isinstance(head, nn.Linear):
            return head.out_features
    channels = getattr(backbone, "channels", None)
    if getattr(backbone, "num_classes", None) == 0 and channels:
        return channels[-1]
    return default


def _seg_valid(point: PointBatch) -> torch.Tensor:
    return point.mask & (point.segment >= 0)


class _PromptBase(nn.Module):
    """The learned dataset context and the backbone call shared by both
    versions."""

    zero_unused_grads = True

    def __init__(self, backbone: nn.Module, context_channels: int,
                 conditions: Sequence[str], backbone_mode: bool):
        super().__init__()
        self.backbone = backbone
        self.conditions = tuple(conditions)
        self.backbone_mode = backbone_mode
        self.embedding_table = nn.Parameter(torch.zeros(len(self.conditions),
                                                        context_channels))

    def _geometry(self, point: PointBatch, gens: Dict, perms):
        bb = self.backbone
        return bb.precompute_geometry(
            point, perms=perms if perms is not None else bb.shuffle_perms(gens.get("shuffle")))

    def _backbone(self, point: PointBatch, geometry, gens: Dict, condition: int):
        if not 0 <= condition < len(self.conditions):
            raise ValueError(f"condition {condition} of {len(self.conditions)} conditions")
        if _takes_condition(self.backbone):
            context = self.embedding_table[condition][None, :]
            return self.backbone(point, geometry=geometry, generator=gens.get("dropout"),
                                 condition=condition, context=context)
        return self.backbone(point, geometry=geometry, generator=gens.get("dropout"))


class PointPromptTraining(_PromptBase):
    """PPT-v1m1: language-guided categorical alignment, optionally over a
    dual-branch CNF backbone (``dual_branch``, with ``dm`` diffusion)."""

    def __init__(self, backbone: nn.Module, backbone_out_channels: int = 96,
                 context_channels: int = 256,
                 conditions: Sequence[str] = ("Structured3D", "ScanNet", "S3DIS"),
                 valid_index: Sequence[Sequence[int]] = DEFAULT_VALID_INDEX,
                 num_class_names: int = len(DEFAULT_CLASS_NAMES),
                 clip_embed_dim: int = 512, class_embedding_path: Optional[str] = None,
                 backbone_mode: bool = False, dual_branch: bool = False, dm: bool = False,
                 T: int = 1000, beta_start: float = 0.0001, beta_end: float = 0.02,
                 noise_schedule: str = "linear", t_dim: int = 128, dm_input: str = "xt",
                 dm_target: str = "noise", dm_min_snr: Optional[float] = None,
                 c_in_channels: int = 6):
        super().__init__(backbone, context_channels, conditions, backbone_mode)
        self.valid_index = tuple(tuple(int(i) for i in row) for row in valid_index)
        self.dual_branch = dual_branch
        self.dm = dm
        self.T = T
        self.t_dim = t_dim
        self.dm_input = dm_input
        self.dm_target = dm_target
        self.dm_min_snr = dm_min_snr
        self.c_in_channels = c_in_channels
        self.schedule = (DiffusionSchedule.create(noise_schedule, beta_start, beta_end, T,
                                                  dm_min_snr) if dm else None)
        self.clip_embedding = None  # the frozen .npy table, when given
        self.proj_head = self.class_embedding = self.logit_scale = None
        if backbone_mode:
            return
        width = _feature_width(backbone, backbone_out_channels)
        if width != clip_embed_dim:
            self.proj_head = Dense(width, clip_embed_dim)
        if class_embedding_path is not None:
            emb = np.load(class_embedding_path).astype(np.float32)
            if emb.shape != (num_class_names, clip_embed_dim):
                raise ValueError(f"{class_embedding_path}: shape {emb.shape}, expected "
                                 f"{(num_class_names, clip_embed_dim)}")
            # a plain tensor: frozen, and neither a parameter nor a buffer, as
            # it is not in JAX's variables
            self.clip_embedding = torch.from_numpy(emb)
        else:
            self.class_embedding = nn.Parameter(torch.zeros(num_class_names,
                                                            clip_embed_dim))
        self.logit_scale = nn.Parameter(torch.zeros(()))

    def _c_x0(self, point: PointBatch) -> torch.Tensor:
        return point.coord if self.c_in_channels == 3 else point.feat

    def _eval_noise(self) -> bool:
        return self.dual_branch and self.dm and self.dm_input == "xt"

    def draw_ssi_noise(self, num_points: int, feat_dim: int,
                       generator: Optional[torch.Generator] = None,
                       device=None) -> Optional[torch.Tensor]:
        """The c-branch noise of an evaluation forward of ``num_points``
        slots with ``feat_dim`` feature channels (N(0, 1) from
        ``generator``), or None when it takes none."""
        if not self._eval_noise():
            return None
        shape = (num_points, 3 if self.c_in_channels == 3 else feat_dim)
        return torch.randn(shape, generator=generator, dtype=torch.float32, device=device)

    def forward(self, point: PointBatch, condition: int = 0, geometry=None,
                generators: Generators = None, ts_scene: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None, perms=None) -> Dict[str, Any]:
        """The training forward in training mode, the evaluation forward in
        eval mode: ``n_pred`` (N, len(valid_index[condition])) and the
        targets `Criteria` reads (with the dual branch ``c_pred`` and
        ``c_target``, and ``snr_loss_weight`` under ``dm_min_snr``), plus
        ``pyramid_dropped``. ``ts_scene`` (num_scenes,) and ``noise`` (the
        c-branch input's shape) replace the draws; ``geometry`` supplies
        the pyramid, ``perms`` its curve permutations."""
        gens = generators or {}
        if geometry is None:
            geometry = self._geometry(point, gens, perms)
        out: Dict[str, Any] = dict(pyramid_dropped=[int(lv.dropped) for lv in geometry[0][1:]])
        if self.dual_branch:
            if not 0 <= condition < len(self.conditions):
                raise ValueError(f"condition {condition} of {len(self.conditions)} "
                                 "conditions")
            feat = self._dual_branch(point, geometry, gens, ts_scene, noise, out)
        else:
            feat = self._backbone(point, geometry, gens, condition)
        if self.backbone_mode:
            out["feat"] = feat
            return out
        feat = feat.float()
        if self.proj_head is not None:
            feat = self.proj_head(feat)
        emb = (self.class_embedding if self.clip_embedding is None
               else self.clip_embedding.to(feat.device))
        emb = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-12)
        valid = torch.as_tensor(self.valid_index[condition], device=feat.device)
        feat = feat / (torch.linalg.vector_norm(feat, dim=-1, keepdim=True) + 1e-12)
        out.update(n_pred=(feat @ emb[valid].T) * torch.exp(self.logit_scale),
                   n_target=point.segment, seg_valid=_seg_valid(point))
        return out

    def _dual_branch(self, point, geometry, gens, ts_scene, noise, out):
        """The CNF extension: the c-branch input (q-sampled in training,
        N(0, 1) at T - 1 in evaluation), the backbone's two branches; fills
        ``c_pred``/``c_target`` and returns the n-branch output."""
        c_x0 = self._c_x0(point)
        c_target, feat_t, t_emb = c_x0, c_x0, None
        if self.dm:
            dev = c_x0.device
            gen = gens.get("diffusion")
            scene_of = point.batch.long().clamp(0, point.num_scenes - 1)
            if self.training:
                if ts_scene is None:
                    ts_scene = torch.randint(0, self.T, (point.num_scenes,), generator=gen,
                                             device=dev)
                if noise is None:
                    noise = torch.randn(c_x0.shape, generator=gen, dtype=torch.float32,
                                        device=dev)
                ts_scene = ts_scene.to(device=dev, dtype=torch.int32)
                ts = ts_scene[scene_of]
                feat_t = self.schedule.q_sample(c_x0, ts, noise)
                if self.dm_target == "noise":
                    c_target = noise
                if self.dm_min_snr is not None:
                    out["snr_loss_weight"] = torch.as_tensor(self.schedule.snr,
                                                             device=dev)[ts.long()]
            else:
                ts_scene = torch.full((point.num_scenes,), self.T - 1, dtype=torch.int32,
                                      device=dev)
                if self._eval_noise():
                    feat_t = noise if noise is not None else torch.randn(
                        c_x0.shape, generator=gen, dtype=torch.float32, device=dev)
            if self.t_dim != -1:
                t_emb = calc_t_emb(ts_scene, self.t_dim)[scene_of]
        c_out, n_out = self.backbone(point, feat_t, t_emb=t_emb, geometry=geometry,
                                     generator=gens.get("dropout"))
        out.update(c_pred=c_out, c_target=c_target)
        return n_out


class PointPromptTrainingDecoupled(_PromptBase):
    """PPT-v1m2: one linear segmentation head per dataset."""

    def __init__(self, backbone: nn.Module, backbone_out_channels: int = 96,
                 context_channels: int = 256,
                 conditions: Sequence[str] = ("Structured3D", "ScanNet", "S3DIS"),
                 num_classes: Sequence[int] = (25, 20, 13), backbone_mode: bool = False):
        super().__init__(backbone, context_channels, conditions, backbone_mode)
        self.num_classes = tuple(num_classes)
        if not backbone_mode:
            width = _feature_width(backbone, backbone_out_channels)
            for i, ncls in enumerate(self.num_classes):
                self.add_module(f"seg_head{i}", Dense(width, ncls))

    def forward(self, point: PointBatch, condition: int = 0, geometry=None,
                generators: Generators = None, perms=None) -> Dict[str, Any]:
        """``n_pred`` of the condition's head (the others exist and stay
        unused), the targets and ``pyramid_dropped``."""
        gens = generators or {}
        if geometry is None:
            geometry = self._geometry(point, gens, perms)
        feat = self._backbone(point, geometry, gens, condition)
        out: Dict[str, Any] = dict(pyramid_dropped=[int(lv.dropped) for lv in geometry[0][1:]])
        if self.backbone_mode:
            out["feat"] = feat
            return out
        out.update(n_pred=getattr(self, f"seg_head{condition}")(feat.float()),
                   n_target=point.segment, seg_valid=_seg_valid(point))
        return out
