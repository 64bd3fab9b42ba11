"""Segmentor wrappers: plain PTv3 and the CNF (CDSegNet) diffusion wrapper.

Port of `cdsegnet_tpu/models/segmentor.py`: the training forward, SSI and
the DDIM modes. SSI (single-step inference) feeds the c-branch N(0, 1)
noise at t = T-1, runs one forward pass and reads the n-branch logits; the
c-decoder is skipped because SSI never reads its output. MSAI and MSFI
(`inference_ddim`) run `CNFSegmentor.denoise_step` over the DDIM time
schedule from the same kind of initial state, the c-decoder included, and
average the n-branch logits of every step (MSAI) or keep the last (MSFI).
The training forward
(`CNFSegmentor.forward`) draws one timestep per scene, noises the c-branch
input with `DiffusionSchedule.q_sample` and returns the predictions and
targets that `models.losses.Criteria` reads.

Randomness comes from explicit generators, a dict with the keys of the JAX
rngs: ``"dropout"`` (stochastic depth) and ``"diffusion"`` (MSE subsampling,
timesteps, noise) on the data's device, and ``"shuffle"`` (curve order
permutations) on the CPU. Tests inject the draws instead (``ts_scene``,
``noise``, ``mse_valid``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from cdsegnet_torch.models.diffusion import DiffusionSchedule, calc_t_emb, time_schedule
from cdsegnet_torch.models.losses import subsample_valid
from cdsegnet_torch.models.structure import PointBatch

Generators = Optional[Dict[str, torch.Generator]]


def _seg_valid(point: PointBatch) -> torch.Tensor:
    if point.segment is None:
        return point.mask
    return point.mask & (point.segment >= 0)


class PlainSegmentor(nn.Module):
    """Single-branch PTv3 segmentor (reference `DefaultSegmentor`)."""

    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.backbone = backbone

    def forward(self, point: PointBatch, geometry=None,
                generators: Generators = None,
                perms: Optional[list] = None) -> Dict[str, Any]:
        """The forward of training and evaluation. ``geometry`` supplies the
        pyramid; otherwise it is built here, its curves shuffled in training
        by ``perms`` (one permutation per level) or from the ``"shuffle"``
        generator. Returns the logits and targets that `Criteria` reads,
        plus ``pyramid_dropped``: the number of valid points each pooled
        level lost to overflow."""
        gens = generators or {}
        bb = self.backbone
        if geometry is None:
            geometry = bb.precompute_geometry(
                point, perms=perms if perms is not None
                else bb.shuffle_perms(gens.get("shuffle")))
        return dict(n_pred=bb(point, geometry=geometry, generator=gens.get("dropout")),
                    n_target=point.segment, seg_valid=_seg_valid(point),
                    pyramid_dropped=[int(lv.dropped) for lv in geometry[0][1:]])


class CNFSegmentor(nn.Module):
    """CNF/CDSegNet segmentor (reference `DefaultSegmentorV2`)."""

    def __init__(self, backbone: nn.Module, num_classes: int = 20, T: int = 1000,
                 beta_start: float = 0.0, beta_end: float = 1000.0,
                 noise_schedule: str = "cosine", t_dim: int = 128,
                 dm: bool = True, dm_input: str = "xt", dm_target: str = "noise",
                 dm_min_snr: Optional[float] = None, condition: bool = True,
                 c_in_channels: int = 6, batch_sample_point: int = 8192):
        super().__init__()
        self.backbone = backbone
        self.num_classes = num_classes
        self.T = T
        self.t_dim = t_dim
        self.dm = dm
        self.dm_input = dm_input
        self.dm_target = dm_target
        self.condition = condition
        self.dm_min_snr = dm_min_snr
        self.c_in_channels = c_in_channels
        # per-scene random MSE subsampling; <= 0 disables
        self.batch_sample_point = batch_sample_point
        self.schedule = (DiffusionSchedule.create(noise_schedule, beta_start,
                                                  beta_end, T, dm_min_snr)
                         if dm else None)

    def _c_from_feat(self, feat_dim: int) -> bool:
        """Whether the c-branch's clean input is the features (their channel
        count matches ``c_in_channels``) or else the coordinates."""
        return feat_dim == self.c_in_channels

    def _c_x0(self, point: PointBatch) -> torch.Tensor:
        return point.feat if self._c_from_feat(point.feat.shape[-1]) else point.coord

    def _scene_t_emb(self, ts_scene: torch.Tensor, batch: torch.Tensor):
        """Broadcast per-scene step embeddings to points (pads clipped)."""
        emb = calc_t_emb(ts_scene, self.t_dim)
        return emb[batch.clamp(0, ts_scene.shape[0] - 1)]

    def forward(self, point: PointBatch, generators: Generators = None,
                ts_scene: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                mse_valid: Optional[torch.Tensor] = None,
                perms: Optional[list] = None) -> Dict[str, Any]:
        """The training forward (``model.train()``; in eval mode the norms
        use running statistics and the MSE mask is not drawn).

        ``ts_scene`` (num_scenes,) int, ``noise`` (N, C), ``mse_valid`` (N,)
        bool and ``perms`` (one curve permutation per pyramid level) replace
        the draws from ``generators``. Returns the dict
        that `Criteria` reads, plus ``pyramid_dropped``: the number of valid
        points each pooled level lost to overflow.
        """
        gens = generators or {}
        train = self.training
        bb = self.backbone
        levels, stem_nbr = bb.precompute_geometry(
            point, perms=perms if perms is not None
            else bb.shuffle_perms(gens.get("shuffle")))
        out: Dict[str, Any] = dict(
            pyramid_dropped=[int(lv.dropped) for lv in levels[1:]])
        seg_valid = _seg_valid(point)
        if not self.condition:
            out.update(n_pred=bb(point, geometry=(levels, stem_nbr),
                                 generator=gens.get("dropout")),
                       n_target=point.segment, seg_valid=seg_valid)
            return out

        c_x0 = self._c_x0(point)
        c_target = c_x0
        c_feat = c_x0
        t_emb = None
        if train and self.batch_sample_point > 0:
            out["mse_valid"] = (mse_valid if mse_valid is not None else subsample_valid(
                seg_valid, point.batch, point.num_scenes, self.batch_sample_point,
                gens.get("diffusion")))
        if self.dm:
            dev = c_x0.device
            if ts_scene is None:
                ts_scene = torch.randint(0, self.T, (point.num_scenes,),
                                         generator=gens.get("diffusion"), device=dev)
            ts_scene = ts_scene.to(device=dev, dtype=torch.int32)
            ts_pt = ts_scene[point.batch.long().clamp(0, point.num_scenes - 1)]
            if self.t_dim != -1:
                t_emb = self._scene_t_emb(ts_scene, point.batch)
            if noise is None:
                noise = torch.randn(c_x0.shape, generator=gens.get("diffusion"),
                                    dtype=torch.float32, device=dev)
            c_feat = self.schedule.q_sample(c_x0, ts_pt, noise)
            if self.dm_target == "noise":
                c_target = noise
            if self.dm_min_snr is not None:
                out["snr_loss_weight"] = torch.as_tensor(
                    self.schedule.snr, device=dev)[ts_pt.long()]

        c_out, n_logits = bb(point, c_feat, t_emb=t_emb, geometry=(levels, stem_nbr),
                             generator=gens.get("dropout"))
        out.update(c_pred=c_out, c_target=c_target, n_pred=n_logits,
                   n_target=point.segment, seg_valid=seg_valid)
        return out

    def _ssi_from_noise(self) -> bool:
        return self.condition and self.dm and self.dm_input == "xt"

    def draw_ssi_noise(self, num_points: int, feat_dim: int,
                       generator: Optional[torch.Generator] = None,
                       device=None) -> Optional[torch.Tensor]:
        """The c-branch noise that SSI starts from, for a bucket of
        ``num_points`` slots with ``feat_dim`` feature channels: N(0, 1) of
        `_c_x0`'s shape from ``generator`` on ``device``, or None (nothing
        drawn) when SSI feeds no noise. `inference` draws through it, and so
        does the evaluator for the scenes another rank forwards."""
        if not self._ssi_from_noise():
            return None
        shape = (num_points, feat_dim if self._c_from_feat(feat_dim) else 3)
        return torch.randn(shape, generator=generator, dtype=torch.float32, device=device)

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
        if self._ssi_from_noise():
            c_feat = noise if noise is not None else self.draw_ssi_noise(
                *point.feat.shape, generator=generator, device=c_x0.device)
            t = self.T - 1
        ts_scene = torch.full((point.num_scenes,), t, dtype=torch.int32,
                              device=c_x0.device)
        t_emb = (self._scene_t_emb(ts_scene, point.batch)
                 if self.t_dim != -1 else None)
        _, n_logits = self.backbone(point, c_feat, t_emb=t_emb,
                                    geometry=geometry, return_c=False)
        return dict(seg_logits=n_logits, seg_valid=seg_valid)

    @torch.no_grad()
    def denoise_step(self, point: PointBatch, c_feat: torch.Tensor, t: int,
                     geometry=None) -> Dict[str, torch.Tensor]:
        """One DDIM step at the integer step ``t`` (the same for every
        scene): the backbone's c-branch noise prediction and n-branch logits,
        c-decoder included, and the next c state. Returns ``dict(c_next,
        n_logits)``. Runs the model in its current mode: eval for inference."""
        if not (self.dm and self.condition):
            raise ValueError("denoise_step needs the diffusion (dm=True) and the "
                             "dual-branch backbone (condition=True)")
        dev = c_feat.device
        ts_scene = torch.full((point.num_scenes,), t, dtype=torch.int32, device=dev)
        t_emb = (self._scene_t_emb(ts_scene, point.batch)
                 if self.t_dim != -1 else None)
        c_out, n_logits = self.backbone(point, c_feat, t_emb=t_emb, geometry=geometry)
        ts_pt = torch.full((point.num_points,), t, dtype=torch.int32, device=dev)
        c_next = self.schedule.ddim_step(c_feat, ts_pt, c_out, target=self.dm_target)
        return dict(c_next=c_next, n_logits=n_logits)


@torch.no_grad()
def inference_ddim(model: CNFSegmentor, point: PointBatch, step: int = 5,
                   mode: str = "avg", noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   geometry=None) -> torch.Tensor:
    """MSAI (``mode="avg"``) or MSFI (``"final"``): DDIM denoise steps over
    ``time_schedule(model.T, step)``, the n-branch logits ``(N, K)`` averaged
    over the ``step + 1`` forwards (the t = -1 slot runs as t = 0 and counts)
    or those of the last. ``noise`` ``(N, c_in_channels)`` is the initial c
    state; without it the state is drawn from ``generator``. The geometry
    pyramid is built once (or taken from ``geometry``) and shared by every
    step."""
    if mode not in ("avg", "final"):
        raise ValueError(f"mode={mode!r}: 'avg' (MSAI) or 'final' (MSFI)")
    sched = time_schedule(model.T, step)
    c_feat = noise
    if c_feat is None:
        c_feat = torch.randn((point.num_points, model.c_in_channels),
                             generator=generator, dtype=torch.float32,
                             device=point.coord.device)
    if geometry is None:
        geometry = model.backbone.precompute_geometry(point)
    n_pred = None
    for t in sched:
        res = model.denoise_step(point, c_feat, max(int(t), 0), geometry)
        if mode == "avg" and n_pred is not None:
            n_pred = n_pred + res["n_logits"]
        else:
            n_pred = res["n_logits"]
        c_feat = res["c_next"]
        if t <= 0:
            break
    if mode == "avg":
        n_pred = n_pred / float(len(sched))
    return n_pred
