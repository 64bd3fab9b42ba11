"""NCF ablation segmentors: the paper's framework matrix beyond CNF.

Port of `cdsegnet_tpu/models/ablation_segmentors.py` (reference
`pointcept/models/default.py`):

- ③ `ContinuousDMSegmentor` (CN + GD): Gaussian diffusion on the labels as
  log-one-hot, which ride the c-branch; the clean features ride the
  n-branch and give the segmentation logits;
- ④ `CCDMSegmentor` (GD + GD): features diffused on the c-branch,
  log-one-hot labels diffused on the n-branch;
- ⑤ `DiscreteDMSegmentor` (CN + CD): uniform-transition D3PM on the labels,
  whose noised one-hot rides the c-branch, trained through the posterior KL
  (`losses.d3pm_kl_loss`) and/or CE on ``d3pm_logits``;
- ⑥ `CDDMSegmentor` (GD + CD): Gaussian diffusion on the features (c),
  D3PM on the labels (n);
- `DMSegmentor`: D3PM on one semantic branch (``condition=False``);
- `DefaultClassifier`: shape classification from backbone features pooled
  per scene.

Two deviations of the JAX package from the reference, kept here:

- ③ consumes the timestep embedding: the diffused labels ride the c-branch,
  whose blocks own the ``t_mlp``s (the reference attaches the embedding to
  a branch without them and discards it);
- ④'s label branch steps in log-prob space: its x0 estimate is
  ``log(softmax(n logits) + eps)``, as the n head predicts logits, not
  noise.

Randomness comes from the generators of `models.segmentor` (``"diffusion"``
for the timesteps, Gaussian noises, D3PM keep masks and uniform labels and
the Gumbel uniforms; ``"dropout"``; ``"shuffle"`` for the curves). Each
forward, `inference` and `denoise_step` also takes its draws as arguments
(tests inject JAX's). SSI (`inference`) skips the c-decoder, as
`CNFSegmentor.inference` does; `denoise_step` runs it. `inference_multistep`
runs MSAI (``mode="avg"``) and MSFI (``"final"``) over the DDIM time
schedule: DDIM for the Gaussian states, Gumbel posterior resampling for the
categorical ones.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from cdsegnet_torch.models.diffusion import DiffusionSchedule, calc_t_emb, time_schedule
from cdsegnet_torch.models.modules import Dense
from cdsegnet_torch.models.segmentor import Generators, _seg_valid
from cdsegnet_torch.models.structure import PointBatch

EPS = 1e-6


def labels_to_log_onehot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """``log(one_hot(y) + eps)``; ignore-index rows give the all-eps row."""
    oh = F.one_hot(labels.long().clamp(0, num_classes - 1), num_classes).float()
    oh = torch.where((labels >= 0)[:, None], oh, torch.zeros((), device=oh.device))
    return torch.log(oh + EPS)


def _one_hot(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    return F.one_hot(x.long(), num_classes).float()


class _DiffusionBase(nn.Module):
    """Fields as in JAX (``t_dim`` is the config's ``T_dim``)."""

    def __init__(self, backbone: nn.Module, num_classes: int = 20, T: int = 1000,
                 beta_start: float = 0.0, beta_end: float = 1000.0,
                 noise_schedule: str = "cosine", t_dim: int = 128, dm: bool = True,
                 dm_input: str = "xt", dm_target: str = "noise",
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
        self.dm_min_snr = dm_min_snr
        self.condition = condition
        self.c_in_channels = c_in_channels
        self.schedule = (DiffusionSchedule.create(noise_schedule, beta_start, beta_end,
                                                  T, dm_min_snr) if dm else None)

    def _geometry(self, point: PointBatch, gens, perms, geometry):
        """The pyramid: ``geometry`` when given, else built with its curves
        shuffled by ``perms`` or from the ``"shuffle"`` generator."""
        if geometry is not None:
            return geometry
        bb = self.backbone
        return bb.precompute_geometry(
            point, perms=perms if perms is not None else bb.shuffle_perms(gens.get("shuffle")))

    def _timesteps(self, point: PointBatch, gens, ts_scene):
        """``(ts_scene, ts_pt)``: one step per scene (drawn unless given),
        broadcast to the points (pads clipped)."""
        dev = point.coord.device
        if ts_scene is None:
            ts_scene = torch.randint(0, self.T, (point.num_scenes,),
                                     generator=gens.get("diffusion"), device=dev)
        ts_scene = ts_scene.to(device=dev, dtype=torch.int32)
        return ts_scene, ts_scene[point.batch.long().clamp(0, point.num_scenes - 1)]

    def _t_emb(self, ts_scene: torch.Tensor, batch: torch.Tensor):
        if self.t_dim == -1:
            return None
        emb = calc_t_emb(ts_scene, self.t_dim)
        return emb[batch.long().clamp(0, ts_scene.shape[0] - 1)]

    def _fixed_t_emb(self, point: PointBatch, t: int):
        ts = torch.full((point.num_scenes,), t, dtype=torch.int32,
                        device=point.coord.device)
        return self._t_emb(ts, point.batch)

    def _c_x0(self, point: PointBatch) -> torch.Tensor:
        return point.feat if point.feat.shape[-1] == self.c_in_channels else point.coord

    @staticmethod
    def _randn(shape, generator, device) -> torch.Tensor:
        return torch.randn(shape, generator=generator, dtype=torch.float32, device=device)

    def _randint(self, n: int, generator, device) -> torch.Tensor:
        return torch.randint(0, self.num_classes, (n,), generator=generator,
                             dtype=torch.int32, device=device)

    def _ddim(self, x_t, t: int, model_out, target: str):
        ts_pt = torch.full((x_t.shape[0],), t, dtype=torch.int32, device=x_t.device)
        return self.schedule.ddim_step(x_t, ts_pt, model_out, target=target)

    def _out(self, point, geometry, **kw) -> Dict[str, Any]:
        return dict(kw, n_target=point.segment, seg_valid=_seg_valid(point),
                    pyramid_dropped=[int(lv.dropped) for lv in geometry[0][1:]])


class ContinuousDMSegmentor(_DiffusionBase):
    """③ CN + GD: Gaussian diffusion on the labels (log-one-hot, c-branch)."""

    def forward(self, point: PointBatch, generators: Generators = None,
                ts_scene: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None, perms=None,
                geometry=None) -> Dict[str, Any]:
        """The training forward (in eval mode the norms use running
        statistics). ``ts_scene`` and ``noise`` (N, num_classes) replace the
        draws; returns the dict that `Criteria` reads, with
        ``pyramid_dropped``."""
        gens = generators or {}
        geometry = self._geometry(point, gens, perms, geometry)
        x0 = labels_to_log_onehot(point.segment, self.num_classes)
        target = feat_t = x0
        t_emb = None
        extra = {}
        if self.dm:
            ts_scene, ts_pt = self._timesteps(point, gens, ts_scene)
            if noise is None:
                noise = self._randn(x0.shape, gens.get("diffusion"), x0.device)
            feat_t = self.schedule.q_sample(x0, ts_pt, noise)
            if self.dm_target == "noise":
                target = noise
            t_emb = self._t_emb(ts_scene, point.batch)
            if self.dm_min_snr is not None:
                extra["snr_loss_weight"] = torch.as_tensor(
                    self.schedule.snr, device=x0.device)[ts_pt.long()]
        c_out, n_out = self.backbone(point, feat_t, t_emb=t_emb, geometry=geometry,
                                     generator=gens.get("dropout"))
        return self._out(point, geometry, c_pred=c_out, c_target=target, n_pred=n_out,
                         **extra)

    @torch.no_grad()
    def inference(self, point: PointBatch, noise: Optional[torch.Tensor] = None,
                  geometry=None, generator: Optional[torch.Generator] = None):
        """SSI: the label branch from N(0, 1) ``noise`` (N, num_classes;
        drawn from ``generator`` unless given) at t = T-1; the n logits."""
        if noise is None:
            noise = self._randn((point.num_points, self.num_classes), generator,
                                point.coord.device)
        _, n_out = self.backbone(point, noise, t_emb=self._fixed_t_emb(point, self.T - 1),
                                 geometry=geometry, return_c=False)
        return dict(seg_logits=n_out, seg_valid=_seg_valid(point))

    @torch.no_grad()
    def denoise_step(self, point: PointBatch, state: torch.Tensor, t: int,
                     geometry=None, generator=None) -> Dict[str, Any]:
        """Gaussian DDIM on the label-space ``state``; the clean features
        condition every step."""
        c_out, n_out = self.backbone(point, state, t_emb=self._fixed_t_emb(point, t),
                                     geometry=geometry)
        x_prev = self._ddim(state, t, c_out, self.dm_target)
        return dict(state=x_prev, n_logits=n_out, x0_logits=x_prev)


class CCDMSegmentor(_DiffusionBase):
    """④ GD + GD: both branches diffused (features on c, log-one-hot labels
    on n)."""

    def forward(self, point: PointBatch, generators: Generators = None,
                ts_scene: Optional[torch.Tensor] = None,
                c_noise: Optional[torch.Tensor] = None,
                n_noise: Optional[torch.Tensor] = None, perms=None,
                geometry=None) -> Dict[str, Any]:
        """The training forward; ``ts_scene``, ``c_noise`` (the c input's
        shape) and ``n_noise`` (N, num_classes) replace the draws."""
        gens = generators or {}
        geometry = self._geometry(point, gens, perms, geometry)
        c_x0 = self._c_x0(point)
        n_x0 = labels_to_log_onehot(point.segment, self.num_classes)
        ts_scene, ts_pt = self._timesteps(point, gens, ts_scene)
        g = gens.get("diffusion")
        if c_noise is None:
            c_noise = self._randn(c_x0.shape, g, c_x0.device)
        if n_noise is None:
            n_noise = self._randn(n_x0.shape, g, c_x0.device)
        n_point = point.replace(feat=self.schedule.q_sample(n_x0, ts_pt, n_noise))
        c_out, n_out = self.backbone(
            n_point, self.schedule.q_sample(c_x0, ts_pt, c_noise),
            t_emb=self._t_emb(ts_scene, point.batch), geometry=geometry,
            generator=gens.get("dropout"))
        return self._out(point, geometry, c_pred=c_out,
                         c_target=c_noise if self.dm_target == "noise" else c_x0,
                         n_pred=n_out)

    @torch.no_grad()
    def inference(self, point: PointBatch, noise: Optional[torch.Tensor] = None,
                  geometry=None, generator: Optional[torch.Generator] = None,
                  n_noise: Optional[torch.Tensor] = None):
        """SSI from N(0, 1) on both branches at t = T-1: ``noise`` the c
        input (N, c_in_channels), ``n_noise`` the labels (N, num_classes),
        each drawn from ``generator`` unless given (c first, as JAX splits
        its key)."""
        n, dev = point.num_points, point.coord.device
        if noise is None:
            noise = self._randn((n, self.c_in_channels), generator, dev)
        if n_noise is None:
            n_noise = self._randn((n, self.num_classes), generator, dev)
        _, n_out = self.backbone(point.replace(feat=n_noise), noise,
                                 t_emb=self._fixed_t_emb(point, self.T - 1),
                                 geometry=geometry, return_c=False)
        return dict(seg_logits=n_out, seg_valid=_seg_valid(point))

    @torch.no_grad()
    def denoise_step(self, point: PointBatch, state, t: int, geometry=None,
                     generator=None) -> Dict[str, Any]:
        """``state = (c_feat, n_feat)``: DDIM on the features through
        ``dm_target``, and on the labels from the x0 estimate
        ``log(softmax(n logits) + eps)``."""
        c_feat, n_feat = state
        c_out, n_out = self.backbone(point.replace(feat=n_feat), c_feat,
                                     t_emb=self._fixed_t_emb(point, t), geometry=geometry)
        c_prev = self._ddim(c_feat, t, c_out, self.dm_target)
        n_x0 = torch.log(torch.softmax(n_out, dim=-1) + EPS)
        n_prev = self._ddim(n_feat, t, n_x0, "x0")
        return dict(state=(c_prev, n_prev), n_logits=n_out, x0_logits=n_out)


class _D3PMMixin:
    """Uniform-transition D3PM in closed form (no K x K matrix chains)."""

    def _table(self, name: str, device) -> torch.Tensor:
        return torch.as_tensor(getattr(self.schedule, name), device=device)

    def d3pm_q_sample(self, labels: torch.Tensor, ts_pt: torch.Tensor, generator=None,
                      keep: Optional[torch.Tensor] = None,
                      uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x_t ~ q(x_t | x_0): the label with probability ab_t, else a
        uniform class. ``keep`` (N,) bool and ``uniform`` (N,) int replace
        the draws."""
        dev = labels.device
        if keep is None:
            ab = self._table("alpha_bar", dev)[ts_pt.long()]
            keep = torch.rand(labels.shape, generator=generator, device=dev) < ab.clamp(0, 1)
        if uniform is None:
            uniform = self._randint(labels.shape[0], generator, dev)
        safe = labels.clamp(0, self.num_classes - 1)
        return torch.where(keep.to(dev), safe, uniform.to(device=dev, dtype=labels.dtype))

    def d3pm_posterior_logits(self, x0_logits, x_t, ts_pt) -> torch.Tensor:
        """log q(x_{t-1} | x_t, x0_hat) under uniform transitions."""
        k = self.num_classes
        dev = x0_logits.device
        t = ts_pt.long()
        a_t = self._table("alphas", dev)[t][:, None]
        ab_prev = self._table("alpha_bar", dev)[(t - 1).clamp(min=0)][:, None]
        x0_prob = torch.softmax(x0_logits.float(), dim=-1)
        fact1 = a_t * _one_hot(x_t, k) + (1 - a_t) / k
        fact2 = ab_prev * x0_prob + (1 - ab_prev) / k
        logits = torch.log(fact1 * fact2 + EPS)
        return torch.where((t == 0)[:, None], torch.log(x0_prob + EPS), logits)

    def d3pm_posterior_pair(self, x0_logits, labels, x_t, ts_pt):
        """(true, predicted) posterior logits of the KL term; the true one
        conditions on the clean labels as a (near-)delta distribution."""
        true_q = self.d3pm_posterior_logits(
            labels_to_log_onehot(labels, self.num_classes), x_t, ts_pt)
        return true_q, self.d3pm_posterior_logits(x0_logits, x_t, ts_pt)

    def d3pm_ddim_sample(self, x0_logits: torch.Tensor, t: int, generator=None,
                         uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x_{t-1} ~ softmax(x0_hat) Qbar_{t-1}, Gumbel-argmax sampled with
        the uniforms ``uniform`` (the logits' shape; drawn from
        ``generator`` unless given); t == 0 gives argmax(x0_hat)."""
        if uniform is None:
            uniform = torch.rand(x0_logits.shape, generator=generator,
                                 device=x0_logits.device)
        if t == 0:
            return x0_logits.argmax(-1).int()
        ab_prev = self._table("alpha_bar", x0_logits.device)[max(t - 1, 0)]
        probs = ab_prev * torch.softmax(x0_logits.float(), dim=-1) + (1.0 - ab_prev) / \
            self.num_classes
        gumbel = -torch.log(-torch.log(uniform.to(x0_logits.device).clamp(EPS, 1.0)))
        return (torch.log(probs + EPS) + gumbel).argmax(-1).int()


class DiscreteDMSegmentor(_DiffusionBase, _D3PMMixin):
    """⑤ CN + CD: D3PM on the labels, whose noised one-hot rides the
    c-branch (head width num_classes: the x0 logits)."""

    def forward(self, point: PointBatch, generators: Generators = None,
                ts_scene: Optional[torch.Tensor] = None,
                keep: Optional[torch.Tensor] = None,
                uniform_labels: Optional[torch.Tensor] = None, perms=None,
                geometry=None) -> Dict[str, Any]:
        """The training forward; ``ts_scene``, ``keep`` and
        ``uniform_labels`` (`d3pm_q_sample`) replace the draws."""
        gens = generators or {}
        geometry = self._geometry(point, gens, perms, geometry)
        ts_scene, ts_pt = self._timesteps(point, gens, ts_scene)
        x_t = self.d3pm_q_sample(point.segment, ts_pt, gens.get("diffusion"), keep,
                                 uniform_labels)
        c_out, n_out = self.backbone(point, _one_hot(x_t, self.num_classes),
                                     t_emb=self._t_emb(ts_scene, point.batch),
                                     geometry=geometry, generator=gens.get("dropout"))
        true_q, pred_q = self.d3pm_posterior_pair(c_out, point.segment, x_t, ts_pt)
        return self._out(point, geometry, d3pm_logits=c_out, d3pm_true_q=true_q,
                         d3pm_pred_q=pred_q, n_pred=n_out)

    @torch.no_grad()
    def inference(self, point: PointBatch, noise: Optional[torch.Tensor] = None,
                  geometry=None, generator: Optional[torch.Generator] = None,
                  x_t: Optional[torch.Tensor] = None):
        """SSI from uniform labels ``x_t`` (N,) at t = T-1 (drawn from
        ``generator`` unless given); it takes no Gaussian ``noise``."""
        if noise is not None:
            raise ValueError(f"{type(self).__name__} draws no Gaussian SSI noise")
        if x_t is None:
            x_t = self._randint(point.num_points, generator, point.coord.device)
        _, n_out = self.backbone(point, _one_hot(x_t, self.num_classes),
                                 t_emb=self._fixed_t_emb(point, self.T - 1),
                                 geometry=geometry, return_c=False)
        return dict(seg_logits=n_out, seg_valid=_seg_valid(point))

    @torch.no_grad()
    def denoise_step(self, point: PointBatch, state: torch.Tensor, t: int,
                     geometry=None, generator=None,
                     uniform: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """One posterior-resampling step: x_t rides the c-branch as one-hot,
        its head gives the x0 logits, x_{t-1} is Gumbel-resampled."""
        c_out, n_out = self.backbone(point, _one_hot(state, self.num_classes),
                                     t_emb=self._fixed_t_emb(point, t), geometry=geometry)
        x_prev = self.d3pm_ddim_sample(c_out, t, generator, uniform)
        return dict(state=x_prev, n_logits=n_out, x0_logits=c_out)


class CDDMSegmentor(DiscreteDMSegmentor):
    """⑥ GD + CD: Gaussian diffusion on the features (c) and D3PM on the
    labels (n)."""

    def forward(self, point: PointBatch, generators: Generators = None,
                ts_scene: Optional[torch.Tensor] = None,
                c_noise: Optional[torch.Tensor] = None,
                keep: Optional[torch.Tensor] = None,
                uniform_labels: Optional[torch.Tensor] = None, perms=None,
                geometry=None) -> Dict[str, Any]:
        """The training forward; ``ts_scene``, ``c_noise``, ``keep`` and
        ``uniform_labels`` replace the draws."""
        gens = generators or {}
        geometry = self._geometry(point, gens, perms, geometry)
        ts_scene, ts_pt = self._timesteps(point, gens, ts_scene)
        g = gens.get("diffusion")
        c_x0 = self._c_x0(point)
        if c_noise is None:
            c_noise = self._randn(c_x0.shape, g, c_x0.device)
        x_t = self.d3pm_q_sample(point.segment, ts_pt, g, keep, uniform_labels)
        c_out, n_out = self.backbone(
            point.replace(feat=_one_hot(x_t, self.num_classes)),
            self.schedule.q_sample(c_x0, ts_pt, c_noise),
            t_emb=self._t_emb(ts_scene, point.batch), geometry=geometry,
            generator=gens.get("dropout"))
        true_q, pred_q = self.d3pm_posterior_pair(n_out, point.segment, x_t, ts_pt)
        return self._out(point, geometry, c_pred=c_out,
                         c_target=c_noise if self.dm_target == "noise" else c_x0,
                         d3pm_logits=n_out, d3pm_true_q=true_q, d3pm_pred_q=pred_q,
                         n_pred=n_out)

    @torch.no_grad()
    def inference(self, point: PointBatch, noise: Optional[torch.Tensor] = None,
                  geometry=None, generator: Optional[torch.Generator] = None,
                  x_t: Optional[torch.Tensor] = None):
        """SSI at t = T-1 from N(0, 1) ``noise`` on the c input (N,
        c_in_channels) and uniform labels ``x_t`` on the n-branch, each drawn
        from ``generator`` unless given (c first)."""
        n, dev = point.num_points, point.coord.device
        if noise is None:
            noise = self._randn((n, self.c_in_channels), generator, dev)
        if x_t is None:
            x_t = self._randint(n, generator, dev)
        _, n_out = self.backbone(point.replace(feat=_one_hot(x_t, self.num_classes)),
                                 noise, t_emb=self._fixed_t_emb(point, self.T - 1),
                                 geometry=geometry, return_c=False)
        return dict(seg_logits=n_out, seg_valid=_seg_valid(point))

    @torch.no_grad()
    def denoise_step(self, point: PointBatch, state, t: int, geometry=None,
                     generator=None, uniform: Optional[torch.Tensor] = None):
        """``state = (c_feat, x_t)``: DDIM on the features and D3PM
        resampling on the labels, jointly."""
        c_feat, x_t = state
        c_out, n_out = self.backbone(point.replace(feat=_one_hot(x_t, self.num_classes)),
                                     c_feat, t_emb=self._fixed_t_emb(point, t),
                                     geometry=geometry)
        c_prev = self._ddim(c_feat, t, c_out, self.dm_target)
        x_prev = self.d3pm_ddim_sample(n_out, t, generator, uniform)
        return dict(state=(c_prev, x_prev), n_logits=n_out, x0_logits=n_out)


class DMSegmentor(_DiffusionBase, _D3PMMixin):
    """D3PM on a single semantic branch (``condition=False`` backbone)."""

    def forward(self, point: PointBatch, generators: Generators = None,
                ts_scene: Optional[torch.Tensor] = None,
                keep: Optional[torch.Tensor] = None,
                uniform_labels: Optional[torch.Tensor] = None, perms=None,
                geometry=None) -> Dict[str, Any]:
        """The training forward; ``ts_scene``, ``keep`` and
        ``uniform_labels`` replace the draws."""
        gens = generators or {}
        geometry = self._geometry(point, gens, perms, geometry)
        _, ts_pt = self._timesteps(point, gens, ts_scene)
        x_t = self.d3pm_q_sample(point.segment, ts_pt, gens.get("diffusion"), keep,
                                 uniform_labels)
        n_out = self.backbone(point.replace(feat=_one_hot(x_t, self.num_classes)),
                              geometry=geometry, generator=gens.get("dropout"))
        true_q, pred_q = self.d3pm_posterior_pair(n_out, point.segment, x_t, ts_pt)
        return self._out(point, geometry, d3pm_logits=n_out, d3pm_true_q=true_q,
                         d3pm_pred_q=pred_q, n_pred=n_out)

    @torch.no_grad()
    def inference(self, point: PointBatch, noise: Optional[torch.Tensor] = None,
                  geometry=None, generator: Optional[torch.Generator] = None,
                  x_t: Optional[torch.Tensor] = None):
        """SSI from uniform labels ``x_t`` (drawn unless given)."""
        if noise is not None:
            raise ValueError("DMSegmentor draws no Gaussian SSI noise")
        if x_t is None:
            x_t = self._randint(point.num_points, generator, point.coord.device)
        n_out = self.backbone(point.replace(feat=_one_hot(x_t, self.num_classes)),
                              geometry=geometry)
        return dict(seg_logits=n_out, seg_valid=_seg_valid(point))

    @torch.no_grad()
    def denoise_step(self, point: PointBatch, state: torch.Tensor, t: int,
                     geometry=None, generator=None,
                     uniform: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """Single-branch posterior resampling."""
        n_out = self.backbone(point.replace(feat=_one_hot(state, self.num_classes)),
                              geometry=geometry)
        x_prev = self.d3pm_ddim_sample(n_out, t, generator, uniform)
        return dict(state=x_prev, n_logits=n_out, x0_logits=n_out)


ABLATIONS = (ContinuousDMSegmentor, CCDMSegmentor, DiscreteDMSegmentor, CDDMSegmentor,
             DMSegmentor)


class DefaultClassifier(nn.Module):
    """Shape classification head over pooled backbone features (reference
    `default.py:3329-3367`): a masked mean-pool per scene, then ``cls_fc1``
    (256), exact GELU, ``cls_fc2`` (128), exact GELU, ``cls_head``.

    ``cls_fc1`` reads the backbone's logits when its ``num_classes`` is above
    0, else its features, ``backbone_embed_dim`` wide (a PTv2 in feature
    mode gives its ``dec_channels[0]``). With labels, the per-scene target
    is the largest label of the scene's valid points (ModelNet fills
    ``segment`` with the shape's class), -1 for a scene without one, and
    ``n_pred``, ``n_target``, ``seg_valid`` and ``cls_target`` are exported
    for `Criteria` and the evaluator."""

    def __init__(self, backbone: nn.Module, num_classes: int = 40,
                 backbone_embed_dim: int = 512):
        super().__init__()
        self.backbone = backbone
        self.num_classes = num_classes
        width = getattr(backbone, "num_classes", 0)
        if width <= 0:
            width = backbone_embed_dim
            dec = getattr(backbone, "dec_channels", None)
            if dec is not None and dec[0] != width:
                raise ValueError(f"backbone_embed_dim={width}, but the backbone's "
                                 f"features are dec_channels[0]={dec[0]} wide")
        self.cls_fc1 = Dense(width, 256)
        self.cls_fc2 = Dense(256, 128)
        self.cls_head = Dense(128, num_classes)

    def forward(self, point: PointBatch, geometry=None, generators: Generators = None,
                perms: Optional[list] = None) -> Dict[str, Any]:
        gens = generators or {}
        bb = self.backbone
        if geometry is None:
            geometry = bb.precompute_geometry(
                point, perms=perms if perms is not None
                else bb.shuffle_perms(gens.get("shuffle")))
        feat = bb(point, geometry=geometry, generator=gens.get("dropout"))
        s = point.num_scenes
        seg_ids = torch.clamp(point.batch, 0, s - 1).long()
        m = point.mask[:, None].to(feat.dtype)
        sums = torch.zeros((s, feat.shape[1]), dtype=torch.float32, device=feat.device)
        sums.index_add_(0, seg_ids, (feat * m).float())
        cnts = torch.zeros((s, 1), dtype=torch.float32, device=feat.device)
        cnts.index_add_(0, seg_ids, m.float())
        pooled = (sums / torch.clamp(cnts, min=1.0)).to(feat.dtype)
        x = F.gelu(self.cls_fc1(pooled))
        x = F.gelu(self.cls_fc2(x))
        logits = self.cls_head(x)
        out: Dict[str, Any] = dict(cls_pred=logits)
        if point.segment is not None:
            labels = torch.where(point.mask, point.segment, -1)
            tgt = torch.full((s,), -1, dtype=labels.dtype, device=labels.device)
            tgt.scatter_reduce_(0, seg_ids, labels, "amax", include_self=True)
            out.update(n_pred=logits, n_target=tgt, seg_valid=tgt >= 0, cls_target=tgt)
        return out


def init_multistep_state(model: nn.Module, point: PointBatch,
                         generator: Optional[torch.Generator] = None):
    """The reverse process's state at t = T-1, drawn from ``generator``:
    N(0, 1) labels (③), N(0, 1) features and labels (④), N(0, 1) features
    and uniform labels (⑥), uniform labels (⑤, DM)."""
    n, dev = point.num_points, point.coord.device
    if isinstance(model, ContinuousDMSegmentor):
        return model._randn((n, model.num_classes), generator, dev)
    if isinstance(model, CCDMSegmentor):
        return (model._randn((n, model.c_in_channels), generator, dev),
                model._randn((n, model.num_classes), generator, dev))
    if isinstance(model, CDDMSegmentor):
        return (model._randn((n, model.c_in_channels), generator, dev),
                model._randint(n, generator, dev))
    if isinstance(model, (DiscreteDMSegmentor, DMSegmentor)):
        return model._randint(n, generator, dev)
    raise TypeError(type(model))


@torch.no_grad()
def inference_multistep(model: nn.Module, point: PointBatch, step: int = 5,
                        mode: str = "avg", generator: Optional[torch.Generator] = None,
                        state=None, uniforms=None, geometry=None) -> torch.Tensor:
    """MSAI (``mode="avg"``: the n logits averaged over the ``step + 1``
    forwards of ``time_schedule(model.T, step)``, the t = -1 slot run as
    t = 0) or MSFI (``"final"``: the last forward's). ``state`` is the
    initial state (`init_multistep_state` draws it from ``generator``
    otherwise); ``uniforms`` gives the Gumbel uniforms of each step of a
    categorical model. The pyramid is built once (or taken from
    ``geometry``) and shared by every step."""
    if mode not in ("avg", "final"):
        raise ValueError(f"mode={mode!r}: 'avg' (MSAI) or 'final' (MSFI)")
    sched = time_schedule(model.T, step)
    if state is None:
        state = init_multistep_state(model, point, generator)
    if geometry is None:
        geometry = model.backbone.precompute_geometry(point)
    n_pred = None
    for i, t in enumerate(sched):
        kw = {} if uniforms is None else dict(uniform=uniforms[i])
        res = model.denoise_step(point, state, max(int(t), 0), geometry=geometry,
                                 generator=generator, **kw)
        if mode == "avg" and n_pred is not None:
            n_pred = n_pred + res["n_logits"]
        else:
            n_pred = res["n_logits"]
        state = res["state"]
        if t <= 0:
            break
    if mode == "avg":
        n_pred = n_pred / float(len(sched))
    return n_pred
