"""Optimizer and learning-rate schedules.

Port of `cdsegnet_tpu/engine/optimizer.py` (optax there): AdamW, SGD or
Adam over keyword parameter groups, each group with its own schedule scaled
to its learning rate (CDSegNet: the keyword "block" trains at lr 2e-4, the
rest at 2e-3), the five schedules of `build_schedule`, and
`clip_by_keyword`. As in optax, update k (counted from 0) uses the learning
rate ``schedule(k)``; the schedules compute in float32, as the JAX ones do.

SGD is `torch.optim.SGD` with ``dampening=0``: its momentum buffer and
Nesterov rule equal optax's ``trace(nesterov)``. Its weight decay is
coupled, added to the gradient before the momentum, as torch (and the
upstream recipes tuned with it) do; JAX's chain adds the decayed weights
after the learning-rate scaling, which grows every weight by ``1 + wd`` per
step, and the port does not copy that. Adam reads ``lr`` only, as
``optax.adam(lr_sched)`` does: ``betas`` and ``weight_decay`` are ignored
for it, as in JAX.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from cdsegnet_torch.utils.device import resolve_device

Schedule = Callable[[int], float]
_F = np.float32


def onecycle_schedule(max_lr: float, total_steps: int, pct_start: float = 0.3,
                      div_factor: float = 25.0,
                      final_div_factor: float = 1e4) -> Schedule:
    """One-cycle with cosine annealing, the JAX package's formula (not
    `torch.optim.lr_scheduler.OneCycleLR`, whose phase boundary differs):
    up for ``max(int(total_steps * pct_start), 1)`` steps from
    ``max_lr / div_factor`` to ``max_lr``, then down to that initial value
    over ``final_div_factor``."""
    initial = max_lr / div_factor
    final = initial / final_div_factor
    up = max(int(total_steps * pct_start), 1)
    down = max(total_steps - up, 1)

    def sched(step: int) -> float:
        step = _F(step)
        upf = _F(0.5) * (_F(1) + np.cos(_F(math.pi) * (_F(1) - np.clip(step / _F(up), _F(0), _F(1)))))
        if step < up:
            return float(_F(initial) + _F(max_lr - initial) * upf)
        t = np.clip((step - _F(up)) / _F(down), _F(0), _F(1))
        downf = _F(0.5) * (_F(1) + np.cos(_F(math.pi) * t))
        return float(_F(final) + _F(max_lr - final) * downf)

    return sched


def build_schedule(cfg: Dict[str, Any], max_lr: float, total_steps: int) -> Schedule:
    kind = cfg["type"]
    if kind == "OneCycleLR":
        return onecycle_schedule(max_lr, total_steps,
                                 pct_start=cfg.get("pct_start", 0.3),
                                 div_factor=cfg.get("div_factor", 25.0),
                                 final_div_factor=cfg.get("final_div_factor", 1e4))
    if kind in ("MultiStepLR", "MultiStepWithWarmupLR"):
        milestones = sorted({int(m * total_steps) for m in cfg.get("milestones", [])})
        gamma = cfg.get("gamma", 0.1)
        # optax.piecewise_constant_schedule over JAX's {milestone: gamma}
        # dict: scaled once from each distinct milestone on
        return lambda step: float(_F(max_lr) * _F(gamma) ** sum(step >= m for m in milestones))
    if kind == "PolyLR":
        power = cfg.get("power", 0.9)
        return lambda step: float(_F(max_lr) * (_F(1) - _F(min(step, total_steps)) / _F(total_steps)) ** _F(power))
    if kind == "ExpLR":
        gamma = cfg.get("gamma", 0.9)
        return lambda step: float(_F(max_lr) * _F(gamma) ** (_F(step) / _F(total_steps)))
    if kind == "CosineAnnealingLR":
        # optax.cosine_decay_schedule(max_lr, total_steps)
        return lambda step: float(_F(max_lr) * _F(0.5) * (_F(1) + np.cos(
            _F(math.pi) * _F(min(step, total_steps)) / _F(total_steps))))
    raise NotImplementedError(kind)


def clip_by_keyword(named_params, keywords: Sequence[str], max_norm: float = 0.1) -> None:
    """Scale, in place, the gradients of the parameters whose name holds one
    of ``keywords`` so that their joint norm is at most ``max_norm``."""
    if not keywords:
        return
    grads = [p.grad for name, p in named_params
             if p.grad is not None and any(k in name for k in keywords)]
    if not grads:
        return
    sq = sum(g.float().square().sum() for g in grads)
    scale = torch.clamp(max_norm / torch.sqrt(torch.clamp(sq, min=1e-16)), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))


def _torch_optimizer(kind: str, groups, cfg: Dict[str, Any]) -> torch.optim.Optimizer:
    """The torch optimizer of config ``kind`` over ``groups`` (lr set per
    step), with the hyperparameters that JAX's `build_optimizer` reads."""
    if kind == "AdamW":
        return torch.optim.AdamW(groups, betas=tuple(cfg.get("betas", (0.9, 0.999))),
                                 eps=1e-8, weight_decay=cfg.get("weight_decay", 0.0))
    if kind == "Adam":  # optax.adam(lr_sched): default betas, no decay
        return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)
    if kind == "SGD":
        return torch.optim.SGD(groups, momentum=cfg.get("momentum", 0.9), dampening=0.0,
                               nesterov=cfg.get("nesterov", False),
                               weight_decay=cfg.get("weight_decay", 0.0))
    raise NotImplementedError(f"optimizer {kind!r} is not ported")


class KeywordOptimizer:
    """`torch.optim.AdamW`, `SGD` or `Adam` (config ``type``) over keyword
    parameter groups, each with its own schedule, with `clip_by_keyword`
    applied to the gradients first.

    ``labels`` maps each parameter name to its group: ``"default"`` or
    ``"group{i}"`` for the first ``param_dicts[i]`` whose keyword the name
    holds, as the JAX label tree does.
    """

    def __init__(self, named_params, labels: Dict[str, str],
                 schedules: Dict[str, Schedule], cfg: Optional[Dict[str, Any]] = None,
                 clip_keywords: Sequence[str] = ()):
        cfg = dict(cfg or {})
        self.kind = cfg.get("type", "AdamW")
        self.named_params = list(named_params)
        self.labels = labels
        self.clip_keywords = tuple(clip_keywords)
        groups: Dict[str, List[torch.nn.Parameter]] = {}
        for name, p in self.named_params:
            groups.setdefault(labels[name], []).append(p)
        self.group_names = [g for g in schedules if g in groups]
        self.schedules = [schedules[g] for g in self.group_names]
        self.opt = _torch_optimizer(
            self.kind, [dict(params=groups[g], lr=0.0) for g in self.group_names], cfg)
        self.count = 0  # updates made so far

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def lrs(self) -> Dict[str, float]:
        """The learning rate of the next update, per group."""
        return {g: s(self.count) for g, s in zip(self.group_names, self.schedules)}

    def state_dict(self) -> Dict[str, Any]:
        """The moments (or momentum buffers) and the update count, for
        checkpoints."""
        return dict(opt=self.opt.state_dict(), count=self.count)

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.opt.load_state_dict(state["opt"])
        self.count = int(state["count"])

    def step(self) -> None:
        clip_by_keyword(self.named_params, self.clip_keywords, 0.1)
        for group, sched in zip(self.opt.param_groups, self.schedules):
            group["lr"] = sched(self.count)
        self.opt.step()
        self.count += 1


def build_optimizer(cfg: Dict[str, Any], model: torch.nn.Module,
                    scheduler_cfg: Optional[Dict[str, Any]] = None,
                    total_steps: int = 1,
                    param_dicts: Optional[Sequence[Dict[str, Any]]] = None,
                    clip_keywords: Sequence[str] = (),
                    device: Optional[Union[str, torch.device]] = None) -> KeywordOptimizer:
    """AdamW, SGD or Adam (``cfg["type"]``) over ``model``'s parameters with
    keyword groups and per-group schedules. The model must be on ``device``
    (the GPU unless the caller names another; raises without one)."""
    device = resolve_device(device)
    named = list(model.named_parameters())
    off = [n for n, p in named if p.device.type != device.type]
    if off:
        raise ValueError(f"parameters not on {device}: {off[:3]}")
    base_lr = cfg.get("lr", 1e-3)
    param_dicts = list(param_dicts or [])

    def sched_for(lr: float) -> Schedule:
        if scheduler_cfg is None:
            return lambda step: lr
        return build_schedule(dict(scheduler_cfg), lr, total_steps)

    def label(name: str) -> str:
        for i, g in enumerate(param_dicts):
            if g["keyword"] in name:
                return f"group{i}"
        return "default"

    schedules = {"default": sched_for(base_lr)}
    for i, g in enumerate(param_dicts):
        schedules[f"group{i}"] = sched_for(g.get("lr", base_lr))
    return KeywordOptimizer(named, {n: label(n) for n, _ in named}, schedules, cfg,
                            clip_keywords=clip_keywords)
