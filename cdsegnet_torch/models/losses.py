"""Masked losses and the Criteria combiner (EW / GLS).

Port of `cdsegnet_tpu/models/losses.py`. Every loss takes explicit
validity masks instead of boolean indexing, as in JAX, so shapes stay
static. GLS for CDSegNet is ``loss = sqrt(MSE * (CE + Lovasz))`` with
task_num=2.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def masked_mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    v = valid.to(x.dtype)
    v = v.reshape(v.shape + (1,) * (x.dim() - v.dim()))
    return (x * v).sum() / torch.clamp(v.sum() * (x.numel() // v.numel()), min=1.0)


def mse_loss(pred: torch.Tensor, target: torch.Tensor, valid: torch.Tensor,
             snr_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked MSE on the noise branch; ``valid`` encodes ``ignore_index``
    and padding."""
    err = (pred.float() - target.float()).square()
    if snr_weight is not None:
        err = err * snr_weight[:, None].float()
    return masked_mean(err, valid)


def cross_entropy_loss(logits: torch.Tensor, target: torch.Tensor,
                       valid: torch.Tensor, label_smoothing: float = 0.0,
                       weight=None) -> torch.Tensor:
    """Masked CE, mean over valid points (weighted mean with ``weight``)."""
    num_classes = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt = target.long().clamp(0, num_classes - 1)
    if label_smoothing > 0.0:
        onehot = F.one_hot(tgt, num_classes).float()
        onehot = onehot * (1 - label_smoothing) + label_smoothing / num_classes
        nll = -(onehot * logp).sum(-1)
    else:
        nll = -logp.gather(1, tgt[:, None])[:, 0]
    if weight is not None:
        w = torch.as_tensor(weight, dtype=torch.float32, device=logits.device)[tgt]
        v = valid.float()
        return (nll * w * v).sum() / torch.clamp((w * v).sum(), min=1e-8)
    return masked_mean(nll, valid)


def _lovasz_grad_masked(fg_sorted: torch.Tensor,
                        valid_sorted: torch.Tensor) -> torch.Tensor:
    """Jaccard-extension gradient along the last axis, with invalid rows
    excluded from the cumulative union."""
    gts = fg_sorted.sum(-1, keepdim=True)
    inter = gts - torch.cumsum(fg_sorted, -1)
    union = gts + torch.cumsum(valid_sorted * (1.0 - fg_sorted), -1)
    jacc = 1.0 - inter / torch.clamp(union, min=1e-8)
    return torch.cat([jacc[..., :1], jacc[..., 1:] - jacc[..., :-1]], -1)


def lovasz_softmax_loss(logits: torch.Tensor, target: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """Masked multiclass Lovasz-Softmax over the classes present. All
    classes at once (JAX maps over them); errors are sorted in descending
    order, stably, as JAX's ``argsort(-errors)`` does."""
    num_classes = logits.shape[-1]
    probas = torch.softmax(logits.float(), dim=-1)
    v = valid.float()
    classes = torch.arange(num_classes, device=logits.device)
    fg = (target[None, :] == classes[:, None]).float() * v  # (C, N)
    errors = (fg - probas.t()).abs() * v  # invalid rows contribute 0
    err_s, order = torch.sort(errors, dim=-1, descending=True, stable=True)
    grad = _lovasz_grad_masked(fg.gather(1, order), v[order])
    losses = (err_s * grad).sum(-1)
    present = (fg.sum(-1) > 0).float()
    return (losses * present).sum() / torch.clamp(present.sum(), min=1.0)


def binary_focal_loss(logits: torch.Tensor, target: torch.Tensor, valid: torch.Tensor,
                      gamma: float = 2.0, alpha: float = 0.5) -> torch.Tensor:
    """Binary focal loss on logits (reference `misc.py:148-182`); ``target``
    broadcasts against ``logits`` as in JAX."""
    t = target.float()
    x = logits.float()
    bce = torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs()))
    pt = torch.exp(-bce)
    a = alpha * t + (1 - alpha) * (1 - t)
    return masked_mean(a * (1 - pt) ** gamma * bce, valid)


def focal_loss(logits: torch.Tensor, target: torch.Tensor, valid: torch.Tensor,
               gamma: float = 2.0, alpha: float = 0.5) -> torch.Tensor:
    """Multiclass sigmoid focal loss (reference `misc.py:185-261`)."""
    num_classes = logits.shape[-1]
    tgt = F.one_hot(target.long().clamp(0, num_classes - 1), num_classes).float()
    p = torch.sigmoid(logits.float())
    one_minus_pt = (1 - p) * tgt + p * (1 - tgt)
    w = (alpha * tgt + (1 - alpha) * (1 - tgt)) * one_minus_pt ** gamma
    bce = torch.clamp(logits, min=0) - logits * tgt + torch.log1p(torch.exp(-logits.abs()))
    return masked_mean(bce * w, valid)


def dice_loss(logits: torch.Tensor, target: torch.Tensor, valid: torch.Tensor,
              smooth: float = 1.0, exponent: float = 2.0) -> torch.Tensor:
    """Multiclass Dice (reference `misc.py:264-312`), over every class."""
    num_classes = logits.shape[-1]
    p = torch.softmax(logits.float(), dim=-1)
    v = valid.float()[:, None]
    tgt = F.one_hot(target.long().clamp(0, num_classes - 1), num_classes).float() * v
    p = p * v
    num = 2 * (p * tgt).sum(0) + smooth
    den = (p ** exponent + tgt ** exponent).sum(0) + smooth
    return (1 - num / den).mean()


def d3pm_kl_loss(pred_q_logits: torch.Tensor, true_q_logits: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """KL(q(x_{t-1} | x_t, x0) || p(x_{t-1} | x_t, x0_hat)) over valid
    points: the D3PM posterior matching term of the discrete-diffusion
    ablations."""
    logp = torch.log_softmax(pred_q_logits.float(), dim=-1)
    logq = torch.log_softmax(true_q_logits.float(), dim=-1)
    kl = (torch.exp(logq) * (logq - logp)).sum(-1)
    return masked_mean(kl, valid)


def offset_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """PointGroup bias L1: mean ``|pred - target|`` (summed over xyz) over
    instance points."""
    l1 = (pred.float() - target.float()).abs().sum(-1)
    v = valid.float()
    return (l1 * v).sum() / torch.clamp(v.sum(), min=1e-8)


def offset_cosine_loss(pred: torch.Tensor, target: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """PointGroup bias direction loss: mean negative cosine similarity over
    instance points."""
    p, t = pred.float(), target.float()
    pn = p / (torch.linalg.vector_norm(p, dim=-1, keepdim=True) + 1e-8)
    tn = t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-8)
    cos = -(pn * tn).sum(-1)
    v = valid.float()
    return (cos * v).sum() / torch.clamp(v.sum(), min=1e-8)


def cac_distill_loss(pred: torch.Tensor, soft: torch.Tensor, target: torch.Tensor,
                     valid: torch.Tensor, smoothness: float = 0.5,
                     eps: float = 0.0) -> torch.Tensor:
    """CAC distillation: cross-entropy of the refined logits against
    ``smoothness``-mixed (teacher softmax, one-hot) labels, weighted per
    point by the teacher's entropy, averaged per class and then over the
    classes present. The teacher ``soft`` is detached."""
    num_classes = pred.shape[-1]
    sm = torch.softmax(soft.detach().float(), dim=-1)
    vm = (valid & (target >= 0)).float()
    oh = F.one_hot(target.long().clamp(0, num_classes - 1), num_classes).float()
    oh = oh * vm[:, None]
    smoothed = smoothness * sm + (1.0 - smoothness) * oh
    if eps > 0:
        smoothed = smoothed * (1 - eps) + (1 - smoothed) * eps / (num_classes - 1)
    logp = torch.log_softmax(pred.float(), dim=-1)
    l_pt = -(logp * smoothed).sum(-1)
    ent = -(sm * torch.log(sm + 1e-4)).sum(-1) * vm
    per_num = (l_pt * ent) @ oh
    per_den = ent @ oh
    per_loss = per_num / (per_den + 1e-4)
    present = (oh.sum(0) > 0).float()
    return (per_loss * present).sum() / (present.sum() + 1e-4)


def subsample_valid(valid: torch.Tensor, batch: torch.Tensor, num_scenes: int,
                    per_scene: int,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Keep about ``per_scene`` valid points per scene: Bernoulli thinning
    at rate per_scene / count, with uniforms drawn from ``generator`` (on
    ``valid``'s device)."""
    scene = batch.long().clamp(0, num_scenes - 1)
    cnt = torch.zeros(num_scenes, dtype=torch.float32, device=valid.device)
    cnt.index_add_(0, scene, valid.float())
    rate = torch.clamp(per_scene / torch.clamp(cnt, min=1.0), 0.0, 1.0)
    u = torch.rand(valid.shape, generator=generator, device=valid.device)
    return valid & (u < rate[scene])


# cfg keys each loss type accepts; anything else is a config error (a silently
# dropped `ignore_index=`/`mode=` kwarg would mask a typo'd recipe)
_ALLOWED_KEYS = {
    "MSELoss": {"type", "loss_weight", "pred", "target", "valid",
                "batch_sample_point", "ignore_index"},
    "CrossEntropyLoss": {"type", "loss_weight", "pred", "target",
                         "label_smoothing", "weight", "ignore_index"},
    "LovaszLoss": {"type", "loss_weight", "pred", "target", "mode",
                   "ignore_index"},
    "FocalLoss": {"type", "loss_weight", "gamma", "alpha", "ignore_index"},
    "SmoothCELoss": {"type", "loss_weight", "smoothing_ratio"},
    "BinaryFocalLoss": {"type", "loss_weight", "gamma", "alpha"},
    "DiceLoss": {"type", "loss_weight", "smooth", "exponent", "ignore_index"},
    "D3PMKLLoss": {"type", "loss_weight", "pred", "target"},
    "CACDistillLoss": {"type", "loss_weight", "pred", "soft", "smoothness",
                       "eps"},
    "OffsetL1Loss": {"type", "loss_weight"},
    "OffsetCosineLoss": {"type", "loss_weight"},
}


class Criteria:
    """Loss combiner. ``loss_type``: "EW" sums the terms; "GLS" (train
    only) computes ``(MSE * (CE + Lovasz)) ** (1 / task_num)``.

    Each loss cfg may override the output-dict keys it reads with ``pred=``
    and ``target=``; a loss whose pred key is absent contributes nothing.
    """

    def __init__(self, loss_cfgs=None, loss_type: str = "EW", task_num: int = 2):
        self.loss_cfgs = loss_cfgs or []
        self.loss_type = loss_type
        self.task_num = task_num
        for cfg in self.loss_cfgs:
            kind = cfg["type"]
            if kind not in _ALLOWED_KEYS:
                raise NotImplementedError(kind)
            unknown = set(cfg) - _ALLOWED_KEYS[kind]
            if unknown:
                raise ValueError(
                    f"{kind}: unknown config keys {sorted(unknown)} "
                    f"(allowed: {sorted(_ALLOWED_KEYS[kind])})")

    def _terms(self, out: Dict[str, torch.Tensor]):
        terms = []
        for cfg in self.loss_cfgs:
            kind = cfg["type"]
            w = cfg.get("loss_weight", 1.0)
            if kind == "MSELoss":
                pk = cfg.get("pred", "c_pred")
                if pk not in out:
                    continue
                valid = out.get(cfg.get("valid", "mse_valid"), out["seg_valid"])
                terms.append(w * mse_loss(out[pk], out[cfg.get("target", "c_target")],
                                          valid, out.get("snr_loss_weight")))
            elif kind in ("CrossEntropyLoss", "SmoothCELoss"):
                pk = cfg.get("pred", "n_pred")
                if pk not in out:
                    continue
                smoothing = (cfg.get("label_smoothing", 0.0) if kind == "CrossEntropyLoss"
                             else cfg.get("smoothing_ratio", 0.1))
                terms.append(w * cross_entropy_loss(
                    out[pk], out[cfg.get("target", "n_target")], out["seg_valid"],
                    label_smoothing=smoothing, weight=cfg.get("weight")))
            elif kind in ("FocalLoss", "BinaryFocalLoss"):
                fn = focal_loss if kind == "FocalLoss" else binary_focal_loss
                terms.append(w * fn(out["n_pred"], out["n_target"], out["seg_valid"],
                                    gamma=cfg.get("gamma", 2.0),
                                    alpha=cfg.get("alpha", 0.5)))
            elif kind == "DiceLoss":
                terms.append(w * dice_loss(out["n_pred"], out["n_target"], out["seg_valid"],
                                           smooth=cfg.get("smooth", 1.0),
                                           exponent=cfg.get("exponent", 2.0)))
            elif kind == "D3PMKLLoss":
                pk = cfg.get("pred", "d3pm_pred_q")
                if pk not in out:
                    continue
                terms.append(w * d3pm_kl_loss(
                    out[pk], out[cfg.get("target", "d3pm_true_q")], out["seg_valid"]))
            elif kind in ("OffsetL1Loss", "OffsetCosineLoss"):
                if "offset_target" not in out:
                    continue
                fn = offset_l1_loss if kind == "OffsetL1Loss" else offset_cosine_loss
                terms.append(w * fn(out["offset_pred"], out["offset_target"],
                                    out["instance_valid"]))
            elif kind == "CACDistillLoss":
                sk = cfg.get("soft", "cac_pred")
                if sk not in out:
                    continue
                terms.append(w * cac_distill_loss(
                    out[cfg.get("pred", "n_pred")], out[sk], out["n_target"],
                    out["seg_valid"], smoothness=cfg.get("smoothness", 0.5),
                    eps=cfg.get("eps", 0.0)))
            else:  # LovaszLoss
                pk = cfg.get("pred", "n_pred")
                if pk not in out:
                    continue
                terms.append(w * lovasz_softmax_loss(
                    out[pk], out[cfg.get("target", "n_target")], out["seg_valid"]))
        return terms

    def __call__(self, out: Dict[str, torch.Tensor], mode: str = "train"):
        terms = self._terms(out)
        if not terms:
            if "loss" in out:
                return out["loss"]
            return torch.zeros((), dtype=torch.float32)
        if mode == "eval" or self.loss_type == "EW":
            return sum(terms)
        if self.loss_type == "GLS":
            if self.task_num == 1 and len(terms) >= 2:
                loss = terms[0] + terms[1]
            elif self.task_num == 2 and len(terms) == 3:
                loss = terms[0] * (terms[1] + terms[2])  # MSE * (CE + Lovasz)
            else:
                loss = torch.prod(torch.stack(terms))
            return torch.pow(torch.clamp(loss, min=1e-12), 1.0 / self.task_num)
        raise ValueError(self.loss_type)


def build_criteria(cfg, loss_type: str = "EW", task_num: int = 2) -> Criteria:
    return Criteria(cfg, loss_type=loss_type, task_num=task_num)
