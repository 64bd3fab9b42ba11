"""The training losses, masked: MSE, cross-entropy, Lovasz-Softmax and GLS."""

from __future__ import annotations

import torch


def masked_mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    v = valid.float().reshape(valid.shape + (1,) * (x.dim() - valid.dim()))
    return (x * v).sum() / (v.sum() * (x.numel() // valid.numel())).clamp(min=1.0)


def cross_entropy(logits: torch.Tensor, target: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, -1)
    tgt = target.long().clamp(0, logits.shape[-1] - 1)
    return masked_mean(-logp.gather(1, tgt[:, None])[:, 0], valid)


def lovasz_softmax(logits: torch.Tensor, target: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Multiclass Lovasz-Softmax over the classes present among the valid
    points (Berman et al., CVPR 2018)."""
    k = logits.shape[-1]
    probs = torch.softmax(logits, -1)
    v = valid.float()
    fg = (target[None, :] == torch.arange(k, device=logits.device)[:, None]).float() * v
    errors = (fg - probs.t()).abs() * v
    err_sorted, order = torch.sort(errors, dim=-1, descending=True, stable=True)
    fg_sorted, v_sorted = fg.gather(1, order), v[order]
    gts = fg_sorted.sum(-1, keepdim=True)
    inter = gts - torch.cumsum(fg_sorted, -1)
    union = gts + torch.cumsum(v_sorted * (1.0 - fg_sorted), -1)
    jacc = 1.0 - inter / union.clamp(min=1e-8)
    grad = torch.cat([jacc[:, :1], jacc[:, 1:] - jacc[:, :-1]], -1)
    present = (fg.sum(-1) > 0).float()
    return ((err_sorted * grad).sum(-1) * present).sum() / present.sum().clamp(min=1.0)


def gls_loss(c_pred, noise, mse_valid, logits, segment, seg_valid) -> torch.Tensor:
    """``sqrt(MSE * (CE + Lovasz))``: the geometric loss of the two tasks."""
    mse = masked_mean((c_pred - noise).square(), mse_valid)
    seg = cross_entropy(logits, segment, seg_valid) + lovasz_softmax(logits, segment, seg_valid)
    return torch.sqrt((mse * seg).clamp(min=1e-12))
