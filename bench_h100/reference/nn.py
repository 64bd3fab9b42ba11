"""Plain layers of the references, over a flat dict of named tensors.

Every matrix product goes through a `Precision`: float32 with TF32 off (the
reference itself), TF32, or float8 e4m3 with one scale per tensor (the
controls, one step below what a configuration states). Gathers go through
``index_select``, whose backward adds with ``index_add_``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale that maps its largest
    magnitude to 448; the gradient passes straight through."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = FP8_MAX / amax
    q = (x.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q.to(x.dtype) - x).detach()


class Precision:
    """``"f32"``, ``"tf32"`` or ``"fp8"``. `use` sets torch's TF32 switches
    for the run."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def use(self) -> None:
        on = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on

    def round(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x) if self.name == "fp8" else x

    def linear(self, x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
        return F.linear(self.round(x.float()), self.round(w), b)

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.round(a) @ self.round(b)


def dense(P: Params, name: str, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    return prec.linear(x, P[f"{name}.weight"], P.get(f"{name}.bias"))


def layer_norm(P: Params, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * P[f"{name}.scale"] + P[f"{name}.bias"]


def batch_norm(P: Params, name: str, x: torch.Tensor, mask: torch.Tensor, train: bool,
               eps: float = 1e-3) -> torch.Tensor:
    """BatchNorm over the valid rows: batch statistics (biased variance) in
    training, the running statistics otherwise."""
    if train:
        m = mask.float()[:, None]
        cnt = m.sum().clamp(min=1.0)
        mean = (x * m).sum(0) / cnt
        var = ((x - mean).square() * m).sum(0) / cnt
    else:
        mean, var = P[f"{name}.mean"], P[f"{name}.var"]
    return (x - mean) * torch.rsqrt(var + eps) * P[f"{name}.scale"] + P[f"{name}.bias"]


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.index_select(0, idx.reshape(-1)).reshape(tuple(idx.shape) + tuple(x.shape[1:]))


def subm_conv(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor], prec: Precision) -> torch.Tensor:
    """Submanifold convolution: each point sums ``w[k]`` times its k-th
    neighbor's features; the index N reads a zero row."""
    n, k = nbr.shape
    padded = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    g = gather(padded, nbr).reshape(n, k * x.shape[1])
    out = prec.matmul(g, w.reshape(k * x.shape[1], -1))
    return out if b is None else out + b


def segment_max(x: torch.Tensor, slot: torch.Tensor, valid: torch.Tensor,
                m: int) -> torch.Tensor:
    """Per slot, the largest row among its valid members; 0 where none."""
    idx = torch.where(valid, slot, m)[:, None].expand_as(x)
    out = torch.full((m + 1, x.shape[1]), float("-inf"), dtype=x.dtype, device=x.device)
    out = out.scatter_reduce(0, idx, x, "amax", include_self=False)[:m]
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def patch_attention(q, k, v, bq, mq, bk, mk, patch: int, scale: float,
                    prec: Precision) -> torch.Tensor:
    """Attention within windows of ``patch`` consecutive rows: a query sees
    the valid keys of its own scene; a query that sees none gives 0.
    q, k, v (N, H, D) in window order."""
    n, h, d = q.shape
    p = n // patch
    q, k, v = (prec.round(t).reshape(p, patch, h, d) for t in (q, k, v))
    logits = torch.einsum("pihd,pjhd->phij", q, k) * scale
    allowed = (bq.reshape(p, patch)[:, :, None] == bk.reshape(p, patch)[:, None, :]) \
        & mk.reshape(p, 1, patch)
    logits = logits.masked_fill(~allowed[:, None], -1e30)
    probs = torch.softmax(logits, -1)
    probs = torch.where(allowed.any(-1)[:, None, :, None], probs, torch.zeros_like(probs))
    return torch.einsum("phij,pjhd->pihd", probs, v).reshape(n, h, d)
