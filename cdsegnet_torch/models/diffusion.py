"""Diffusion schedules and timestep embeddings.

Port of `cdsegnet_tpu/models/diffusion.py`: the beta schedules, q-sampling
for the CNF training step, the deterministic DDIM reverse step and the DDIM
time schedule of the multi-step inference modes. Quirk preserved: the "cosine" schedule evaluates ``t =
linspace(start, stop, T+1) / T`` with (start, stop) taken from the *beta*
config values; CDSegNet configs use beta_start=0, beta_end=1000, so t spans
[0, 1].
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch


def get_betas(schedule: str, start: float, stop: float, T: int) -> np.ndarray:
    if schedule == "linear":
        scale = 1000.0 / T
        return np.linspace(scale * start, scale * stop, T, dtype=np.float64)
    if schedule == "cosine":
        s = 0.008
        t = np.linspace(start, stop, T + 1, dtype=np.float64) / T
        ac = np.cos((t + s) / (1 + s) * math.pi * 0.5) ** 2
        ac = ac / ac[0]
        betas = 1.0 - ac[1:] / ac[:-1]
        return np.clip(betas, 0.0, 0.999)
    if schedule == "sigmoid":
        lo, hi, tau = -3.0, 3.0, 1.0
        t = np.linspace(0, T, T + 1, dtype=np.float64) / T
        sig = lambda x: 1.0 / (1.0 + np.exp(-x))
        v_start, v_end = sig(lo / tau), sig(hi / tau)
        ac = (-sig((t * (hi - lo) + lo) / tau) + v_end) / (v_end - v_start)
        ac = ac / ac[0]
        betas = 1.0 - ac[1:] / ac[:-1]
        return np.clip(betas, 0.0, 0.999)
    if schedule == "laplace":
        mu, b = 0.0, 0.5
        t = np.linspace(0, 1, 1002, dtype=np.float64)[1:-1]
        lmb = mu - b * np.sign(0.5 - t) * np.log(1 - 2 * np.abs(0.5 - t))
        snr = np.exp(lmb)
        ac = snr / (1 + snr)
        ac = ac / ac[0]
        betas = 1.0 - ac[1:] / ac[:-1]
        return np.clip(betas, 0.0, 0.999)
    raise NotImplementedError(schedule)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed tables, all shape (T,), float32."""

    T: int
    betas: np.ndarray
    alphas: np.ndarray
    alpha_bar: np.ndarray
    sigma: np.ndarray
    snr: np.ndarray

    @classmethod
    def create(cls, schedule: str = "cosine", beta_start: float = 0.0,
               beta_end: float = 1000.0, T: int = 1000,
               min_snr: Optional[float] = None) -> "DiffusionSchedule":
        betas = get_betas(schedule, beta_start, beta_end, T)
        alphas = 1.0 - betas
        alpha_bar = np.cumprod(alphas)
        prev = np.concatenate([[1.0], alpha_bar[:-1]])
        sigma = np.sqrt(betas * (1 - prev) / (1 - alpha_bar))
        sigma[0] = 0.0
        snr = alpha_bar / (1 - alpha_bar)
        if min_snr is not None:
            snr = np.clip(snr, None, min_snr)
        f32 = lambda x: x.astype(np.float32)
        return cls(T, f32(betas), f32(alphas), f32(alpha_bar), f32(sigma), f32(snr))

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """x_t = sqrt(ab_t) x0 + sqrt(1 - ab_t) eps, per row of ``t``."""
        ab = torch.as_tensor(self.alpha_bar, device=x0.device)[t.long()]
        ab = ab.reshape(ab.shape + (1,) * (x0.dim() - ab.dim()))
        return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * noise

    def ddim_step(self, x_t: torch.Tensor, t: torch.Tensor, model_out: torch.Tensor,
                  target: str = "noise") -> torch.Tensor:
        """Deterministic DDIM reverse step: x0 from the model's noise (or x0)
        prediction, then x_{t-1} = sqrt(ab_{t-1}) x0 + sqrt(1 - ab_{t-1})
        eps. ``t`` is a per-row (or scalar) integer step; rows with t == 0
        return x0."""
        ab = torch.as_tensor(self.alpha_bar, device=x_t.device)
        t = t.long()
        bcast = lambda a: a.reshape(a.shape + (1,) * (x_t.dim() - a.dim()))
        ab_t = bcast(ab[t])
        if target == "noise":
            noise = model_out
            x0 = (x_t - torch.sqrt(1.0 - ab_t) * noise) / torch.sqrt(ab_t)
        elif target == "x0":
            x0 = model_out
            noise = (x_t - torch.sqrt(ab_t) * x0) / torch.sqrt(1.0 - ab_t)
        else:
            raise ValueError(target)
        ab_p = bcast(ab[torch.clamp(t - 1, min=0)])
        x_prev = torch.sqrt(ab_p) * x0 + torch.sqrt(1.0 - ab_p) * noise
        is_zero = (t == 0).reshape((-1,) + (1,) * (x_t.dim() - 1))
        return torch.where(is_zero, x0, x_prev)


def time_schedule(T: int = 1000, step: int = 5) -> np.ndarray:
    """DDIM sampling schedule: ``linspace(-1, T-1, step+1)`` as integers,
    descending (the last entry is -1, run as t = 0)."""
    return np.linspace(-1, T - 1, num=step + 1, dtype=int)[::-1].copy()


def calc_t_emb(ts: torch.Tensor, t_emb_dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding: (B,) or (B, 1) integer steps ->
    (B, t_emb_dim) float32."""
    if t_emb_dim % 2:
        raise ValueError("t_emb_dim must be even")
    if ts.dim() == 1:
        ts = ts[:, None]
    half = t_emb_dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=ts.device)
                      * (-math.log(10000.0) / (half - 1)))
    ang = ts.float() * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)
