"""Building blocks: Dense, masked BatchNorm (plain and prompt-driven),
LayerNorm, MLP, dropout, DropPath, SubMConv.

Port of `cdsegnet_tpu/models/modules.py`. Parameters are float32 and carry
the flax names (``scale``/``bias`` for norms, ``weight`` (K, C_in, C_out)
for convs); each module computes in its ``dtype`` exactly where the flax
module does: Dense and conv cast inputs and weights to ``dtype``, norms take
their statistics in float32 and cast the result back.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cdsegnet_torch.ops.subm_conv import (
    blocked_k3_conv_apply,
    blocked_subm_conv_apply,
    subm_conv_apply,
)


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=...)``: float32 parameters, computed in
    ``dtype`` (weight is ``(out, in)``, the transpose of the flax kernel)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over valid points only, with running statistics (torch
    ``BatchNorm1d(eps=1e-3, momentum=0.01)`` semantics).

    In training mode it normalizes with the float32 batch statistics of the
    rows where ``mask`` is set, and updates the running statistics once per
    call, without grad: ``running = (1 - momentum) * running + momentum *
    batch_stat``, with the unbiased variance ``var * cnt / max(cnt - 1, 1)``.
    In eval mode it normalizes with the running statistics.
    """

    def __init__(self, features: int, eps: float = 1e-3, momentum: float = 0.01,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            m = mask.float()[:, None]
            cnt = torch.clamp(m.sum(), min=1.0)
            mean = (xf * m).sum(0) / cnt
            var = ((xf - mean).square() * m).sum(0) / cnt
            with torch.no_grad():
                unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
                self.mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.scale + self.bias).to(self.dtype)


class PDMaskedBatchNorm(nn.Module):
    """Prompt-driven masked BatchNorm (reference ``PDBatchNorm``,
    `point_transformer_v2m3_pdnorm.py:27-78`): `MaskedBatchNorm` with one
    set of parameters and running statistics per condition (dataset),
    stacked as ``(num_conditions, C)`` and selected by the call's
    ``condition``; in training only that condition's statistics advance.
    ``adaptive`` adds the context modulation: ``modulation``, a Dense of
    ``silu(context)`` (``context_channels`` wide) to a shift and a scale."""

    def __init__(self, features: int, num_conditions: int = 1, adaptive: bool = False,
                 affine: bool = True, eps: float = 1e-3, momentum: float = 0.01,
                 context_channels: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_conditions = num_conditions
        self.eps = eps
        self.momentum = momentum
        self.dtype = dtype
        k = num_conditions
        self.register_buffer("mean", torch.zeros(k, features))
        self.register_buffer("var", torch.ones(k, features))
        if affine:
            self.scale = nn.Parameter(torch.ones(k, features))
            self.bias = nn.Parameter(torch.zeros(k, features))
        else:
            self.scale = self.bias = None
        self.modulation = Dense(context_channels, 2 * features) if adaptive else None

    def forward(self, x: torch.Tensor, mask: torch.Tensor, condition: int = 0,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not 0 <= condition < self.num_conditions:
            raise ValueError(f"condition {condition} out of range {self.num_conditions}")
        xf = x.float()
        if self.training:
            m = mask.float()[:, None]
            cnt = torch.clamp(m.sum(), min=1.0)
            mean = (xf * m).sum(0) / cnt
            var = ((xf - mean).square() * m).sum(0) / cnt
            with torch.no_grad():
                unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
                self.mean[condition] = ((1 - self.momentum) * self.mean[condition]
                                        + self.momentum * mean)
                self.var[condition] = ((1 - self.momentum) * self.var[condition]
                                       + self.momentum * unbiased)
        else:
            mean, var = self.mean[condition], self.var[condition]
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        if self.scale is not None:
            y = y * self.scale[condition] + self.bias[condition]
        if self.modulation is not None:
            if context is None:
                raise ValueError("adaptive PDNorm needs a context vector")
            shift, scale = self.modulation(F.silu(context.float())).chunk(2, dim=-1)
            y = y * (1.0 + scale) + shift
        return y.to(self.dtype)


def make_norm(c: int, *, num_conditions: int = 0, adaptive: bool = False,
              context_channels: int = 256, dtype: torch.dtype = torch.float32):
    """Plain masked BN, or prompt-driven BN when ``num_conditions > 0``
    (JAX: `cdsegnet_tpu/models/spunet.py::make_norm`)."""
    if num_conditions > 0:
        return PDMaskedBatchNorm(c, num_conditions=num_conditions, adaptive=adaptive,
                                 context_channels=context_channels, dtype=dtype)
    return MaskedBatchNorm(c, dtype=dtype)


def apply_norm(mod: nn.Module, f: torch.Tensor, mask: torch.Tensor, condition: int = 0,
               context: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Call a norm of `make_norm`: the condition and context go to PDNorm."""
    if isinstance(mod, PDMaskedBatchNorm):
        return mod(f, mask, condition, context)
    return mod(f, mask)


class LayerNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias
        return y.to(self.dtype)


class Mlp(nn.Module):
    """Transformer FFN: fc1 -> exact GELU -> dropout -> fc2 -> dropout."""

    def __init__(self, in_features: int, hidden: int, out: int, drop: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.drop = drop
        self.fc1 = Dense(in_features, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, out, dtype=dtype)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        det = not self.training
        x = dropout(F.gelu(self.fc1(x)), self.drop, det, generator)
        return dropout(self.fc2(x), self.drop, det, generator)


class DropoutDraws:
    """The ``"dropout"`` generator with the elementwise dropout keep masks
    given in call order (tests feed JAX's): `dropout` takes the next mask;
    `drop_path` takes the next of ``path_masks`` when they are given, else
    draws from ``generator``."""

    def __init__(self, generator: Optional[torch.Generator], masks, path_masks=None):
        self.generator = generator
        self.masks = list(masks)
        self.path_masks = None if path_masks is None else list(path_masks)

    @staticmethod
    def _pop(masks, shape, what) -> torch.Tensor:
        if not masks:
            raise ValueError(f"more {what} calls than injected masks")
        m = masks.pop(0)
        if tuple(m.shape) != tuple(shape):
            raise ValueError(f"injected {what} mask {tuple(m.shape)} for an input "
                             f"of shape {tuple(shape)}")
        return m

    def next_mask(self, shape) -> torch.Tensor:
        return self._pop(self.masks, shape, "dropout")

    def next_path_mask(self, shape) -> torch.Tensor:
        return self._pop(self.path_masks, shape, "drop_path")


def dropout(x: torch.Tensor, rate: float, deterministic: bool = True,
            generator=None) -> torch.Tensor:
    """flax ``nn.Dropout``: elementwise keep mask of probability ``1 -
    rate``, kept entries divided by it; the identity when ``deterministic``
    or at rate 0. The mask is drawn from ``generator`` (on ``x``'s device),
    or is the next of a `DropoutDraws`."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    if isinstance(generator, DropoutDraws):
        m = generator.next_mask(x.shape).to(x.device)
    elif generator is None:
        raise ValueError("dropout needs an explicit torch.Generator")
    else:
        m = torch.rand(x.shape, generator=generator, device=x.device) < keep
    # the keep probability rounded to x's dtype first, as in JAX
    return torch.where(m, x / torch.tensor(keep, dtype=x.dtype),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def drop_path(x: torch.Tensor, rate: float, deterministic: bool = True,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-point stochastic depth; the identity when ``deterministic`` or at
    rate 0. The keep mask is drawn from ``generator`` (on ``x``'s device)."""
    if deterministic or rate == 0.0:
        return x
    # the keep probability in float32, rounded to x's dtype for the rescale,
    # as in JAX (host scalars: nothing is copied to the device)
    keep = torch.tensor(1.0, dtype=torch.float32) - rate
    if isinstance(generator, DropoutDraws) and generator.path_masks is not None:
        m = generator.next_path_mask((x.shape[0], 1)).to(x.device)
    else:
        if isinstance(generator, DropoutDraws):
            generator = generator.generator
        if generator is None:
            raise ValueError("stochastic depth needs an explicit torch.Generator")
        m = torch.rand((x.shape[0], 1), generator=generator, device=x.device) < keep.item()
    return torch.where(m, x / keep.to(x.dtype).item(),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def conv_weight(kernel_volume: int, c_in: int, c_out: int) -> nn.Parameter:
    """A ``(K, C_in, C_out)`` conv weight; `utils.weights.init_weights`
    fills it."""
    return nn.Parameter(torch.empty(kernel_volume, c_in, c_out))


class SubMConv(nn.Module):
    """Submanifold conv over a precomputed neighbor table.

    ``stem_mode`` picks the formulation of a k125 or k27 conv: ``"gather"``
    and ``"cond"`` run `subm_conv_apply`, ``"blocked"`` the stride-2 parity
    form through ``blocked_geom`` (27 or 8 block-row gathers, JAX's
    ``"blocked"``: exact only where no pooled level overflowed). JAX's
    ``"cond"`` takes the parity form where nothing overflowed and the
    gather elsewhere. Here ``"cond"`` always gathers: exact wherever the
    parity form is, it keeps no block rows for the backward and leaves one
    path; on an H100 the dual k5 stem's kernels are slower than the blocked
    products (half of its block-diagonal weight's products are on zeros).
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_volume: int,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel_volume = kernel_volume
        self.dtype = dtype
        self.weight = conv_weight(kernel_volume, in_channels, out_channels)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None

    def forward(self, feat, neighbor_idx, blocked_geom=None, stem_mode: str = "gather"):
        f = feat.to(self.dtype)
        mode = stem_mode if (blocked_geom is not None
                             and self.kernel_volume in (27, 125)) else "gather"
        if mode not in ("gather", "blocked", "cond"):
            raise ValueError(f"unknown conv mode {mode!r}")
        if mode != "blocked":
            return subm_conv_apply(f, neighbor_idx, self.weight, self.bias)
        grid_coord, pmask, parent_inverse, child_nbr = blocked_geom
        if self.kernel_volume == 27:
            return blocked_k3_conv_apply(
                f, self.weight, grid_coord=grid_coord, mask=pmask,
                parent_inverse=parent_inverse, child_nbr=child_nbr, bias=self.bias)
        out = blocked_subm_conv_apply(
            f, self.weight, grid_coord=grid_coord, mask=pmask,
            parent_inverse=parent_inverse, child_nbr=child_nbr,
        )
        return out if self.bias is None else out + self.bias.to(out.dtype)
