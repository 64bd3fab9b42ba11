"""Dual-branch Point Transformer V3 backbone.

Port of `cdsegnet_tpu/models/ptv3.py` in its unfused, unrolled schedule:
masked patch attention over the sorted arrays of a shared geometry pyramid,
xCPE and stem as submanifold convs over per-level neighbor tables, and the
`TransferModule` cross attention at the bottleneck. Submodules carry the
flax names (``n_enc0_block0``, ``tm_dec0``, ...) so that checkpoints map by
name (`cdsegnet_torch.utils.weights`).

In training mode (``nn.Module.train()``) the norms take batch statistics,
stochastic depth draws its masks from an explicit dropout generator, and the
pyramid's curves are shuffled with permutations drawn from a shuffle
generator, as the JAX module does with its ``dropout`` and ``shuffle`` rngs.

Layout knobs of the JAX module that only reschedule the same computation
(``scan_blocks``, ``fuse_dual_gathers``, ``remat_*``, ``pad_narrow_gathers``)
are accepted and ignored. The options: ``enable_rpe`` (a relative-position
bias, through the plain attention, as JAX computes it in XLA), ``proj_drop``
(dropout after each attention projection and in the MLPs, drawn from the
dropout generator), FreeU factors (``b_factor``/``s_factor``, n-decoder),
``tm_restomer``, ``tm_bidirectional``, gated ``tm_feat`` and ``xcpe_mode``
"blocked" (the parity-blocked k27 xCPE; the coarsest level always gathers).
``stem_mode`` and ``xcpe_mode`` "cond" compute the gather, exact wherever JAX's
"cond" would take the parity form (`SubMConv` says why, and what it costs).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cdsegnet_torch.models import pyramid as pyr
from cdsegnet_torch.models.modules import (
    Dense,
    LayerNorm,
    MaskedBatchNorm,
    Mlp,
    SubMConv,
    conv_weight,
    drop_path,
    dropout,
    swish,
)
from cdsegnet_torch.models.structure import PointBatch
from cdsegnet_torch.ops.attention import cross_patch_attention, patch_attention
from cdsegnet_torch.ops.flash_attention import attention_impl
from cdsegnet_torch.ops.subm_conv import blocked_stem_apply, dual_subm_conv_apply

DEFAULT_ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")

# JAX fields that only reschedule the same computation (scan/unroll, fused
# gathers, rematerialization, gather padding): accepted and ignored
LAYOUT_KNOBS = ("scan_blocks", "fuse_dual_gathers", "remat_blocks",
                "remat_policy", "pad_narrow_gathers")


class RPE(nn.Module):
    """Learned relative-position bias over clamped grid-coordinate deltas:
    one (3 * rpe_num, H) table whose rows for the three axes are summed."""

    def __init__(self, patch_size: int, num_heads: int):
        super().__init__()
        self.pos_bnd = int((4 * patch_size) ** (1 / 3) * 2)
        self.rpe_num = 2 * self.pos_bnd + 1
        self.rpe_table = nn.Parameter(torch.empty(3 * self.rpe_num, num_heads))

    def forward(self, rel_pos: torch.Tensor) -> torch.Tensor:
        """(P, K, K, 3) int deltas -> (P, H, K, K) float32 bias."""
        b = self.pos_bnd
        axis = torch.arange(3, device=rel_pos.device) * self.rpe_num
        idx = rel_pos.long().clamp(-b, b) + b + axis
        # an embedding lookup: its backward sums the many repeats of each
        # table row without serial runs
        out = F.embedding(idx, self.rpe_table).sum(dim=3)
        return out.permute(0, 3, 1, 2)


class SerializedAttention(nn.Module):
    """Self attention within serialized patches; with ``enable_rpe`` the
    logits take a relative-position bias (`RPE`)."""

    def __init__(self, channels: int, num_heads: int, patch_size: int,
                 order_index: int = 0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, proj_drop: float = 0.0,
                 enable_rpe: bool = False, upcast_softmax: bool = True,
                 use_pallas: Optional[bool] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.channels, self.num_heads, self.patch_size = channels, num_heads, patch_size
        self.order_index = order_index
        self.qk_scale = qk_scale
        self.proj_drop = proj_drop
        self.upcast_softmax = upcast_softmax
        self.use_pallas = use_pallas
        self.qkv = Dense(channels, 3 * channels, bias=qkv_bias, dtype=dtype)
        self.rpe = RPE(patch_size, num_heads) if enable_rpe else None
        self.proj = Dense(channels, channels, dtype=dtype)

    def forward(self, feat: torch.Tensor, point: PointBatch,
                generator=None) -> torch.Tensor:
        c, h = self.channels, self.num_heads
        d = c // h
        n = point.num_points
        k = min(self.patch_size, n)
        scale = self.qk_scale or d ** -0.5
        oi = self.order_index
        order = point.orders[oi]
        # gather features (width C) into serialized order before the qkv
        # projection: the row-wise Dense commutes with the permutation
        qkv = self.qkv(feat[order]).reshape(n, 3, h, d)
        q, kk, v = (qkv[:, i].contiguous() for i in range(3))
        bs, ms = point.batch_sorted[oi], point.mask_sorted[oi]
        if self.rpe is not None:
            # the biased attention is XLA in JAX, never the Pallas kernel:
            # the plain version is this path's one route on every device
            gc = point.grid_coord[order].reshape(n // k, k, 3)
            bias = self.rpe(gc[:, :, None] - gc[:, None, :])
            out = patch_attention(q, kk, v, bs, ms, k, scale,
                                  upcast_softmax=self.upcast_softmax, bias=bias)
        else:
            out = attention_impl(self.use_pallas)(
                q, kk, v, bs, ms, k, scale, upcast_softmax=self.upcast_softmax)
        feat = self.proj(out.reshape(n, c))[point.inverses[oi]]
        return dropout(feat, self.proj_drop, not self.training, generator)


class Block(nn.Module):
    """xCPE + (optional t injection) + prenorm attention + FFN. ``conv_mode``
    is the xCPE formulation where the level has a blocked operand
    ("gather", "blocked" or "cond", as `SubMConv`'s ``stem_mode``)."""

    def __init__(self, channels: int, num_heads: int, patch_size: int,
                 mlp_ratio: float = 4.0, order_index: int = 0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 proj_drop: float = 0.0, drop_path_rate: float = 0.0,
                 t_dim: int = -1, enable_rpe: bool = False,
                 upcast_softmax: bool = True, use_pallas: Optional[bool] = None,
                 conv_mode: str = "gather", dtype: torch.dtype = torch.float32):
        super().__init__()
        c = channels
        self.drop_path_rate = drop_path_rate
        self.conv_mode = conv_mode
        self.cpe_conv = SubMConv(c, c, 27, use_bias=True, dtype=dtype)
        self.cpe_fc = Dense(c, c, dtype=dtype)
        self.cpe_norm = LayerNorm(c, dtype=dtype)
        self.t_mlp = Dense(t_dim, c, dtype=dtype) if t_dim != -1 else None
        self.norm1 = LayerNorm(c, dtype=dtype)
        self.attn = SerializedAttention(
            c, num_heads, patch_size, order_index=order_index,
            qkv_bias=qkv_bias, qk_scale=qk_scale, proj_drop=proj_drop,
            enable_rpe=enable_rpe, upcast_softmax=upcast_softmax,
            use_pallas=use_pallas, dtype=dtype,
        )
        self.norm2 = LayerNorm(c, dtype=dtype)
        self.mlp = Mlp(c, int(c * mlp_ratio), c, drop=proj_drop, dtype=dtype)

    def forward(self, feat: torch.Tensor, point: PointBatch,
                t_emb: Optional[torch.Tensor] = None, generator=None,
                blocked=None) -> torch.Tensor:
        """``generator`` draws the stochastic-depth and dropout masks in
        training; ``blocked`` is the level's ``blocked_geom`` for the blocked
        xCPE, or None (the gather)."""
        det = not self.training
        f = self.cpe_norm(self.cpe_fc(self.cpe_conv(
            feat, point.neighbor_idx, blocked_geom=blocked, stem_mode=self.conv_mode)))
        feat = feat + f
        if self.t_mlp is not None and t_emb is not None:
            feat = feat + self.t_mlp(t_emb)
        f = self.attn(self.norm1(feat), point, generator)
        feat = feat + drop_path(f, self.drop_path_rate, det, generator)
        f = self.mlp(self.norm2(feat), generator)
        return feat + drop_path(f, self.drop_path_rate, det, generator)


class Embedding(nn.Module):
    """k5 submanifold stem + BN + GELU (single branch)."""

    def __init__(self, in_channels: int, embed_channels: int,
                 dtype: torch.dtype = torch.float32, stem_mode: str = "gather"):
        super().__init__()
        self.stem_mode = stem_mode
        self.stem_conv = SubMConv(in_channels, embed_channels, 125,
                                  use_bias=False, dtype=dtype)
        self.norm = MaskedBatchNorm(embed_channels, dtype=dtype)

    def forward(self, feat, mask, stem_neighbor, blocked_geom=None):
        f = self.stem_conv(feat, stem_neighbor, blocked_geom=blocked_geom,
                           stem_mode=self.stem_mode)
        return F.gelu(self.norm(f, mask))


class DualEmbedding(nn.Module):
    """Fused n+c stems: both branches share the k5 table, so one gather
    serves both (block-diagonal weights). ``stem_mode`` as in `SubMConv`:
    "gather" and "cond" run `dual_subm_conv_apply`, "blocked" the parity
    form (`blocked_stem_apply`)."""

    def __init__(self, n_in: int, c_in: int, n_embed: int, c_embed: int,
                 dtype: torch.dtype = torch.float32, stem_mode: str = "gather"):
        super().__init__()
        self.dtype = dtype
        self.stem_mode = stem_mode
        self.n_weight = conv_weight(125, n_in, n_embed)
        self.c_weight = conv_weight(125, c_in, c_embed)
        self.n_norm = MaskedBatchNorm(n_embed, dtype=dtype)
        self.c_norm = MaskedBatchNorm(c_embed, dtype=dtype)

    def forward(self, n_feat, c_feat, mask, stem_neighbor, blocked_geom=None):
        nf, cf = n_feat.to(self.dtype), c_feat.to(self.dtype)
        if self.stem_mode != "blocked" or blocked_geom is None:
            fn, fc = dual_subm_conv_apply(nf, cf, stem_neighbor,
                                          self.n_weight, self.c_weight)
        else:
            grid_coord, pmask, parent_inverse, child_nbr = blocked_geom
            fn, fc = blocked_stem_apply(
                nf, cf, self.n_weight, self.c_weight, grid_coord=grid_coord,
                mask=pmask, parent_inverse=parent_inverse, child_nbr=child_nbr,
            )
        return (F.gelu(self.n_norm(fn, mask)), F.gelu(self.c_norm(fc, mask)))


class PoolingProj(nn.Module):
    """proj -> segment max through the pyramid -> BN -> GELU."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Dense(in_channels, out_channels, dtype=dtype)
        self.norm = MaskedBatchNorm(out_channels, dtype=dtype)

    def forward(self, feat, levels: Sequence[pyr.Level], lo: int, hi: int,
                mask_out):
        f = self.proj(feat)
        for lv in range(lo + 1, hi + 1):
            f = pyr.pool_features(f, levels[lv], reduce="max")
        return F.gelu(self.norm(f, mask_out))


def fourier_filter(feat: torch.Tensor, threshold: int, scale: float) -> torch.Tensor:
    """FreeU skip-feature filter: FFT over (C, N) in float32, the centred
    low-frequency band of ``2 * threshold`` points scaled by ``scale``,
    inverse FFT. Padding rows enter the transform, as in JAX."""
    x = feat.float().t()[None]  # (1, C, N)
    dims = (-2, -1)
    xf = torch.fft.fftshift(torch.fft.fftn(x, dim=dims), dim=dims)
    n = x.shape[-1]
    crow = n // 2
    band = torch.ones(n, dtype=torch.float32, device=x.device)
    band[crow - threshold: crow + threshold] = scale
    out = torch.fft.ifftn(torch.fft.ifftshift(xf * band, dim=dims), dim=dims).real
    return out[0].t().to(feat.dtype)


def freeu_backbone_scale(feat: torch.Tensor, b: float) -> torch.Tensor:
    """FreeU backbone-feature scaling: the first C/2 channels times
    ``(b - 1) * m + 1``, m the channel mean of each row min-max normalised
    over all rows (padding rows included, as in JAX)."""
    x = feat.float()
    m = x.mean(dim=1, keepdim=True)  # (N, 1)
    m = (m - m.min()) / torch.clamp(m.max() - m.min(), min=1e-8)
    c_half = feat.shape[1] // 2
    scale = (b - 1.0) * m + 1.0
    return torch.cat([x[:, :c_half] * scale, x[:, c_half:]], dim=1).to(feat.dtype)


class UnpoolingProj(nn.Module):
    """proj / proj_skip (+BN+GELU each), then add or concat fusion; FreeU
    (`freeu_backbone_scale`, `fourier_filter`) when ``freeu_b`` or
    ``freeu_s`` is not 1."""

    def __init__(self, in_channels: int, skip_channels: int, out_channels: int,
                 mode: str = "add", skip_scale: float = 1.0,
                 freeu_b: float = 1.0, freeu_s: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if mode not in ("add", "cat"):
            raise ValueError(f"unknown skip mode {mode!r}")
        self.mode = mode
        self.skip_scale = skip_scale
        self.freeu_b, self.freeu_s = freeu_b, freeu_s
        self.proj = Dense(in_channels, out_channels, dtype=dtype)
        self.proj_norm = MaskedBatchNorm(out_channels, dtype=dtype)
        self.proj_skip = Dense(skip_channels, out_channels, dtype=dtype)
        self.skip_norm = MaskedBatchNorm(out_channels, dtype=dtype)
        self.proj_cat = (Dense(2 * out_channels, out_channels, dtype=dtype)
                         if mode == "cat" else None)

    def forward(self, feat, skip_feat, levels: Sequence[pyr.Level], hi: int,
                lo: int, mask_out):
        f = F.gelu(self.proj_norm(self.proj(feat), levels[hi].point.mask))
        s = F.gelu(self.skip_norm(self.proj_skip(skip_feat), mask_out))
        if self.skip_scale != 1.0:
            # the scale is rounded to the feature dtype first, as in JAX
            s = s * torch.tensor(self.skip_scale, dtype=s.dtype, device=s.device)
        if self.freeu_b != 1.0 or self.freeu_s != 1.0:
            f = freeu_backbone_scale(f, self.freeu_b)
            s = fourier_filter(s, threshold=1, scale=self.freeu_s)
        for lv in range(hi, lo, -1):
            f = pyr.unpool_features(f, levels[lv])
        if self.mode == "add":
            return s + f
        return self.proj_cat(torch.cat([s, f], dim=-1))


class CrossAttention(nn.Module):
    """Serialized cross attention: q from one branch, kv from the other."""

    def __init__(self, q_channels: int, kv_channels: int, num_heads: int,
                 patch_size: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, proj_drop: float = 0.0,
                 upcast_softmax: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.channels, self.num_heads, self.patch_size = q_channels, num_heads, patch_size
        self.qk_scale = qk_scale
        self.proj_drop = proj_drop
        self.upcast_softmax = upcast_softmax
        self.q = Dense(q_channels, q_channels, bias=qkv_bias, dtype=dtype)
        self.kv = Dense(kv_channels, 2 * q_channels, bias=qkv_bias, dtype=dtype)
        self.proj = Dense(q_channels, q_channels, dtype=dtype)

    def forward(self, q_feat, q_point: PointBatch, kv_feat, kv_point: PointBatch,
                generator=None, order_index: int = 0):
        c, h = self.channels, self.num_heads
        d = c // h
        n = q_point.num_points
        k = min(self.patch_size, n)
        scale = self.qk_scale or d ** -0.5
        oi = order_index
        q_s = self.q(q_feat[q_point.orders[oi]]).reshape(n, h, d)
        kv_s = self.kv(kv_feat[kv_point.orders[oi]]).reshape(-1, 2, h, d)
        out = cross_patch_attention(
            q_s, kv_s[:, 0], kv_s[:, 1],
            q_point.batch_sorted[oi], q_point.mask_sorted[oi],
            kv_point.batch_sorted[oi], kv_point.mask_sorted[oi],
            k, k, scale, upcast_softmax=self.upcast_softmax,
        )
        feat = self.proj(out.reshape(n, c))[q_point.inverses[oi]]
        return dropout(feat, self.proj_drop, not self.training, generator)


class CrossRestomer(nn.Module):
    """Restomer-style cross attention (``tm_restomer``): depthwise k3 convs
    over the rows in storage order, then the curve sort, and channel
    attention per head with L2-normalised q and k and a learned
    temperature. ``q_dw`` (3, 1, C) and ``kv_dw`` (3, 1, 2C) keep the flax
    layout."""

    def __init__(self, q_channels: int, kv_channels: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = q_channels
        self.channels, self.num_heads, self.dtype = c, num_heads, dtype
        self.q = Dense(q_channels, c, dtype=dtype)
        self.q_dw = conv_weight(3, 1, c)
        self.kv = Dense(kv_channels, 2 * c, dtype=dtype)
        self.kv_dw = conv_weight(3, 1, 2 * c)
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.proj = Dense(c, c, dtype=dtype)

    def _dwconv(self, x, w):
        # depthwise cross-correlation along the rows, zero padded: (N, C)
        c = x.shape[-1]
        y = F.conv1d(x.to(self.dtype).t()[None], w.to(self.dtype).permute(2, 1, 0),
                     padding=1, groups=c)
        return y[0].t()

    def forward(self, q_feat, q_point: PointBatch, kv_feat, kv_point: PointBatch,
                generator=None, order_index: int = 0):
        c, h = self.channels, self.num_heads
        n = q_point.num_points
        oi = order_index
        zero = torch.zeros((), dtype=q_feat.dtype, device=q_feat.device)
        qf = torch.where(q_point.mask[:, None], q_feat, zero)
        kvf = torch.where(kv_point.mask[:, None], kv_feat, zero.to(kv_feat.dtype))
        q = self._dwconv(self.q(qf), self.q_dw)[q_point.orders[oi]]
        kv = self._dwconv(self.kv(kvf), self.kv_dw)[kv_point.orders[oi]]
        k, v = kv[:, :c], kv[:, c:]
        d = c // h
        heads = lambda x: x.t().reshape(h, d, -1).float()  # (H, D, N)
        qh, kh, vh = heads(q), heads(k), heads(v)
        qh = qh / torch.clamp(qh.norm(dim=-1, keepdim=True), min=1e-6)
        kh = kh / torch.clamp(kh.norm(dim=-1, keepdim=True), min=1e-6)
        attn = torch.softmax(torch.einsum("hdn,hen->hde", qh, kh) * self.temperature,
                             dim=-1)
        out = torch.einsum("hde,hen->hdn", attn, vh).reshape(c, n).t().to(self.dtype)
        return self.proj(out)[q_point.inverses[oi]]


GATES = ("channel_scale", "b_channel_scale", "lr_scale", "b_lr_scale")


class CrossBlock(nn.Module):
    """CNF fusion block: per-branch xCPE, cross attention (or the Restomer)
    scaled by the constant ``tm_feat`` or by one of the learned `GATES`
    (``feat_scale``: per channel through a sigmoid, or one scalar; the
    ``b_`` forms also scale the shortcut by ``1 - g``), FFN."""

    def __init__(self, q_channels: int, kv_channels: int, num_heads: int,
                 patch_size: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, proj_drop: float = 0.0,
                 drop_path_rate: float = 0.0, tm_feat=1.0, tm_restomer: bool = False,
                 upcast_softmax: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        qc, kc = q_channels, kv_channels
        self.drop_path_rate = drop_path_rate
        if isinstance(tm_feat, str):
            if tm_feat not in GATES:
                raise ValueError(f"unknown tm_feat {tm_feat!r}: a number or one of {GATES}")
            self.tm_feat = tm_feat
            shape = (1, qc) if tm_feat.endswith("channel_scale") else (1,)
            self.feat_scale = nn.Parameter(torch.empty(shape))
        else:
            self.tm_feat = float(tm_feat)
        self.q_cpe_conv = SubMConv(qc, qc, 27, dtype=dtype)
        self.q_cpe_fc = Dense(qc, qc, dtype=dtype)
        self.q_cpe_norm = LayerNorm(qc, dtype=dtype)
        self.kv_cpe_conv = SubMConv(kc, kc, 27, dtype=dtype)
        self.kv_cpe_fc = Dense(kc, kc, dtype=dtype)
        self.kv_cpe_norm = LayerNorm(kc, dtype=dtype)
        self.q_norm1 = LayerNorm(qc, dtype=dtype)
        self.kv_norm1 = LayerNorm(kc, dtype=dtype)
        if tm_restomer:
            self.attn = CrossRestomer(qc, kc, num_heads, dtype=dtype)
        else:
            self.attn = CrossAttention(qc, kc, num_heads, patch_size,
                                       qkv_bias=qkv_bias, qk_scale=qk_scale,
                                       proj_drop=proj_drop,
                                       upcast_softmax=upcast_softmax, dtype=dtype)
        self.q_norm2 = LayerNorm(qc, dtype=dtype)
        self.mlp = Mlp(qc, int(qc * mlp_ratio), qc, drop=proj_drop, dtype=dtype)

    def forward(self, q_feat, q_point: PointBatch, kv_feat, kv_point: PointBatch,
                generator=None):
        det = not self.training
        q_short = q_feat + self.q_cpe_norm(self.q_cpe_fc(
            self.q_cpe_conv(q_feat, q_point.neighbor_idx)))
        kv_feat = kv_feat + self.kv_cpe_norm(self.kv_cpe_fc(
            self.kv_cpe_conv(kv_feat, kv_point.neighbor_idx)))
        kn = self.kv_norm1(kv_feat)
        a = self.attn(self.q_norm1(q_short), q_point, kn, kv_point, generator)
        a = drop_path(a, self.drop_path_rate, det, generator)
        if isinstance(self.tm_feat, str):
            g = self.feat_scale
            if self.tm_feat.endswith("channel_scale"):
                g = torch.sigmoid(g)
            g = g.to(a.dtype)
            short = (1.0 - g) * q_short if self.tm_feat.startswith("b_") else q_short
            q_feat = short + g * a
        else:
            q_feat = q_short + self.tm_feat * a
        f = self.mlp(self.q_norm2(q_feat), generator)
        q_feat = q_feat + drop_path(f, self.drop_path_rate, det, generator)
        # the kv branch leaves with its xCPE and norm1 applied, as the
        # reference mutates it in place
        return q_feat, kn


class TransferModule(nn.Module):
    """Bottleneck fusion: ``cross_block2`` has the n-branch query the
    c-branch; with ``bidirectional``, ``cross_block1`` first has the
    c-branch query the n-branch."""

    def __init__(self, q_channels: int, kv_channels: int, q_num_heads: int,
                 patch_size: int, kv_num_heads: Optional[int] = None,
                 bidirectional: bool = False, **kw):
        super().__init__()
        self.cross_block1 = (CrossBlock(kv_channels, q_channels, kv_num_heads,
                                        patch_size, **kw) if bidirectional else None)
        self.cross_block2 = CrossBlock(q_channels, kv_channels, q_num_heads,
                                       patch_size, **kw)

    def forward(self, c_feat, c_point, n_feat, n_point, generator=None):
        if self.cross_block1 is not None:
            c_feat, n_feat = self.cross_block1(c_feat, c_point, n_feat, n_point,
                                               generator)
        n_feat, c_feat = self.cross_block2(n_feat, n_point, c_feat, c_point,
                                           generator)
        return c_feat, n_feat


def _cumshift(strides: Sequence[int]) -> List[int]:
    """Cumulative bit shift per stage: (2,2,2,2) -> [0,1,2,3,4]."""
    out = [0]
    for s in strides:
        out.append(out[-1] + (s - 1).bit_length())
    return out


def _linspace(stop: float, num: int) -> List[float]:
    """``np.linspace(0, stop, num)`` as floats."""
    return [stop * i / (num - 1) if num > 1 else 0.0 for i in range(num)]


class PointTransformerV3(nn.Module):
    """Dual-branch PTv3, the CDSegNet backbone (fields as in JAX).

    ``capacity_div[k]`` is the slot-count divisor of pyramid level k relative
    to the level-0 bucket size (rounded up to a patch multiple).
    """

    def __init__(
        self,
        c_in_channels: int = 6,
        n_in_channels: int = 6,
        orders: Tuple[str, ...] = DEFAULT_ORDERS,
        c_stride: Tuple[int, ...] = (4, 4),
        c_enc_depths: Tuple[int, ...] = (2, 2, 2),
        c_enc_channels: Tuple[int, ...] = (32, 64, 128),
        c_enc_num_head: Tuple[int, ...] = (2, 4, 8),
        c_enc_patch_size: Tuple[int, ...] = (1024, 1024, 1024),
        c_dec_depths: Tuple[int, ...] = (2, 2),
        c_dec_channels: Tuple[int, ...] = (64, 64),
        c_dec_num_head: Tuple[int, ...] = (4, 4),
        c_dec_patch_size: Tuple[int, ...] = (1024, 1024),
        n_stride: Tuple[int, ...] = (2, 2, 2, 2),
        n_enc_depths: Tuple[int, ...] = (2, 2, 2, 6, 6),
        n_enc_channels: Tuple[int, ...] = (32, 64, 128, 256, 512),
        n_enc_num_head: Tuple[int, ...] = (2, 4, 8, 16, 32),
        n_enc_patch_size: Tuple[int, ...] = (1024, 1024, 1024, 1024, 1024),
        n_dec_depths: Tuple[int, ...] = (2, 2, 2, 2),
        n_dec_channels: Tuple[int, ...] = (64, 64, 128, 256),
        n_dec_num_head: Tuple[int, ...] = (4, 4, 8, 16),
        n_dec_patch_size: Tuple[int, ...] = (1024, 1024, 1024, 1024),
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        qk_scale: Optional[float] = None,
        proj_drop: float = 0.0,
        drop_path: float = 0.3,
        shuffle_orders: bool = True,
        upcast_softmax: bool = True,
        num_classes: int = 20,
        t_dim: int = 128,
        enable_rpe: bool = False,
        use_pallas: Optional[bool] = None,
        condition: bool = False,
        tm_bidirectional: bool = False,
        tm_feat=1.0,
        tm_restomer: bool = False,
        stem_mode: str = "cond",
        xcpe_mode: str = "gather",
        n_skip_mode: str = "add",
        c_skip_mode: str = "cat",
        c_skip_scale: float = (0.8 ** -1) * (2.0 ** -0.5),
        b_factor: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0),
        s_factor: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0),
        capacity_div: Tuple[int, ...] = (1, 2, 4, 16, 64),
        dtype: torch.dtype = torch.float32,
        **layout_knobs,
    ):
        super().__init__()
        unknown = set(layout_knobs) - set(LAYOUT_KNOBS)
        if unknown:
            raise TypeError(f"unknown PointTransformerV3 fields: {sorted(unknown)}")
        for name, mode in (("stem_mode", stem_mode), ("xcpe_mode", xcpe_mode)):
            if mode not in ("gather", "blocked", "cond"):
                raise ValueError(f"unknown {name} {mode!r}")
        if len(n_enc_depths) != len(n_stride) + 1:
            raise ValueError("n_enc_depths needs one more stage than n_stride")
        self.shuffle_orders = shuffle_orders  # permutes curves in training
        self.orders = tuple(orders)
        self.n_stride, self.c_stride = tuple(n_stride), tuple(c_stride)
        self.n_enc_depths, self.c_enc_depths = tuple(n_enc_depths), tuple(c_enc_depths)
        self.n_dec_depths, self.c_dec_depths = tuple(n_dec_depths), tuple(c_dec_depths)
        self.n_enc_patch_size = tuple(n_enc_patch_size)
        self.capacity_div = tuple(capacity_div)
        self.condition = condition
        self.num_classes = num_classes
        self.t_dim = t_dim
        self.stem_mode = stem_mode
        self.xcpe_mode = xcpe_mode
        self.n_shifts = _cumshift(n_stride)
        self.c_shifts = _cumshift(c_stride)
        if not set(self.c_shifts) <= set(self.n_shifts):
            raise ValueError("c-branch grids must be a subset of n-branch grids")
        n_orders = len(self.orders)
        common = dict(mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, qk_scale=qk_scale,
                      proj_drop=proj_drop, enable_rpe=enable_rpe,
                      upcast_softmax=upcast_softmax, use_pallas=use_pallas,
                      conv_mode=xcpe_mode, dtype=dtype)

        def blocks(name, depth, dp_rates, **kw):
            for i in range(depth):
                self.add_module(f"{name}{i}", Block(
                    order_index=i % n_orders, drop_path_rate=dp_rates[i],
                    **common, **kw))

        if condition and t_dim != -1:
            self.fc_t1 = Dense(t_dim, 4 * t_dim, dtype=dtype)
            self.fc_t2 = Dense(4 * t_dim, t_dim, dtype=dtype)
        if condition:
            self.dual_embedding = DualEmbedding(
                n_in_channels, c_in_channels, n_enc_channels[0],
                c_enc_channels[0], dtype=dtype, stem_mode=stem_mode)
        else:
            self.n_embedding = Embedding(n_in_channels, n_enc_channels[0],
                                         dtype=dtype, stem_mode=stem_mode)

        n_dp = _linspace(drop_path, sum(n_enc_depths))
        for s, depth in enumerate(n_enc_depths):
            if s > 0:
                self.add_module(f"n_enc{s}_down", PoolingProj(
                    n_enc_channels[s - 1], n_enc_channels[s], dtype=dtype))
            d0 = sum(n_enc_depths[:s])
            blocks(f"n_enc{s}_block", depth, n_dp[d0:d0 + depth],
                   channels=n_enc_channels[s], num_heads=n_enc_num_head[s],
                   patch_size=n_enc_patch_size[s])

        c_dp = _linspace(drop_path, sum(c_enc_depths))
        if condition:
            for s, depth in enumerate(c_enc_depths):
                if s > 0:
                    self.add_module(f"c_enc{s}_down", PoolingProj(
                        c_enc_channels[s - 1], c_enc_channels[s], dtype=dtype))
                d0 = sum(c_enc_depths[:s])
                blocks(f"c_enc{s}_block", depth, c_dp[d0:d0 + depth],
                       channels=c_enc_channels[s], num_heads=c_enc_num_head[s],
                       patch_size=c_enc_patch_size[s], t_dim=t_dim)
            self.tm_dec0 = TransferModule(
                n_enc_channels[-1], c_enc_channels[-1], n_enc_num_head[-1],
                n_enc_patch_size[-1], kv_num_heads=c_enc_num_head[-1],
                bidirectional=tm_bidirectional, mlp_ratio=mlp_ratio,
                qkv_bias=qkv_bias, qk_scale=qk_scale, proj_drop=proj_drop,
                drop_path_rate=c_dp[2] if len(c_dp) > 2 else 0.0,
                tm_feat=tm_feat, tm_restomer=tm_restomer,
                upcast_softmax=upcast_softmax, dtype=dtype)

        n_dec_ch = list(n_dec_channels) + [n_enc_channels[-1]]
        n_ddp = _linspace(drop_path, sum(n_dec_depths))
        for s in reversed(range(len(n_enc_depths) - 1)):
            self.add_module(f"n_dec{s}_up", UnpoolingProj(
                n_dec_ch[s + 1], n_enc_channels[s], n_dec_ch[s],
                mode=n_skip_mode, freeu_b=float(b_factor[s]),
                freeu_s=float(s_factor[s]), dtype=dtype))
            d0 = sum(n_dec_depths[:s])
            blocks(f"n_dec{s}_block", n_dec_depths[s],
                   n_ddp[d0:d0 + n_dec_depths[s]][::-1],
                   channels=n_dec_ch[s], num_heads=n_dec_num_head[s],
                   patch_size=n_dec_patch_size[s])
        self.n_head = Dense(n_dec_ch[0], num_classes)

        if condition:
            c_dec_ch = list(c_dec_channels) + [c_enc_channels[-1]]
            c_ddp = _linspace(drop_path, sum(c_dec_depths))
            for s in reversed(range(len(c_enc_depths) - 1)):
                self.add_module(f"c_dec{s}_up", UnpoolingProj(
                    c_dec_ch[s + 1], c_enc_channels[s], c_dec_ch[s],
                    mode=c_skip_mode, skip_scale=c_skip_scale, dtype=dtype))
                d0 = sum(c_dec_depths[:s])
                blocks(f"c_dec{s}_block", c_dec_depths[s],
                       c_ddp[d0:d0 + c_dec_depths[s]][::-1],
                       channels=c_dec_ch[s], num_heads=c_dec_num_head[s],
                       patch_size=c_dec_patch_size[s], t_dim=t_dim)
            self.c_head = Dense(c_dec_ch[0], c_in_channels)

    def precompute_geometry(self, point: PointBatch, exactness: str = "cond",
                            perms=None):
        """``(levels, stem_nbr)``: the geometry pyramid, a function of the
        point coordinates alone (see `pyramid.build_pyramid`); ``perms``
        shuffles each level's curves (`shuffle_perms`)."""
        n0 = point.num_points
        patch = max(self.n_enc_patch_size)
        caps = [pyr.round_up(max(n0 // d, patch), patch)
                for d in self.capacity_div[1:]]
        return pyr.build_pyramid(point, strides=self.n_stride, capacities=caps,
                                 orders=self.orders, stem_kernel=5,
                                 exactness=exactness, perms=perms)

    def shuffle_perms(self, generator: Optional[torch.Generator]):
        """One permutation of the curves per pyramid level, drawn from
        ``generator`` (a CPU generator), when training with
        ``shuffle_orders``; None (no shuffle) otherwise or without a
        generator, as JAX shuffles only when it has a ``shuffle`` rng."""
        if not (self.training and self.shuffle_orders) or generator is None:
            return None
        return [torch.randperm(len(self.orders), generator=generator).tolist()
                for _ in range(len(self.n_stride) + 1)]

    def _blocks(self, name, depth, feat, point, t_emb=None, generator=None,
                blocked=None):
        for i in range(depth):
            feat = getattr(self, f"{name}{i}")(feat, point, t_emb, generator, blocked)
        return feat

    def forward(self, n_point: PointBatch, c_feat: Optional[torch.Tensor] = None,
                t_emb: Optional[torch.Tensor] = None, geometry=None,
                return_c: bool = True,
                generator: Optional[torch.Generator] = None):
        """Returns ``(c_out, n_logits)`` with the c-branch (``c_out`` is None
        when ``return_c`` is False: the c-decoder is skipped), or
        ``n_logits`` alone without it. ``geometry`` optionally supplies a
        precomputed ``(levels, stem_nbr)``; otherwise it is built here, its
        curves unshuffled (the segmentors build the training pyramid). In
        training, ``generator`` (on the features' device, or a
        `modules.DropoutDraws`) draws the stochastic-depth and dropout
        masks."""
        levels, stem_nbr = (geometry if geometry is not None
                            else self.precompute_geometry(n_point))

        t = None
        if self.condition and self.t_dim != -1 and t_emb is not None:
            t = swish(self.fc_t2(swish(self.fc_t1(t_emb))))

        # operands of the blocked forms: level l's taps resolve in level
        # l+1's cluster structure (the stem's at level 0); None at the
        # coarsest level and wherever the conv gathers
        clustered = len(levels) > 1 and levels[1].parent_inverse is not None

        def blocked_geom(lv):
            return (levels[lv].point.grid_coord, levels[lv].point.mask,
                    levels[lv + 1].parent_inverse, levels[lv + 1].point.neighbor_idx)

        stem_geom = blocked_geom(0) if clustered and self.stem_mode == "blocked" else None
        xcpe = [None] * len(levels)
        if clustered and self.xcpe_mode == "blocked":
            xcpe = [blocked_geom(lv) for lv in range(len(levels) - 1)] + [None]
        mask0 = levels[0].point.mask
        if self.condition:
            if c_feat is None:
                raise ValueError("the dual-branch backbone needs c_feat")
            n_feat, c_feat = self.dual_embedding(
                n_point.feat, c_feat, mask0, stem_nbr, stem_geom)
        else:
            n_feat = self.n_embedding(n_point.feat, mask0, stem_nbr, stem_geom)

        # ---- n encoder ----
        n_skips = []
        for s, depth in enumerate(self.n_enc_depths):
            if s > 0:
                lo, hi = self.n_shifts[s - 1], self.n_shifts[s]
                n_feat = getattr(self, f"n_enc{s}_down")(
                    n_feat, levels, lo, hi, levels[hi].point.mask)
            n_feat = self._blocks(f"n_enc{s}_block", depth, n_feat,
                                  levels[self.n_shifts[s]].point, generator=generator,
                                  blocked=xcpe[self.n_shifts[s]])
            if s < len(self.n_enc_depths) - 1:
                n_skips.append(n_feat)

        c_t = t
        if self.condition:
            # ---- c encoder ----
            c_skips = []
            for s, depth in enumerate(self.c_enc_depths):
                if s > 0:
                    lo, hi = self.c_shifts[s - 1], self.c_shifts[s]
                    c_feat = getattr(self, f"c_enc{s}_down")(
                        c_feat, levels, lo, hi, levels[hi].point.mask)
                    if c_t is not None:  # t_emb pools by head gather
                        for lv in range(lo + 1, hi + 1):
                            c_t = pyr.pool_head_gather(c_t, levels[lv])
                c_feat = self._blocks(f"c_enc{s}_block", depth, c_feat,
                                      levels[self.c_shifts[s]].point, c_t, generator,
                                      xcpe[self.c_shifts[s]])
                if s < len(self.c_enc_depths) - 1:
                    c_skips.append(c_feat)
            # ---- transfer module at the bottleneck ----
            c_feat, n_feat = self.tm_dec0(
                c_feat, levels[self.c_shifts[-1]].point,
                n_feat, levels[self.n_shifts[-1]].point, generator)

        # ---- n decoder ----
        for s in reversed(range(len(self.n_enc_depths) - 1)):
            hi, lo = self.n_shifts[s + 1], self.n_shifts[s]
            n_feat = getattr(self, f"n_dec{s}_up")(
                n_feat, n_skips[s], levels, hi, lo, levels[lo].point.mask)
            n_feat = self._blocks(f"n_dec{s}_block", self.n_dec_depths[s],
                                  n_feat, levels[lo].point, generator=generator,
                                  blocked=xcpe[lo])
        n_logits = self.n_head(n_feat.float())
        if not self.condition:
            return n_logits
        if not return_c:
            return None, n_logits

        # ---- c decoder ----
        for s in reversed(range(len(self.c_enc_depths) - 1)):
            hi, lo = self.c_shifts[s + 1], self.c_shifts[s]
            c_feat = getattr(self, f"c_dec{s}_up")(
                c_feat, c_skips[s], levels, hi, lo, levels[lo].point.mask)
            if t is not None:
                # decoder blocks re-inject t pooled from full resolution
                c_t = t
                for lv in range(1, lo + 1):
                    c_t = pyr.pool_head_gather(c_t, levels[lv])
            c_feat = self._blocks(f"c_dec{s}_block", self.c_dec_depths[s],
                                  c_feat, levels[lo].point, c_t, generator, xcpe[lo])
        return self.c_head(c_feat.float()), n_logits
