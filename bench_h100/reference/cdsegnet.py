"""CDSegNet (the dual-branch PTv3 with the conditional noise framework) in
plain PyTorch: its parameters, the training loss of one step and single-step
inference (SSI).

Follows the published model (CVPR 2025, ``DefaultSegmentorV2`` over
``PT-v3m1`` with ``condition=True``): an n-branch PTv3 U-Net on the points'
color and normal; a shallower c-branch that takes the same features noised
at a timestep and its sinusoidal embedding, pools by the c-strides and
injects the embedding into each block; a transfer module at the bottleneck
in which the n-branch queries the c-branch; the n-head's logits and the
c-head's noise prediction. Training draws one timestep per scene, and the
loss is ``sqrt(MSE(noise) * (CE + Lovasz))`` (GLS). SSI feeds N(0, 1) at
t = T - 1 and reads the n-head. Submodule names are those of the measured
port, so one dict of weights serves both. Blocks are recomputed in the
backward pass (activation checkpointing) so that a float32 step of the full
model fits beside nothing else on one card.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench_h100.reference import geometry as geo
from bench_h100.reference.losses import gls_loss
from bench_h100.reference.nn import (
    Params, Precision, batch_norm, dense, layer_norm, patch_attention,
    segment_max, subm_conv)


def _cumshift(strides):
    out = [0]
    for s in strides:
        out.append(out[-1] + (s - 1).bit_length())
    return out


def _linspace(stop: float, num: int) -> List[float]:
    return [stop * i / (num - 1) if num > 1 else 0.0 for i in range(num)]


class Arch:
    """The sizes of one configuration's backbone (``model.backbone``)."""

    def __init__(self, model: Dict):
        b = model["backbone"]
        self.model = model
        self.orders = tuple(b["order"])
        self.n_stride, self.c_stride = tuple(b["n_stride"]), tuple(b["c_stride"])
        self.n_enc_depths, self.n_enc_ch = tuple(b["n_enc_depths"]), tuple(b["n_enc_channels"])
        self.n_enc_heads, self.n_patch = tuple(b["n_enc_num_head"]), tuple(b["n_enc_patch_size"])
        self.n_dec_depths, self.n_dec_heads = tuple(b["n_dec_depths"]), tuple(b["n_dec_num_head"])
        self.n_dec_ch = tuple(b["n_dec_channels"]) + (self.n_enc_ch[-1],)
        self.n_dec_patch = tuple(b["n_dec_patch_size"])
        self.c_enc_depths, self.c_enc_ch = tuple(b["c_enc_depths"]), tuple(b["c_enc_channels"])
        self.c_enc_heads, self.c_patch = tuple(b["c_enc_num_head"]), tuple(b["c_enc_patch_size"])
        self.c_dec_depths, self.c_dec_heads = tuple(b["c_dec_depths"]), tuple(b["c_dec_num_head"])
        self.c_dec_ch = tuple(b["c_dec_channels"]) + (self.c_enc_ch[-1],)
        self.c_dec_patch = tuple(b["c_dec_patch_size"])
        self.mlp_ratio = b["mlp_ratio"]
        self.drop_path = b["drop_path"]
        self.t_dim = b["T_dim"]
        self.c_in, self.n_in = b["c_in_channels"], b["n_in_channels"]
        self.num_classes = b["num_classes"]
        self.capacity_div = tuple(b.get("capacity_div", (1, 2, 4, 16, 64)))
        self.tm_feat = float(b.get("tm_feat", 1.0))
        self.c_skip_scale = 0.8 ** -1 * (2.0 ** -0.5 if b.get("skip_connection_scale", True) else 1.0)
        self.n_shifts, self.c_shifts = _cumshift(self.n_stride), _cumshift(self.c_stride)
        self.T = model["T"]
        if b.get("skip_connection_mode", "cat") != "cat" or b.get("tm_bidirectional"):
            raise NotImplementedError("the reference takes skip mode 'cat', one-way transfer")

    def capacities(self, n0: int) -> List[int]:
        patch = max(self.n_patch)
        return [-(-max(n0 // d, patch) // patch) * patch for d in self.capacity_div[1:]]

    def blocks(self, train: bool):
        """Every attention block in forward order: (name, level, channels,
        heads, patch, has_t, drop_path rate, curve)."""
        out = []
        n_dp = _linspace(self.drop_path, sum(self.n_enc_depths))
        for s, depth in enumerate(self.n_enc_depths):
            d0 = sum(self.n_enc_depths[:s])
            for i in range(depth):
                out.append((f"n_enc{s}_block{i}", self.n_shifts[s], self.n_enc_ch[s],
                            self.n_enc_heads[s], self.n_patch[s], False, n_dp[d0 + i], i))
        c_dp = _linspace(self.drop_path, sum(self.c_enc_depths))
        for s, depth in enumerate(self.c_enc_depths):
            d0 = sum(self.c_enc_depths[:s])
            for i in range(depth):
                out.append((f"c_enc{s}_block{i}", self.c_shifts[s], self.c_enc_ch[s],
                            self.c_enc_heads[s], self.c_patch[s], True, c_dp[d0 + i], i))
        n_ddp = _linspace(self.drop_path, sum(self.n_dec_depths))
        for s in reversed(range(len(self.n_enc_depths) - 1)):
            d0 = sum(self.n_dec_depths[:s])
            rates = n_ddp[d0:d0 + self.n_dec_depths[s]][::-1]
            for i in range(self.n_dec_depths[s]):
                out.append((f"n_dec{s}_block{i}", self.n_shifts[s], self.n_dec_ch[s],
                            self.n_dec_heads[s], self.n_dec_patch[s], False, rates[i], i))
        if train:
            c_ddp = _linspace(self.drop_path, sum(self.c_dec_depths))
            for s in reversed(range(len(self.c_enc_depths) - 1)):
                d0 = sum(self.c_dec_depths[:s])
                rates = c_ddp[d0:d0 + self.c_dec_depths[s]][::-1]
                for i in range(self.c_dec_depths[s]):
                    out.append((f"c_dec{s}_block{i}", self.c_shifts[s], self.c_dec_ch[s],
                                self.c_dec_heads[s], self.c_dec_patch[s], True, rates[i], i))
        return out

    def tm_rate(self) -> float:
        c_dp = _linspace(self.drop_path, sum(self.c_enc_depths))
        return c_dp[2] if len(c_dp) > 2 else 0.0

    def drop_sites(self) -> List[Tuple[str, int, float]]:
        """The stochastic-depth draws of a training forward, in the order
        the model makes them: (site, level, rate)."""
        sites = []
        blocks = self.blocks(train=True)
        n_enc = sum(self.n_enc_depths) + sum(self.c_enc_depths)

        def add(block_list):
            for name, lv, _, _, _, _, rate, _ in block_list:
                if rate > 0:
                    sites.extend([(f"{name}.attn", lv, rate), (f"{name}.mlp", lv, rate)])

        add(blocks[:n_enc])
        if self.tm_rate() > 0:
            lv = self.n_shifts[-1]
            sites += [("tm_dec0.attn", lv, self.tm_rate()), ("tm_dec0.mlp", lv, self.tm_rate())]
        add(blocks[n_enc:])
        return sites


def param_shapes(arch: Arch) -> Dict[str, Tuple[int, ...]]:
    """Every parameter and BatchNorm statistic, by the port's name."""
    out: Dict[str, Tuple[int, ...]] = {}

    def lin(name, i, o, bias=True):
        out[f"backbone.{name}.weight"] = (o, i)
        if bias:
            out[f"backbone.{name}.bias"] = (o,)

    def norm(name, c, bn=False):
        out[f"backbone.{name}.scale"] = (c,)
        out[f"backbone.{name}.bias"] = (c,)
        if bn:
            out[f"backbone.{name}.mean"] = (c,)
            out[f"backbone.{name}.var"] = (c,)

    def conv(name, k, i, o, bias=True):
        out[f"backbone.{name}.weight"] = (k, i, o)
        if bias:
            out[f"backbone.{name}.bias"] = (o,)

    t = arch.t_dim
    lin("fc_t1", t, 4 * t)
    lin("fc_t2", 4 * t, t)
    out["backbone.dual_embedding.n_weight"] = (125, arch.n_in, arch.n_enc_ch[0])
    out["backbone.dual_embedding.c_weight"] = (125, arch.c_in, arch.c_enc_ch[0])
    norm("dual_embedding.n_norm", arch.n_enc_ch[0], bn=True)
    norm("dual_embedding.c_norm", arch.c_enc_ch[0], bn=True)
    for s in range(1, len(arch.n_enc_depths)):
        lin(f"n_enc{s}_down.proj", arch.n_enc_ch[s - 1], arch.n_enc_ch[s])
        norm(f"n_enc{s}_down.norm", arch.n_enc_ch[s], bn=True)
    for s in range(1, len(arch.c_enc_depths)):
        lin(f"c_enc{s}_down.proj", arch.c_enc_ch[s - 1], arch.c_enc_ch[s])
        norm(f"c_enc{s}_down.norm", arch.c_enc_ch[s], bn=True)
    for name, _, c, _, _, has_t, _, _ in arch.blocks(train=True):
        conv(f"{name}.cpe_conv", 27, c, c)
        lin(f"{name}.cpe_fc", c, c)
        norm(f"{name}.cpe_norm", c)
        if has_t:
            lin(f"{name}.t_mlp", t, c)
        norm(f"{name}.norm1", c)
        lin(f"{name}.attn.qkv", c, 3 * c)
        lin(f"{name}.attn.proj", c, c)
        norm(f"{name}.norm2", c)
        hidden = int(c * arch.mlp_ratio)
        lin(f"{name}.mlp.fc1", c, hidden)
        lin(f"{name}.mlp.fc2", hidden, c)
    qc, kc = arch.n_enc_ch[-1], arch.c_enc_ch[-1]
    tm = "tm_dec0.cross_block2"
    conv(f"{tm}.q_cpe_conv", 27, qc, qc)
    lin(f"{tm}.q_cpe_fc", qc, qc)
    norm(f"{tm}.q_cpe_norm", qc)
    conv(f"{tm}.kv_cpe_conv", 27, kc, kc)
    lin(f"{tm}.kv_cpe_fc", kc, kc)
    norm(f"{tm}.kv_cpe_norm", kc)
    norm(f"{tm}.q_norm1", qc)
    norm(f"{tm}.kv_norm1", kc)
    lin(f"{tm}.attn.q", qc, qc)
    lin(f"{tm}.attn.kv", kc, 2 * qc)
    lin(f"{tm}.attn.proj", qc, qc)
    norm(f"{tm}.q_norm2", qc)
    lin(f"{tm}.mlp.fc1", qc, int(qc * arch.mlp_ratio))
    lin(f"{tm}.mlp.fc2", int(qc * arch.mlp_ratio), qc)
    for s in reversed(range(len(arch.n_enc_depths) - 1)):
        o = arch.n_dec_ch[s]
        lin(f"n_dec{s}_up.proj", arch.n_dec_ch[s + 1], o)
        norm(f"n_dec{s}_up.proj_norm", o, bn=True)
        lin(f"n_dec{s}_up.proj_skip", arch.n_enc_ch[s], o)
        norm(f"n_dec{s}_up.skip_norm", o, bn=True)
    lin("n_head", arch.n_dec_ch[0], arch.num_classes)
    for s in reversed(range(len(arch.c_enc_depths) - 1)):
        o = arch.c_dec_ch[s]
        lin(f"c_dec{s}_up.proj", arch.c_dec_ch[s + 1], o)
        norm(f"c_dec{s}_up.proj_norm", o, bn=True)
        lin(f"c_dec{s}_up.proj_skip", arch.c_enc_ch[s], o)
        norm(f"c_dec{s}_up.skip_norm", o, bn=True)
        lin(f"c_dec{s}_up.proj_cat", 2 * o, o)
    lin("c_head", arch.c_dec_ch[0], arch.c_in)
    return out


# ---------------------------------------------------------------------------
# the diffusion schedule


def alpha_bar(T: int, start: float, stop: float) -> np.ndarray:
    """The cosine schedule's cumulative products (float32), evaluated at
    ``linspace(start, stop, T + 1) / T`` as the recipe's beta bounds give."""
    t = np.linspace(start, stop, T + 1, dtype=np.float64) / T
    ac = np.cos((t + 0.008) / 1.008 * math.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = np.clip(1.0 - ac[1:] / ac[:-1], 0.0, 0.999)
    return np.cumprod(1.0 - betas).astype(np.float32)


def t_embedding(ts: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=ts.device)
                      * (-math.log(10000.0) / (half - 1)))
    ang = ts.float()[:, None] * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], 1)


# ---------------------------------------------------------------------------
# the forward


class Forward:
    """One forward pass of the backbone over a pyramid ``levels``
    (`geometry.build`) with weights ``P``; ``masks`` maps a stochastic-depth
    site to its keep mask (training)."""

    def __init__(self, arch: Arch, P: Params, levels, prec: Precision, train: bool,
                 masks: Optional[Dict[str, torch.Tensor]] = None, recompute: bool = False):
        self.a, self.P, self.levels, self.prec, self.train = arch, P, levels, prec, train
        self.masks = masks or {}
        self.recompute = recompute

    def dense(self, name, x):
        return dense(self.P, f"backbone.{name}", x, self.prec)

    def ln(self, name, x):
        return layer_norm(self.P, f"backbone.{name}", x)

    def bn(self, name, x, mask):
        return batch_norm(self.P, f"backbone.{name}", x, mask, self.train)

    def conv(self, name, x, nbr):
        return subm_conv(x, nbr, self.P[f"backbone.{name}.weight"],
                         self.P.get(f"backbone.{name}.bias"), self.prec)

    def drop(self, site, x, rate):
        if not self.train or rate == 0:
            return x
        return torch.where(self.masks[site], x / (1.0 - rate), torch.zeros_like(x))

    def attend(self, prefix, q_in, kv_in, lv, heads, patch, curve):
        """Self attention (``kv_in`` None: one qkv) or the transfer's cross
        attention, along ``curve`` of level ``lv``; back in slot order."""
        L = self.levels[lv]
        n, c = q_in.shape[0], q_in.shape[1]
        d = c // heads
        o = L["order"][curve]
        b, m = geo.sorted_view(L, curve)
        if kv_in is None:
            qkv = self.dense(f"{prefix}.qkv", q_in.index_select(0, o)).reshape(n, 3, heads, d)
            q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        else:
            q = self.dense(f"{prefix}.q", q_in.index_select(0, o)).reshape(n, heads, d)
            kv = self.dense(f"{prefix}.kv", kv_in.index_select(0, o)).reshape(n, 2, heads, d)
            k, v = kv[:, 0], kv[:, 1]
        out = patch_attention(q, k, v, b, m, b, m, min(patch, n), d ** -0.5, self.prec)
        return self.dense(f"{prefix}.proj", out.reshape(n, c)).index_select(0, L["inverse"][curve])

    def mlp(self, prefix, x):
        return self.dense(f"{prefix}.fc2", F.gelu(self.dense(f"{prefix}.fc1", x)))

    def block(self, spec, feat, t):
        name, lv, c, heads, patch, has_t, rate, i = spec

        def run(feat, t):
            L = self.levels[lv]
            feat = feat + self.ln(f"{name}.cpe_norm", self.dense(
                f"{name}.cpe_fc", self.conv(f"{name}.cpe_conv", feat, L["nbr"])))
            if has_t:
                feat = feat + self.dense(f"{name}.t_mlp", t)
            f = self.attend(f"{name}.attn", self.ln(f"{name}.norm1", feat), None, lv, heads,
                            patch, i % len(self.a.orders))
            feat = feat + self.drop(f"{name}.attn", f, rate)
            f = self.mlp(f"{name}.mlp", self.ln(f"{name}.norm2", feat))
            return feat + self.drop(f"{name}.mlp", f, rate)

        if self.recompute and torch.is_grad_enabled():
            return checkpoint(run, feat, t, use_reentrant=False)
        return run(feat, t)

    def pool_max(self, x, lv):
        L = self.levels[lv]
        return segment_max(x, L["parent_slot"], L["parent_valid"], L["coord"].shape[0])

    def unpool(self, x, lv):
        L = self.levels[lv]
        safe = torch.where(L["mask"][:, None], x, torch.zeros_like(x))
        return safe.index_select(0, L["parent_slot"])

    def head_gather(self, x, lv):
        L = self.levels[lv]
        return torch.where(L["mask"][:, None], x.index_select(0, L["head"]), torch.zeros_like(x[:1]))

    def down(self, name, x, lo, hi):
        f = self.dense(f"{name}.proj", x)
        for lv in range(lo + 1, hi + 1):
            f = self.pool_max(f, lv)
        return F.gelu(self.bn(f"{name}.norm", f, self.levels[hi]["mask"]))

    def up(self, name, x, skip, hi, lo, scale=None):
        f = F.gelu(self.bn(f"{name}.proj_norm", self.dense(f"{name}.proj", x),
                           self.levels[hi]["mask"]))
        s = F.gelu(self.bn(f"{name}.skip_norm", self.dense(f"{name}.proj_skip", skip),
                           self.levels[lo]["mask"]))
        for lv in range(hi, lo, -1):
            f = self.unpool(f, lv)
        if scale is None:
            return s + f
        return self.dense(f"{name}.proj_cat", torch.cat([s * scale, f], -1))

    def transfer(self, n_feat, c_feat):
        a, lv = self.a, self.a.n_shifts[-1]
        nbr = self.levels[lv]["nbr"]
        tm = "tm_dec0.cross_block2"
        q_short = n_feat + self.ln(f"{tm}.q_cpe_norm", self.dense(
            f"{tm}.q_cpe_fc", self.conv(f"{tm}.q_cpe_conv", n_feat, nbr)))
        kv = c_feat + self.ln(f"{tm}.kv_cpe_norm", self.dense(
            f"{tm}.kv_cpe_fc", self.conv(f"{tm}.kv_cpe_conv", c_feat, nbr)))
        kn = self.ln(f"{tm}.kv_norm1", kv)
        att = self.attend(f"{tm}.attn", self.ln(f"{tm}.q_norm1", q_short), kn, lv,
                          a.n_enc_heads[-1], a.n_patch[-1], 0)
        q = q_short + a.tm_feat * self.drop("tm_dec0.attn", att, a.tm_rate())
        f = self.mlp(f"{tm}.mlp", self.ln(f"{tm}.q_norm2", q))
        return q + self.drop("tm_dec0.mlp", f, a.tm_rate()), kn

    def __call__(self, feat, c_feat, t_emb, return_c: bool):
        a = self.a
        L0 = self.levels[0]
        t = F.silu(self.dense("fc_t2", F.silu(self.dense("fc_t1", t_emb))))
        stem = L0["stem"]
        n = F.gelu(self.bn("dual_embedding.n_norm", subm_conv(
            feat, stem, self.P["backbone.dual_embedding.n_weight"], None, self.prec), L0["mask"]))
        c = F.gelu(self.bn("dual_embedding.c_norm", subm_conv(
            c_feat, stem, self.P["backbone.dual_embedding.c_weight"], None, self.prec),
            L0["mask"]))
        specs = {s[0]: s for s in a.blocks(self.train and return_c)}
        n_skips = []
        for s, depth in enumerate(a.n_enc_depths):
            if s:
                n = self.down(f"n_enc{s}_down", n, a.n_shifts[s - 1], a.n_shifts[s])
            for i in range(depth):
                n = self.block(specs[f"n_enc{s}_block{i}"], n, None)
            if s < len(a.n_enc_depths) - 1:
                n_skips.append(n)
        c_t, c_skips = t, []
        for s, depth in enumerate(a.c_enc_depths):
            if s:
                lo, hi = a.c_shifts[s - 1], a.c_shifts[s]
                c = self.down(f"c_enc{s}_down", c, lo, hi)
                for lv in range(lo + 1, hi + 1):
                    c_t = self.head_gather(c_t, lv)
            for i in range(depth):
                c = self.block(specs[f"c_enc{s}_block{i}"], c, c_t)
            if s < len(a.c_enc_depths) - 1:
                c_skips.append(c)
        n, c = self.transfer(n, c)
        for s in reversed(range(len(a.n_enc_depths) - 1)):
            n = self.up(f"n_dec{s}_up", n, n_skips[s], a.n_shifts[s + 1], a.n_shifts[s])
            for i in range(a.n_dec_depths[s]):
                n = self.block(specs[f"n_dec{s}_block{i}"], n, None)
        logits = self.dense("n_head", n)
        if not return_c:
            return None, logits
        for s in reversed(range(len(a.c_enc_depths) - 1)):
            hi, lo = a.c_shifts[s + 1], a.c_shifts[s]
            c = self.up(f"c_dec{s}_up", c, c_skips[s], hi, lo, scale=a.c_skip_scale)
            c_t = t
            for lv in range(1, lo + 1):
                c_t = self.head_gather(c_t, lv)
            for i in range(a.c_dec_depths[s]):
                c = self.block(specs[f"c_dec{s}_block{i}"], c, c_t)
        return self.dense("c_head", c), logits


def pyramid(arch: Arch, bucket: Dict[str, torch.Tensor], num_scenes: int, depth: int,
            perms=None):
    return geo.build(bucket["coord"], bucket["grid_coord"], bucket["mask"], bucket["batch"],
                     num_scenes, depth, arch.capacities(bucket["coord"].shape[0]),
                     arch.orders, perms)


def train_loss(arch: Arch, P: Params, bucket: Dict[str, torch.Tensor], draws: Dict,
               num_scenes: int, depth: int, prec: Precision) -> torch.Tensor:
    """The loss of one training forward on ``bucket`` with the injected
    ``draws``: ``ts_scene``, ``noise``, ``mse_valid``, ``perms`` and
    ``path_masks`` (keep masks in the order of `Arch.drop_sites`)."""
    levels = pyramid(arch, bucket, num_scenes, depth, draws["perms"])
    sites = arch.drop_sites()
    masks = draws["path_masks"]
    if len(masks) != len(sites):
        raise ValueError(f"{len(masks)} stochastic-depth masks for {len(sites)} sites")
    named = {}
    for (site, lv, _), m in zip(sites, masks):
        if m.shape[0] != levels[lv]["coord"].shape[0]:
            raise ValueError(f"mask of {m.shape[0]} rows at {site} (level of "
                             f"{levels[lv]['coord'].shape[0]})")
        named[site] = m
    mask, batch = bucket["mask"], bucket["batch"].long()
    seg_valid = mask & (bucket["segment"] >= 0)
    ab = torch.as_tensor(alpha_bar(arch.T, arch.model["beta_start"], arch.model["beta_end"]),
                         device=mask.device)
    ts = draws["ts_scene"].long()
    ts_pt = ts[batch.clamp(0, num_scenes - 1)]
    abt = ab[ts_pt][:, None]
    x0 = bucket["feat"]
    c_feat = torch.sqrt(abt) * x0 + torch.sqrt(1.0 - abt) * draws["noise"]
    t_emb = t_embedding(ts, arch.t_dim)[batch.clamp(0, num_scenes - 1)]
    fwd = Forward(arch, P, levels, prec, train=True, masks=named, recompute=True)
    c_pred, logits = fwd(x0, c_feat, t_emb, return_c=True)
    return gls_loss(c_pred, draws["noise"], draws["mse_valid"], logits, bucket["segment"],
                    seg_valid)


@torch.no_grad()
def ssi_logits(arch: Arch, P: Params, bucket: Dict[str, torch.Tensor], noise: torch.Tensor,
               depth: int, prec: Precision) -> torch.Tensor:
    """Single-step inference of one fragment (one scene): the n-head's
    logits (N, classes) from the c-branch fed ``noise`` at t = T - 1."""
    levels = pyramid(arch, bucket, 1, depth)
    n = bucket["coord"].shape[0]
    ts = torch.full((1,), arch.T - 1, dtype=torch.long, device=noise.device)
    t_emb = t_embedding(ts, arch.t_dim).expand(n, -1)
    fwd = Forward(arch, P, levels, prec, train=False)
    return fwd(bucket["feat"], noise, t_emb, return_c=False)[1]


def forward_flops(arch: Arch, stats: Sequence[Dict], train: bool) -> float:
    """Multiply-add FLOPs (2 per product) of one forward that the inputs
    need: products over valid points, existing neighbors and allowed
    attention pairs (`geometry.level_stats`); SSI skips the c-decoder."""
    v = [s["valid"] for s in stats]
    e3 = [s["k3_pairs"] for s in stats]
    fl = 2.0 * v[0] * (arch.t_dim * 4 * arch.t_dim * 2)
    fl += 2.0 * stats[0]["k5_pairs"] * (arch.n_in * arch.n_enc_ch[0] + arch.c_in * arch.c_enc_ch[0])
    for name, lv, c, heads, patch, has_t, _, _ in arch.blocks(train):
        hid = int(c * arch.mlp_ratio)
        fl += 2.0 * e3[lv] * c * c + 2.0 * v[lv] * (c * c + 3 * c * c + c * c + 2 * c * hid)
        fl += 4.0 * c * stats[lv]["attn_pairs"]
        if has_t:
            fl += 2.0 * v[lv] * arch.t_dim * c
    for s in range(1, len(arch.n_enc_depths)):
        fl += 2.0 * v[arch.n_shifts[s - 1]] * arch.n_enc_ch[s - 1] * arch.n_enc_ch[s]
    for s in range(1, len(arch.c_enc_depths)):
        fl += 2.0 * v[arch.c_shifts[s - 1]] * arch.c_enc_ch[s - 1] * arch.c_enc_ch[s]
    lv, qc, kc = arch.n_shifts[-1], arch.n_enc_ch[-1], arch.c_enc_ch[-1]
    fl += 2.0 * e3[lv] * (qc * qc + kc * kc) + 2.0 * v[lv] * (
        qc * qc + kc * kc + qc * qc + kc * 2 * qc + qc * qc + 2 * qc * int(qc * arch.mlp_ratio))
    fl += 4.0 * qc * stats[lv]["attn_pairs"]
    for s in range(len(arch.n_enc_depths) - 1):
        hi, lo, o = arch.n_shifts[s + 1], arch.n_shifts[s], arch.n_dec_ch[s]
        fl += 2.0 * v[hi] * arch.n_dec_ch[s + 1] * o + 2.0 * v[lo] * arch.n_enc_ch[s] * o
    fl += 2.0 * v[0] * arch.n_dec_ch[0] * arch.num_classes
    if train:
        for s in range(len(arch.c_enc_depths) - 1):
            hi, lo, o = arch.c_shifts[s + 1], arch.c_shifts[s], arch.c_dec_ch[s]
            fl += 2.0 * v[hi] * arch.c_dec_ch[s + 1] * o + 2.0 * v[lo] * (
                arch.c_enc_ch[s] * o + 2 * o * o)
        fl += 2.0 * v[0] * arch.c_dec_ch[0] * arch.c_in
    return fl


def attention_calls(arch: Arch, train: bool) -> List[Tuple[int, int, int, int]]:
    """The patch-attention kernel calls of one forward: (level, channels,
    heads, patch). The transfer's cross attention is not among them."""
    return [(lv, c, h, p) for _, lv, c, h, p, _, _, _ in arch.blocks(train)]


def train_draws(arch: Arch, bucket: Dict[str, torch.Tensor], num_scenes: int,
                seed: int, per_scene: int = 8192) -> Dict:
    """The random draws of one training step, from ``seed``, on the
    bucket's device: a timestep per scene, the c-branch noise, about
    ``per_scene`` labelled points per scene for the MSE term, a shuffle of
    the curves per level and a keep mask per stochastic-depth site."""
    dev = bucket["coord"].device
    g = torch.Generator(dev).manual_seed(seed)
    n = bucket["coord"].shape[0]
    sizes = [n] + arch.capacities(n)
    ts = torch.randint(0, arch.T, (num_scenes,), generator=g, device=dev)
    noise = torch.randn((n, arch.c_in), generator=g, device=dev)
    seg_valid = bucket["mask"] & (bucket["segment"] >= 0)
    scene = bucket["batch"].long().clamp(0, num_scenes - 1)
    cnt = torch.zeros(num_scenes, device=dev).index_add_(0, scene, seg_valid.float())
    rate = (per_scene / cnt.clamp(min=1.0)).clamp(max=1.0)
    mse_valid = seg_valid & (torch.rand(n, generator=g, device=dev) < rate[scene])
    masks = [torch.rand((sizes[lv], 1), generator=g, device=dev) < 1.0 - r
             for _, lv, r in arch.drop_sites()]
    cpu = torch.Generator().manual_seed(seed)
    perms = [torch.randperm(len(arch.orders), generator=cpu).tolist() for _ in sizes]
    return dict(ts_scene=ts, noise=noise, mse_valid=mse_valid, perms=perms, path_masks=masks)
