"""SpUNet-v1m1 (Pointcept's ``SpUNetBase``) in plain PyTorch: its
parameters, the training loss and the forward.

A U-Net of submanifold ResNet blocks: a 5x5x5 stem, four stride-2 stages
(a projection, then the maximum over each 2x2x2 cell, BatchNorm, ReLU, then
3x3x3 basic blocks), four decoder stages (a projection broadcast back to the
finer cells, concatenated with the skip and fused), a linear head, and
cross-entropy over the labelled points. The pyramid has one curve (z-order)
and no shuffle. Names are those of the measured port.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from bench_h100.reference import geometry as geo
from bench_h100.reference.losses import cross_entropy
from bench_h100.reference.nn import Params, Precision, batch_norm, dense, segment_max, subm_conv


class Arch:
    def __init__(self, model: Dict):
        b = model["backbone"]
        self.model = model
        self.in_ch, self.num_classes = b["in_channels"], b["num_classes"]
        self.base = b["base_channels"]
        self.channels, self.layers = tuple(b["channels"]), tuple(b["layers"])
        self.stages = len(self.channels) // 2
        self.capacity_div = tuple(b["capacity_div"])
        self.orders = tuple(b.get("orders", ("z",)))
        self.enc_in = [self.base] + list(self.channels[:self.stages])

    def capacities(self, n0: int):
        return [-(-max(n0 // d, 8) // 8) * 8 for d in self.capacity_div[1:self.stages + 1]]

    def dec(self):
        """(stage, decoder index, in channels, out channels), coarse first."""
        out, c_in = [], self.channels[self.stages - 1]
        for s in reversed(range(self.stages)):
            j = self.stages + (self.stages - 1 - s)
            out.append((s, j, c_in, self.channels[j]))
            c_in = self.channels[j]
        return out


def param_shapes(arch: Arch) -> Dict[str, Tuple[int, ...]]:
    out: Dict[str, Tuple[int, ...]] = {}

    def bn(name, c):
        for k in ("scale", "bias", "mean", "var"):
            out[f"backbone.{name}.{k}"] = (c,)

    def lin(name, i, o):
        out[f"backbone.{name}.weight"] = (o, i)
        out[f"backbone.{name}.bias"] = (o,)

    def blocks(prefix, c, n):
        for i in range(n):
            for j in (1, 2):
                out[f"backbone.{prefix}_block{i}.conv{j}.weight"] = (27, c, c)
                bn(f"{prefix}_block{i}.bn{j}", c)

    out["backbone.stem_conv.weight"] = (125, arch.in_ch, arch.base)
    bn("stem_bn", arch.base)
    for s in range(arch.stages):
        c = arch.channels[s]
        lin(f"down{s}_proj", arch.enc_in[s], c)
        bn(f"down{s}_bn", c)
        blocks(f"enc{s}", c, arch.layers[s])
    for s, j, c_in, c in arch.dec():
        lin(f"up{s}_proj", c_in, c)
        lin(f"up{s}_fuse", c + arch.enc_in[s], c)
        bn(f"up{s}_bn", c)
        blocks(f"dec{s}", c, arch.layers[j])
    lin("final", arch.channels[-1], arch.num_classes)
    return out


def pyramid(arch: Arch, bucket: Dict[str, torch.Tensor], num_scenes: int, depth: int):
    return geo.build(bucket["coord"], bucket["grid_coord"], bucket["mask"], bucket["batch"],
                     num_scenes, depth, arch.capacities(bucket["coord"].shape[0]), arch.orders)


def logits(arch: Arch, P: Params, levels, feat: torch.Tensor, prec: Precision,
           train: bool) -> torch.Tensor:
    bnorm = lambda name, x, lv: batch_norm(P, f"backbone.{name}", x, levels[lv]["mask"], train)

    def block(prefix, x, lv):
        nbr = levels[lv]["nbr"]
        f = F.relu(bnorm(f"{prefix}.bn1", subm_conv(
            x, nbr, P[f"backbone.{prefix}.conv1.weight"], None, prec), lv))
        f = bnorm(f"{prefix}.bn2", subm_conv(f, nbr, P[f"backbone.{prefix}.conv2.weight"],
                                             None, prec), lv)
        return F.relu(x + f)

    x = subm_conv(feat, levels[0]["stem"], P["backbone.stem_conv.weight"], None, prec)
    skips = [F.relu(bnorm("stem_bn", x, 0))]
    for s in range(arch.stages):
        L = levels[s + 1]
        f = dense(P, f"backbone.down{s}_proj", skips[-1], prec)
        f = segment_max(f, L["parent_slot"], L["parent_valid"], L["coord"].shape[0])
        f = F.relu(bnorm(f"down{s}_bn", f, s + 1))
        for i in range(arch.layers[s]):
            f = block(f"enc{s}_block{i}", f, s + 1)
        skips.append(f)
    f = skips[-1]
    for s, j, _, _ in arch.dec():
        L = levels[s + 1]
        f = dense(P, f"backbone.up{s}_proj", f, prec)
        f = torch.where(L["mask"][:, None], f, torch.zeros_like(f)).index_select(0, L["parent_slot"])
        f = dense(P, f"backbone.up{s}_fuse", torch.cat([f, skips[s]], -1), prec)
        f = F.relu(bnorm(f"up{s}_bn", f, s))
        for i in range(arch.layers[j]):
            f = block(f"dec{s}_block{i}", f, s)
    return dense(P, "backbone.final", f, prec)


def train_loss(arch: Arch, P: Params, bucket: Dict[str, torch.Tensor], draws: Dict,
               num_scenes: int, depth: int, prec: Precision) -> torch.Tensor:
    """Cross-entropy of one training forward (SpUNet draws nothing)."""
    levels = pyramid(arch, bucket, num_scenes, depth)
    out = logits(arch, P, levels, bucket["feat"], prec, train=True)
    valid = bucket["mask"] & (bucket["segment"] >= 0)
    return cross_entropy(out, bucket["segment"], valid)


def forward_flops(arch: Arch, stats: Sequence[Dict], train: bool = True) -> float:
    """Multiply-add FLOPs (2 per product) of one forward over valid points
    and existing neighbors."""
    v = [s["valid"] for s in stats]
    e3 = [s["k3_pairs"] for s in stats]
    fl = 2.0 * stats[0]["k5_pairs"] * arch.in_ch * arch.base
    for s in range(arch.stages):
        c = arch.channels[s]
        fl += 2.0 * v[s] * arch.enc_in[s] * c + arch.layers[s] * 2 * 2.0 * e3[s + 1] * c * c
    for s, j, c_in, c in arch.dec():
        fl += 2.0 * v[s + 1] * c_in * c + 2.0 * v[s] * (c + arch.enc_in[s]) * c
        fl += arch.layers[j] * 2 * 2.0 * e3[s] * c * c
    return fl + 2.0 * v[0] * arch.channels[-1] * arch.num_classes


def train_draws(arch: Arch, bucket: Dict[str, torch.Tensor], num_scenes: int,
                seed: int) -> Dict:
    """SpUNet's step draws nothing."""
    return {}
