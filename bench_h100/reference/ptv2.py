"""Point Transformer V2 as Pointcept publishes it (``PT-v2m2``,
`pointcept/models/point_transformer_v2/point_transformer_v2m2_base.py`) in
plain PyTorch: its parameters, the training loss, the forward, its metric
pyramid with kNN tables, and the FLOPs of a forward.

The model: a patch embed (Linear without bias, BatchNorm, ReLU, then one
block at 8 neighbours), four encoders (GridPool: Linear without bias,
BatchNorm, ReLU and the maximum over each metric grid cell; then blocks at
16 neighbours), four decoders (UnpoolWithSkip: the coarse features through
a biased Linear, BatchNorm and ReLU mapped back to their cell's points,
plus the skip through the same; then a block), and the head Linear,
BatchNorm, ReLU, Linear; the features are the coordinates, color and normal
(9 channels, the source's ``feat_keys``). A block is ``ReLU(x +
DropPath(BN3(fc3(ReLU(BN2(GVA(ReLU(BN1(fc1 x)))))))))``. Grouped vector
attention: q and k each a Linear, BatchNorm and ReLU, v a Linear; over the
kNN table, relation ``k_j - q_i + peb(p_j - p_i)`` and values ``v_j +
peb``, ``peb`` = Linear . ReLU . BN . Linear(3, C); weights Linear(G, G) .
ReLU . BN . Linear(C, G) of the relation, a softmax over the neighbours,
then zero at a missing neighbour; each group of C/G channels summed under
its weight. Training loss: cross-entropy over the labelled points, the
source's one criterion.

Departures from the source, each shared with the measured port:

- BatchNorm runs over the valid rows of a padded layout (for (N, K, C)
  tensors: every neighbour slot of a valid point, a missing one included,
  as the source's BatchNorm1d over N K rows); eps 1e-5 as torch's default;
- the kNN ranks by squared distances by the expansion ``|q|^2 - 2 q.r +
  |r|^2`` in float32, each dot product a chain of fused multiply-adds,
  clamped at 0, ties to the lower index (Pointcept's CUDA kNN orders ties
  by its heap); a scene with fewer than K points leaves its last slots
  empty (the guard index), as the source's -1;
- the grid cells of a level are numbered in (scene, x, y, z) order, the
  source's ``torch.unique`` order of its own cluster keys up to a
  relabelling that changes no value; a level keeps at most ``capacity - 1``
  cells (the configuration's ``capacity_div``) and counts the points of
  the cells past it as ``dropped``;
- stochastic-depth keep masks are drawn per slot of the port's padded
  levels, from the run's seed, and handed to the port in call order.

Everything runs in float32 with TF32 off through a `Precision` (the
controls round the products' inputs to fp8). Names are those of the
measured port. The pyramid is the harness's level format
(`geometry.level_stats`): ``nbr`` is a level's kNN table at 16 neighbours
(missing: the level's slot count) and level 0's ``stem`` the patch embed's
8-neighbour table, so that ``k3_pairs`` and ``k5_pairs`` count its valid
(point, neighbour) pairs. Pooled levels hold only their cells, in order,
so their slot ``i`` is the port's slot ``i``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from bench_h100.reference.losses import cross_entropy
from bench_h100.reference.nn import Params, Precision, batch_norm, dense, gather, segment_max

EPS = 1e-5
# distances per block of the kNN: 2^26 float32 and int64 keys
TILE = 1 << 26


class Arch:
    def __init__(self, model: Dict):
        b = model["backbone"]
        self.model = model
        self.in_ch, self.num_classes = b.get("in_channels", 9), b.get("num_classes", 20)
        self.embed_depth = b.get("patch_embed_depth", 1)
        self.embed_ch = b.get("patch_embed_channels", 48)
        self.embed_groups = b.get("patch_embed_groups", 6)
        self.embed_k = b.get("patch_embed_neighbours", 8)
        self.enc_depths = tuple(b.get("enc_depths", (2, 2, 6, 2)))
        self.enc_ch = tuple(b.get("enc_channels", (96, 192, 384, 512)))
        self.enc_groups = tuple(b.get("enc_groups", (12, 24, 48, 64)))
        self.dec_depths = tuple(b.get("dec_depths", (1, 1, 1, 1)))
        self.dec_ch = tuple(b.get("dec_channels", (48, 96, 192, 384)))
        self.dec_groups = tuple(b.get("dec_groups", (6, 12, 24, 48)))
        ks = set(b.get("enc_neighbours", (16,) * 4)) | set(b.get("dec_neighbours", (16,) * 4))
        if len(ks) != 1 or self.embed_k > min(ks):
            raise ValueError("one neighbour count for every encoder and decoder block, "
                             "the patch embed's no larger")
        self.k = ks.pop()
        self.grid_sizes = tuple(b.get("grid_sizes", (0.06, 0.12, 0.24, 0.48)))
        self.capacity_div = tuple(b.get("capacity_div", (1, 2, 8, 32, 128)))
        self.stages = len(self.enc_depths)
        self.skip_ch = [self.embed_ch] + list(self.enc_ch)
        self.up_in = list(self.dec_ch[1:]) + [self.enc_ch[-1]]
        rate = b.get("drop_path_rate", 0.3)
        self.enc_dp = torch.linspace(0, rate, sum(self.enc_depths)).tolist()
        self.dec_dp = torch.linspace(0, rate, sum(self.dec_depths)).tolist()

    def capacities(self, n0: int) -> List[int]:
        return [-(-max(n0 // d, 8) // 8) * 8 for d in self.capacity_div[1:self.stages + 1]]

    def enc_rate(self, s: int, i: int) -> float:
        return self.enc_dp[sum(self.enc_depths[:s]) + i]

    def dec_rate(self, s: int, i: int) -> float:
        return self.dec_dp[sum(self.dec_depths[:s]) + i]

    def drop_sites(self) -> List[Tuple[int, float]]:
        """(level, rate) of each block with stochastic depth, in call order:
        the encoders, then the decoders coarse first."""
        out = [(s + 1, self.enc_rate(s, i)) for s in range(self.stages)
               for i in range(self.enc_depths[s])]
        out += [(s, self.dec_rate(s, i)) for s in reversed(range(self.stages))
                for i in range(self.dec_depths[s])]
        return [(lv, r) for lv, r in out if r > 0.0]


def param_shapes(arch: Arch) -> Dict[str, Tuple[int, ...]]:
    out: Dict[str, Tuple[int, ...]] = {}

    def bn(name, c):
        for k in ("scale", "bias", "mean", "var"):
            out[f"backbone.{name}.{k}"] = (c,)

    def lin(name, i, o, bias=True):
        out[f"backbone.{name}.weight"] = (o, i)
        if bias:
            out[f"backbone.{name}.bias"] = (o,)

    def block(name, c, g):
        lin(f"{name}.fc1", c, c, bias=False)
        bn(f"{name}.norm1", c)
        a = f"{name}.attn"
        for x in ("q", "k"):
            lin(f"{a}.linear_{x}", c, c)
            bn(f"{a}.norm_{x}", c)
        lin(f"{a}.linear_v", c, c)
        lin(f"{a}.pe_fc1", 3, c)
        bn(f"{a}.pe_norm", c)
        lin(f"{a}.pe_fc2", c, c)
        lin(f"{a}.we_fc1", c, g)
        bn(f"{a}.we_norm", g)
        lin(f"{a}.we_fc2", g, g)
        bn(f"{name}.norm2", c)
        lin(f"{name}.fc3", c, c, bias=False)
        bn(f"{name}.norm3", c)

    lin("patch_embed", arch.in_ch, arch.embed_ch, bias=False)
    bn("patch_embed_bn", arch.embed_ch)
    for i in range(arch.embed_depth):
        block(f"embed_block{i}", arch.embed_ch, arch.embed_groups)
    for s in range(arch.stages):
        lin(f"down{s}", arch.skip_ch[s], arch.enc_ch[s], bias=False)
        bn(f"down{s}_bn", arch.enc_ch[s])
        for i in range(arch.enc_depths[s]):
            block(f"enc{s}_block{i}", arch.enc_ch[s], arch.enc_groups[s])
    for s in reversed(range(arch.stages)):
        lin(f"up{s}", arch.up_in[s], arch.dec_ch[s])
        bn(f"up{s}_bn", arch.dec_ch[s])
        lin(f"skip{s}", arch.skip_ch[s], arch.dec_ch[s])
        bn(f"skip{s}_bn", arch.dec_ch[s])
        for i in range(arch.dec_depths[s]):
            block(f"dec{s}_block{i}", arch.dec_ch[s], arch.dec_groups[s])
    c0 = arch.dec_ch[0]
    lin("head_fc1", c0, c0)
    bn("head_bn", c0)
    lin("head_fc2", c0, arch.num_classes)
    return out


# -- geometry -----------------------------------------------------------------


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a2 b2 + (a1 b1 + a0 b0)``, each step a fused multiply-add."""
    d = a[..., 0] * b[..., 0]
    d = torch.addcmul(d, a[..., 1], b[..., 1])
    return torch.addcmul(d, a[..., 2], b[..., 2])


def sq_dist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(M, R) squared distances by the expansion, clamped at 0 (+0.0)."""
    d = torch.add(_dot3(q, q)[:, None], _dot3(q[:, None, :], r[None, :, :]), alpha=-2.0)
    d += _dot3(r, r)[None, :]
    return d.clamp_(min=0.0) + 0.0


def knn_table(coord: torch.Tensor, mask: torch.Tensor, batch: torch.Tensor,
              k: int) -> torch.Tensor:
    """(N, k) int64: for each valid point, its ``k`` nearest valid points of
    its own scene in ascending (distance, index) order, by a sort of int64
    keys ``distance bits << 32 | position`` (non-negative float32 bits order
    as the floats); N where a scene has fewer than ``k`` points and on
    invalid rows. Every valid point against every one of its scene, in
    blocks of rows."""
    n = coord.shape[0]
    out = torch.full((n, k), n, dtype=torch.long, device=coord.device)
    for s in torch.unique(batch[mask]).tolist():
        idx = torch.nonzero(mask & (batch == s)).flatten()
        pts = coord[idx].float()
        m = idx.numel()
        kk = min(k, m)
        pos = torch.arange(m, device=coord.device)
        rows = max(1, TILE // m)
        for a in range(0, m, rows):
            d = sq_dist(pts[a:a + rows], pts)
            key = (d.view(torch.int32).long() << 32) | pos
            sel = torch.topk(key, kk, dim=1, largest=False, sorted=True).values & 0xFFFFFFFF
            out[idx[a:a + rows], :kk] = idx[sel]
    return out


def _cell_sums(x: torch.Tensor, cell: torch.Tensor, cells: int) -> torch.Tensor:
    """Per cell, the sum of its rows taken one after another in their order
    (``((0 + x0) + x1) + ...``): each pass adds every cell's next member."""
    order = torch.argsort(cell, stable=True)
    cell, x = cell[order], x[order]
    first = torch.searchsorted(cell, cell)  # each row's first row of its cell
    rank = torch.arange(cell.numel(), device=cell.device) - first
    out = torch.zeros((cells, x.shape[1]), dtype=x.dtype, device=x.device)
    for r in range(int(rank.max()) + 1 if cell.numel() else 0):
        at = rank == r
        out[cell[at]] += x[at]
    return out


def metric_level(parent: Dict, grid_size: float, capacity: int) -> Dict:
    """The cells of ``grid_size`` over ``coord`` less each scene's minimum,
    in (scene, x, y, z) order, at most ``capacity - 1`` of them; their mean
    coordinates, each sum taken member by member in slot order.
    ``parent_slot`` maps each parent point to its cell, ``parent_valid``
    whether it is pooled (valid and not dropped)."""
    coord, mask, batch = parent["coord"], parent["mask"], parent["batch"]
    dev = coord.device
    s = parent["num_scenes"]
    b = torch.where(mask, batch, s)
    lo = torch.full((s + 1, 3), float("inf"), device=dev).scatter_reduce(
        0, b[:, None].expand(-1, 3), torch.where(mask[:, None], coord, float("inf")), "amin")
    # a true division by a tensor: a host scalar divisor becomes a product
    # with its reciprocal on the card, which rounds otherwise
    rel = coord - lo[b]
    vox = torch.floor(rel / torch.full_like(rel, grid_size)).long()
    keys = torch.cat([b[:, None], vox], 1)[mask]
    cells, cell_of = torch.unique(keys, dim=0, return_inverse=True)
    keep = min(cells.shape[0], capacity - 1)
    slot = torch.zeros_like(batch)
    slot[mask] = cell_of
    valid = mask & (slot < keep)
    dropped = int((mask & (slot >= keep)).sum())
    cnt = torch.zeros(keep, device=dev).index_add_(0, slot[valid], valid.float()[valid])
    mean = _cell_sums(coord[valid], slot[valid], keep) / cnt[:, None]
    return dict(coord=mean, mask=torch.ones(keep, dtype=torch.bool, device=dev),
                batch=cells[:keep, 0], num_scenes=s, parent_slot=torch.where(valid, slot, 0),
                parent_valid=valid, dropped=dropped)


def pyramid(arch: Arch, bucket: Dict[str, torch.Tensor], num_scenes: int, depth: int = 0):
    """Every level, level 0 (the bucket's slots) first, each with its kNN
    table ``nbr``; level 0 also ``stem``, the patch embed's table."""
    levels = [dict(coord=bucket["coord"].float(), mask=bucket["mask"],
                   batch=bucket["batch"].long(), num_scenes=num_scenes)]
    for g, cap in zip(arch.grid_sizes, arch.capacities(bucket["coord"].shape[0])):
        levels.append(metric_level(levels[-1], g, cap))
    for lv in levels:
        lv["nbr"] = knn_table(lv["coord"], lv["mask"], lv["batch"], arch.k)
    levels[0]["stem"] = levels[0]["nbr"][:, :arch.embed_k]
    return levels


# -- the forward --------------------------------------------------------------


def gva(P: Params, name: str, x, coord, mask, nbr, groups: int, prec: Precision, train: bool):
    n, k = nbr.shape
    c = x.shape[1]
    bnorm = lambda nm, t, m: batch_norm(P, f"{name}.{nm}", t, m, train, EPS)
    rows = mask[:, None].expand(n, k).reshape(-1)
    real = nbr < n
    pad = lambda t: torch.cat([t, t.new_zeros((1, t.shape[1]))])
    q = F.relu(bnorm("norm_q", dense(P, f"{name}.linear_q", x, prec), mask))
    key = F.relu(bnorm("norm_k", dense(P, f"{name}.linear_k", x, prec), mask))
    val = dense(P, f"{name}.linear_v", x, prec)
    pos = torch.where(real[..., None], gather(pad(coord), nbr) - coord[:, None, :], 0.0)
    peb = dense(P, f"{name}.pe_fc1", pos.reshape(n * k, 3), prec)
    peb = dense(P, f"{name}.pe_fc2", F.relu(bnorm("pe_norm", peb, rows)), prec).reshape(n, k, c)
    relation = gather(pad(key), nbr) - q[:, None, :] + peb
    w = dense(P, f"{name}.we_fc1", relation.reshape(n * k, c), prec)
    w = dense(P, f"{name}.we_fc2", F.relu(bnorm("we_norm", w, rows)), prec).reshape(n, k, groups)
    w = torch.softmax(w, dim=1) * real[..., None]
    v = (gather(pad(val), nbr) + peb).reshape(n, k, groups, c // groups)
    return (v * w[..., None]).sum(1).reshape(n, c)


def block(P: Params, name: str, x, lv: Dict, nbr, groups: int, keep, prec: Precision,
          train: bool):
    """``keep``: the stochastic-depth (keep mask, rate) of the block, or None."""
    bnorm = lambda nm, t: batch_norm(P, f"{name}.{nm}", t, lv["mask"], train, EPS)
    f = F.relu(bnorm("norm1", dense(P, f"{name}.fc1", x, prec)))
    f = gva(P, f"{name}.attn", f, lv["coord"], lv["mask"], nbr, groups, prec, train)
    f = bnorm("norm3", dense(P, f"{name}.fc3", F.relu(bnorm("norm2", f)), prec))
    if keep is not None:
        m, rate = keep
        f = torch.where(m[:f.shape[0]], f / (torch.tensor(1.0) - rate).to(f.device), 0.0)
    return F.relu(x + f)


def logits(arch: Arch, P: Params, levels: List[Dict], feat: torch.Tensor, prec: Precision,
           train: bool, masks: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """``masks``: the keep masks of `Arch.drop_sites`, in order (training)."""
    sites = iter(zip(masks, [r for _, r in arch.drop_sites()]))
    keep = lambda rate: next(sites) if train and rate > 0.0 else None
    bnorm = lambda nm, t, lv: batch_norm(P, f"backbone.{nm}", t, levels[lv]["mask"], train, EPS)
    lv0 = levels[0]
    f = F.relu(bnorm("patch_embed_bn", dense(P, "backbone.patch_embed", feat, prec), 0))
    for i in range(arch.embed_depth):
        f = block(P, f"backbone.embed_block{i}", f, lv0, lv0["stem"], arch.embed_groups, None,
                  prec, train)
    skips = [f]
    for s in range(arch.stages):
        L = levels[s + 1]
        f = F.relu(bnorm(f"down{s}_bn", dense(P, f"backbone.down{s}", skips[-1], prec), s))
        f = segment_max(f, L["parent_slot"], L["parent_valid"], L["coord"].shape[0])
        for i in range(arch.enc_depths[s]):
            f = block(P, f"backbone.enc{s}_block{i}", f, L, L["nbr"], arch.enc_groups[s],
                      keep(arch.enc_rate(s, i)), prec, train)
        skips.append(f)
    f = skips[-1]
    for s in reversed(range(arch.stages)):
        L, lo = levels[s + 1], levels[s]
        f = F.relu(bnorm(f"up{s}_bn", dense(P, f"backbone.up{s}", f, prec), s + 1))
        f = torch.where(L["parent_valid"][:, None], f.index_select(0, L["parent_slot"]), 0.0)
        f = f + F.relu(bnorm(f"skip{s}_bn", dense(P, f"backbone.skip{s}", skips[s], prec), s))
        for i in range(arch.dec_depths[s]):
            f = block(P, f"backbone.dec{s}_block{i}", f, lo, lo["nbr"], arch.dec_groups[s],
                      keep(arch.dec_rate(s, i)), prec, train)
    f = F.relu(bnorm("head_bn", dense(P, "backbone.head_fc1", f, prec), 0))
    return dense(P, "backbone.head_fc2", f, prec)


def train_draws(arch: Arch, bucket: Dict[str, torch.Tensor], num_scenes: int,
                seed: int) -> Dict:
    """A keep mask per stochastic-depth block, over the port's slots of its
    level (the bucket's size at level 0, the capacities below)."""
    dev = bucket["coord"].device
    g = torch.Generator(dev).manual_seed(seed)
    n = bucket["coord"].shape[0]
    sizes = [n] + arch.capacities(n)
    return dict(path_masks=[torch.rand((sizes[lv], 1), generator=g, device=dev) < 1.0 - r
                            for lv, r in arch.drop_sites()])


def train_loss(arch: Arch, P: Params, bucket: Dict[str, torch.Tensor], draws: Dict,
               num_scenes: int, depth: int, prec: Precision) -> torch.Tensor:
    """The cross-entropy of one training forward (TF32 off unless ``prec``
    is the TF32 control)."""
    prec.use()
    levels = pyramid(arch, bucket, num_scenes, depth)
    out = logits(arch, P, levels, bucket["feat"], prec, True, draws["path_masks"])
    valid = bucket["mask"] & (bucket["segment"] >= 0)
    return cross_entropy(out, bucket["segment"], valid)


def forward_flops(arch: Arch, stats: Sequence[Dict], train: bool = True) -> float:
    """Multiply-add FLOPs (2 per product) of the Linear layers of one
    forward: per valid point, and in the attention's position and weight
    encodings per valid (point, neighbour) pair (``k3_pairs`` of a level's
    16-neighbour table, ``k5_pairs`` of the patch embed's 8). No kNN
    distance, softmax or weighted sum is counted."""
    v = [s["valid"] for s in stats]

    def blk(valid, pairs, c, g):
        return 2.0 * (5 * valid * c * c + pairs * (3 * c + c * c + c * g + g * g))

    fl = 2.0 * v[0] * arch.in_ch * arch.embed_ch
    fl += arch.embed_depth * blk(v[0], stats[0]["k5_pairs"], arch.embed_ch, arch.embed_groups)
    for s in range(arch.stages):
        fl += 2.0 * v[s] * arch.skip_ch[s] * arch.enc_ch[s]
        fl += arch.enc_depths[s] * blk(v[s + 1], stats[s + 1]["k3_pairs"], arch.enc_ch[s],
                                       arch.enc_groups[s])
        fl += 2.0 * (v[s + 1] * arch.up_in[s] + v[s] * arch.skip_ch[s]) * arch.dec_ch[s]
        fl += arch.dec_depths[s] * blk(v[s], stats[s]["k3_pairs"], arch.dec_ch[s],
                                       arch.dec_groups[s])
    c0 = arch.dec_ch[0]
    return fl + 2.0 * v[0] * c0 * (c0 + arch.num_classes)
