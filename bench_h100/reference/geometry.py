"""The geometry pyramid, worked out again in plain PyTorch.

A batch is a flat array of slots: ``coord`` (N, 3) float32, ``grid`` (N, 3)
int64 voxel coordinates, ``mask`` (N,) bool and ``batch`` (N,) int64 scene
ids (``num_scenes`` on padding). Each level holds the serialization codes of
every curve, their sort orders, a 3x3x3 neighbor table and, below level 0,
the map from each parent slot to its cluster. The rules follow the published
PTv3 pyramid: a pooled level clusters its parent by the first curve's code
shifted right by 3 bits (the 2x2x2 cell), numbers the clusters by their rank
along that curve, keeps ``capacity - 1`` of them (the last slot takes the
overflow and is never valid), and takes its codes from each cluster's first
point shifted the same way. Neighbor tables are exact lookups by sort and
binary search; a missing neighbor is the index N.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Bit i of the low 21 bits of ``v`` moved to bit 3 i."""
    out = torch.zeros_like(v)
    for i in range(21):
        out |= ((v >> i) & 1) << (3 * i)
    return out


def _hilbert_transpose(x, y, z, depth: int):
    """Skilling's AxesToTranspose for three axes, then the Gray code."""
    X = [x.clone(), y.clone(), z.clone()]
    q = 1 << (depth - 1)
    while q > 1:
        p = q - 1
        for i in range(3):
            hit = (X[i] & q) != 0
            t = torch.where(hit, torch.zeros_like(X[0]), (X[0] ^ X[i]) & p)
            x0 = torch.where(hit, X[0] ^ p, X[0] ^ t)
            xi = X[i] ^ t
            X[0] = x0
            if i:
                X[i] = xi
        q >>= 1
    X[1] = X[1] ^ X[0]
    X[2] = X[2] ^ X[1]
    t = torch.zeros_like(X[0])
    q = 1 << (depth - 1)
    while q > 1:
        t = torch.where((X[2] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    return [a ^ t for a in X]


def encode(grid: torch.Tensor, batch: torch.Tensor, depth: int, order: str) -> torch.Tensor:
    """``batch << 3 depth | curve code`` of int64 voxel coordinates; x is the
    most significant bit of each 3-bit group, "-trans" swaps x and y."""
    g = grid.long() & ((1 << depth) - 1)
    if order.endswith("-trans"):
        g = g[:, [1, 0, 2]]
    x, y, z = g[:, 0], g[:, 1], g[:, 2]
    if order.startswith("hilbert"):
        x, y, z = _hilbert_transpose(x, y, z, depth)
    code = (_spread3(x) << 2) | (_spread3(y) << 1) | _spread3(z)
    return (batch.long() << (3 * depth)) | code


def _sort_curves(codes: torch.Tensor):
    order = torch.sort(codes, dim=1, stable=True).indices
    inverse = torch.empty_like(order)
    inverse.scatter_(1, order, torch.arange(codes.shape[1], device=codes.device)
                     .expand_as(order).contiguous())
    return order, inverse


def offsets(kernel: int, device) -> torch.Tensor:
    """(K, 3) integer offsets of a cubic kernel, x slowest."""
    r = kernel // 2
    ax = torch.arange(-r, r + 1, device=device)
    return torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)


def neighbor_table(grid: torch.Tensor, batch: torch.Tensor, mask: torch.Tensor,
                   depth: int, kernel: int) -> torch.Tensor:
    """(N, K): the slot of the valid point of the same scene at ``grid +
    offset``, or N."""
    n = grid.shape[0]
    side = 1 << depth
    key = lambda b, g: ((b * side + g[..., 0]) * side + g[..., 1]) * side + g[..., 2]
    keys = torch.where(mask, key(batch.long(), grid.long()), torch.full_like(batch.long(), -1))
    sk, si = torch.sort(keys)
    out = torch.full((n, kernel ** 3), n, dtype=torch.long, device=grid.device)
    for j, off in enumerate(offsets(kernel, grid.device)):
        q = grid.long() + off
        inside = ((q >= 0) & (q < side)).all(-1) & mask
        qk = key(batch.long(), q)
        pos = torch.searchsorted(sk, qk).clamp(max=n - 1)
        hit = inside & (sk[pos] == qk)
        out[:, j] = torch.where(hit, si[pos], n)
    return out


def level0(coord, grid, mask, batch, num_scenes: int, depth: int,
           orders: Sequence[str], perm: Optional[Sequence[int]]) -> Dict:
    codes = torch.stack([encode(grid, batch, depth, o) for o in orders])
    if perm is not None:
        codes = codes[list(perm)]
    order, inverse = _sort_curves(codes)
    return dict(coord=coord, grid=grid.long(), mask=mask, batch=batch.long(),
                depth=depth, num_scenes=num_scenes, codes=codes, order=order,
                inverse=inverse)


def pooled(parent: Dict, capacity: int, perm: Optional[Sequence[int]]) -> Dict:
    """The stride-2 level below ``parent`` at ``capacity`` slots."""
    m, s, dev = capacity, parent["num_scenes"], parent["coord"].device
    mp = parent["coord"].shape[0]
    o0 = parent["order"][0]
    key = parent["codes"][0][o0] >> 3
    new = torch.ones_like(key)
    new[1:] = (key[1:] != key[:-1]).long()
    seg = torch.cumsum(new, 0) - 1
    slot = seg.clamp(max=m - 1)
    pmask = parent["mask"][o0]
    valid = pmask & (seg < m - 1)
    dropped = int((pmask & (seg >= m - 1)).sum())
    # each slot's first point along the curve (its head)
    head = torch.full((m,), mp, dtype=torch.long, device=dev)
    head.scatter_reduce_(0, slot, torch.arange(mp, device=dev), "amin")
    head_parent = o0[head.clamp(max=mp - 1)]
    cnt = torch.zeros(m, device=dev).index_add_(0, slot, valid.float())
    mask = cnt > 0
    csum = torch.zeros((m, 3), device=dev).index_add_(
        0, slot, parent["coord"][o0] * valid[:, None].float())
    coord = torch.where(mask[:, None], csum / cnt.clamp(min=1)[:, None], 0.0)
    grid = torch.where(mask[:, None], parent["grid"][head_parent] >> 1, 0)
    batch = torch.where(mask, parent["batch"][head_parent], s)
    used = torch.arange(m, device=dev) <= seg[-1].clamp(max=m - 1)
    depth = parent["depth"] - 1
    sentinel = 1 << (3 * depth + max(s.bit_length(), 1))
    codes = torch.where(used[None], parent["codes"][:, head_parent] >> 3, sentinel)
    if perm is not None:
        codes = codes[list(perm)]
    order, inverse = _sort_curves(codes)
    parent_slot = torch.empty(mp, dtype=torch.long, device=dev)
    parent_slot[o0] = slot
    return dict(coord=coord, grid=grid, mask=mask, batch=batch, depth=depth,
                num_scenes=s, codes=codes, order=order, inverse=inverse,
                parent_slot=parent_slot, parent_valid=torch.empty_like(pmask)
                .index_copy_(0, o0, valid), head=head_parent, dropped=dropped)


def build(coord, grid, mask, batch, num_scenes: int, depth: int, capacities: Sequence[int],
          orders: Sequence[str], perms: Optional[Sequence[Sequence[int]]] = None,
          stem_kernel: int = 5) -> List[Dict]:
    """Every level, level 0 first, with its k3 table ``nbr``; level 0 also
    has the ``stem`` table of ``stem_kernel``."""
    perms = perms if perms is not None else [None] * (len(capacities) + 1)
    levels = [level0(coord, grid, mask, batch, num_scenes, depth, orders, perms[0])]
    for cap, perm in zip(capacities, perms[1:]):
        levels.append(pooled(levels[-1], cap, perm))
    for lv in levels:
        lv["nbr"] = neighbor_table(lv["grid"], lv["batch"], lv["mask"], lv["depth"], 3)
    lv0 = levels[0]
    lv0["stem"] = neighbor_table(lv0["grid"], lv0["batch"], lv0["mask"], lv0["depth"],
                                 stem_kernel)
    return levels


def sorted_view(level: Dict, curve: int):
    """Scene ids and validity along ``curve``."""
    o = level["order"][curve]
    return level["batch"][o], level["mask"][o]


def attention_pairs(level: Dict, patch: int, curve: int = 0) -> int:
    """Allowed (query, key) pairs of patch attention along ``curve``: a key
    of the same scene, valid, in the same window of ``patch`` slots."""
    b, m = sorted_view(level, curve)
    n = b.shape[0]
    k = min(patch, n)
    s = level["num_scenes"]
    bp, mp = b.reshape(n // k, k), m.reshape(n // k, k)
    counts = torch.zeros((n // k, s + 1), device=b.device)
    counts.scatter_add_(1, bp, mp.float())
    keys = counts[:, :s]
    per_query = torch.gather(torch.cat([keys, torch.zeros_like(keys[:, :1])], 1), 1, bp)
    return int(per_query.sum())


def level_stats(levels: List[Dict], patch: Optional[int]) -> List[Dict]:
    """Per level: slots, valid points, k3 neighbor pairs and, with a
    ``patch``, attention pairs; level 0 also its stem pairs."""
    out = []
    for lv in levels:
        n = lv["coord"].shape[0]
        d = dict(slots=n, valid=int(lv["mask"].sum()),
                 k3_pairs=int((lv["nbr"][lv["mask"]] < n).sum()))
        if patch:
            d["attn_pairs"] = attention_pairs(lv, patch)
        if "stem" in lv:
            d["k5_pairs"] = int((lv["stem"][lv["mask"]] < n).sum())
        out.append(d)
    return out
