"""Static-shape batched point clouds, serialization and neighbor tables.

Port of `cdsegnet_tpu/models/structure.py`. A batch is a flat array of
``num_points`` slots; unused slots carry ``mask=False`` and the sentinel
scene id ``num_scenes``, which sorts them to the end of every serialization
order. Codes are int64; sort orders, inverses and neighbor tables are int32,
with the value N marking a missing neighbor.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from cdsegnet_torch.ops import serialization as ser
from cdsegnet_torch.utils.device import resolve_device


@dataclasses.dataclass
class PointBatch:
    """A batch of point clouds with static shapes (layout as in JAX).

    coord (N, 3) float32, grid_coord (N, 3) int32, feat (N, C), mask (N,)
    bool, batch (N,) int32 with the sentinel at padding, segment (N,) int32
    (-1 = ignore), instance (N,) int32 (-1 = no instance) and
    instance_centroid (N, 3) float32 (instance segmentation). After
    `serialize`: codes (O, N) int64, orders/inverses
    (O, N) int32, codes_sorted (O, N) int64, batch_sorted (O, N) int32,
    mask_sorted (O, N) bool. neighbor_idx (N, K) int32.
    """

    coord: torch.Tensor
    grid_coord: torch.Tensor
    feat: torch.Tensor
    mask: torch.Tensor
    batch: torch.Tensor
    segment: Optional[torch.Tensor] = None
    instance: Optional[torch.Tensor] = None
    instance_centroid: Optional[torch.Tensor] = None
    codes: Optional[torch.Tensor] = None
    orders: Optional[torch.Tensor] = None
    inverses: Optional[torch.Tensor] = None
    codes_sorted: Optional[torch.Tensor] = None
    batch_sorted: Optional[torch.Tensor] = None
    mask_sorted: Optional[torch.Tensor] = None
    neighbor_idx: Optional[torch.Tensor] = None
    depth: int = 16
    num_scenes: int = 1

    @property
    def num_points(self) -> int:
        return self.coord.shape[0]

    def replace(self, **changes) -> "PointBatch":
        return dataclasses.replace(self, **changes)


def make_point_batch(
    coord,
    feat,
    grid_coord,
    batch,
    mask,
    segment=None,
    depth: int = 16,
    num_scenes: int = 1,
    device=None,
    instance=None,
    instance_centroid=None,
) -> PointBatch:
    """Normalize dtypes and apply the padding sentinel convention. The
    arrays go to ``device``: the GPU unless the caller names another."""
    device = resolve_device(device)
    t = lambda x: torch.as_tensor(x, device=device)
    mask = t(mask).to(torch.bool)
    feat = t(feat)
    m1 = mask[:, None]
    return PointBatch(
        coord=torch.where(m1, t(coord).to(torch.float32), 0.0),
        grid_coord=torch.where(m1, t(grid_coord).to(torch.int32), 0),
        feat=torch.where(m1, feat, torch.zeros((), dtype=feat.dtype,
                                                device=feat.device)),
        mask=mask,
        batch=torch.where(mask, t(batch).to(torch.int32), num_scenes).to(torch.int32),
        segment=None if segment is None else torch.where(
            mask, t(segment).to(torch.int32), -1).to(torch.int32),
        instance=None if instance is None else torch.where(
            mask, t(instance).to(torch.int32), -1).to(torch.int32),
        instance_centroid=None if instance_centroid is None else torch.where(
            m1, t(instance_centroid).to(torch.float32), 0.0),
        depth=depth,
        num_scenes=num_scenes,
    )


def assert_unique_voxels(grid_coord, batch, mask, where: str = "") -> None:
    """Host-side check of the GridSample invariant: voxels unique per scene.

    The neighbor-table builds trust it (`exact_match_lookup`'s ``max_run``
    and the mirror halving of `build_neighbor_table`) and return missing
    neighbors where it fails. The collator calls this on every bucket when
    ``CDSEG_VALIDATE`` is set. Raises `ValueError` naming the worst voxel,
    with JAX's message. Takes numpy arrays or tensors.
    """
    gc, bt, mk = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                  else np.asarray(x) for x in (grid_coord, batch, mask))
    mk = mk.astype(bool)
    rows = np.concatenate([bt[mk, None], gc[mk]], axis=1)
    uniq, counts = np.unique(rows, axis=0, return_counts=True)
    if (counts > 1).any():
        worst = uniq[np.argmax(counts)]
        raise ValueError(
            f"duplicate voxels{' in ' + where if where else ''}: "
            f"{int((counts > 1).sum())} voxel(s) occupied by multiple points "
            f"(worst: scene {worst[0]} voxel {tuple(worst[1:])} x"
            f"{int(counts.max())}). Neighbor tables require unique voxels "
            f"per scene (the GridSample invariant) — deduplicate upstream."
        )


def _arange(n, like, dtype=torch.int64):
    return torch.arange(n, dtype=dtype, device=like.device)


def _inverse(order: torch.Tensor) -> torch.Tensor:
    """Inverse permutations of the rows of ``order`` (O, N)."""
    inv = torch.empty_like(order)
    src = _arange(order.shape[1], order, order.dtype).expand_as(order)
    return inv.scatter_(1, order.long(), src)


def serialize(
    point: PointBatch,
    orders: Tuple[str, ...] = ("z", "z-trans", "hilbert", "hilbert-trans"),
    perm: Optional[Sequence[int]] = None,
) -> PointBatch:
    """Per-order codes, sort orders and inverses. Pads carry the sentinel
    scene id, so they sort to the tail of every order. ``perm``, a
    permutation of ``range(len(orders))``, shuffles the curves (training's
    ``shuffle_orders``; JAX draws it with ``jax.random.permutation``)."""
    codes = torch.stack([
        ser.encode(point.grid_coord, point.batch, depth=point.depth, order=o)
        for o in orders
    ])
    if perm is not None:
        codes = codes[list(perm)]
    key_bits = 3 * point.depth + max(point.num_scenes.bit_length(), 1)
    order, codes_sorted = map(torch.stack, zip(*(packed_sort(c, key_bits)
                                                 for c in codes)))
    # scene ids sit in the code's high bits, so the sorted arrangements
    # decode from `codes_sorted` without gathers
    batch_sorted = (codes_sorted >> (3 * point.depth)).to(torch.int32)
    return point.replace(
        codes=codes, orders=order, inverses=_inverse(order),
        codes_sorted=codes_sorted, batch_sorted=batch_sorted,
        mask_sorted=batch_sorted != point.num_scenes,
    )


# ---------------------------------------------------------------------------
# Packed sorts: (key, index) packed into one int64 word, one single-array sort.
# ---------------------------------------------------------------------------


def _idx_bits(n: int) -> int:
    return (n - 1).bit_length() if n > 1 else 1


def _warn_fallback(key_bits: int, idx_bits: int) -> None:
    warnings.warn(
        f"packed sort: key_bits={key_bits} + idx_bits={idx_bits} > 63; "
        f"falling back to a plain stable argsort. Reduce serialization "
        f"depth to restore the packed path.",
        stacklevel=3,
    )


def packed_argsort(keys: torch.Tensor, key_bits: int) -> torch.Tensor:
    """Stable argsort via one sort of ``key << idx_bits | idx``.

    Requires ``key_bits + ceil(log2(n)) <= 63`` and non-negative keys; falls
    back to a stable argsort otherwise."""
    return packed_sort(keys, key_bits)[0]


def packed_sort(
    keys: torch.Tensor, key_bits: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(argsort int32, sorted_keys int64)`` from one packed sort; the low
    bits of the sorted word are the order and the high bits the keys."""
    n = keys.shape[0]
    idx_bits = _idx_bits(n)
    if key_bits + idx_bits > 63:
        _warn_fallback(key_bits, idx_bits)
        order = torch.sort(keys, stable=True).indices
        return order.to(torch.int32), keys[order]
    packed = (keys.to(torch.int64) << idx_bits) | _arange(n, keys)
    s = torch.sort(packed).values
    return (s & ((1 << idx_bits) - 1)).to(torch.int32), s >> idx_bits


def _windowed_max(x: torch.Tensor, window: int) -> torch.Tensor:
    """Max over the trailing ``window`` positions (inclusive; coverage is
    the next power of two) by doubling shifted-max passes."""
    m = x.shape[0]
    fill = torch.iinfo(x.dtype).min
    sh = 1
    while sh < window:
        shifted = torch.cat([x.new_full((min(sh, m),), fill), x[: max(m - sh, 0)]])
        x = torch.maximum(x, shifted)
        sh *= 2
    return x


def exact_match_lookup(
    keys: torch.Tensor,
    key_index: torch.Tensor,
    queries: torch.Tensor,
    key_bits: int,
    missing: int,
    max_run: Optional[int] = None,
) -> torch.Tensor:
    """For each query key, the ``key_index`` of an equal element of ``keys``,
    or ``missing`` when absent.

    One co-sort of packed words ``key << (idx_bits+1) | is_query << idx_bits
    | payload`` (keys sort just before equal queries), a running max that
    carries the latest key to every query, and one scatter.

    ``max_run``: the caller guarantees that at most ``max_run`` consecutive
    sorted elements share one code (voxels unique per scene); the key then
    propagates through a bounded shifted-max cascade. The bound is trusted,
    not checked: a violated invariant yields missing matches, exactly as in
    the JAX package.
    """
    nk, nq = keys.shape[0], queries.shape[0]
    idx_bits = max((nk + nq - 1).bit_length(), (missing + 1).bit_length())
    if key_bits + idx_bits + 1 > 63:
        sort_idx = torch.sort(keys, stable=True).indices
        sorted_keys = keys[sort_idx]
        pos = torch.searchsorted(sorted_keys, queries).clamp(0, nk - 1)
        found = sorted_keys[pos] == queries
        return torch.where(found, key_index[sort_idx][pos].long(),
                           missing).to(torch.int32)
    shift = idx_bits + 1
    flag = 1 << idx_bits
    pk = (keys.to(torch.int64) << shift) | key_index.to(torch.int64)
    pq = (queries.to(torch.int64) << shift) | flag | _arange(nq, queries)
    s = torch.sort(torch.cat([pk, pq])).values
    is_key = (s & flag) == 0
    # most recent key row at or before each position (keys ascend with s)
    masked = torch.where(is_key, s, -1)
    if max_run is not None:
        # +1: the window spans the run head (the key) from the run's last query
        last_key = _windowed_max(masked, max_run + 1)
    else:
        last_key = torch.cummax(masked, 0).values
    match = (last_key >= 0) & ((last_key >> shift) == (s >> shift))
    payload = s & (flag - 1)
    neigh = torch.where(match, last_key & (flag - 1), missing)
    out = torch.full((nq + 1,), missing, dtype=torch.int64, device=keys.device)
    out[torch.where(is_key, nq, payload)] = neigh  # keys land on slot nq
    return out[:nq].to(torch.int32)


# ---------------------------------------------------------------------------
# Submanifold-conv neighbor tables.
# ---------------------------------------------------------------------------


def kernel_offsets(kernel_size: int, device=None) -> torch.Tensor:
    """All integer offsets of a cubic kernel, (K, 3) int64, x slowest."""
    r = kernel_size // 2
    ax = torch.arange(-r, r + 1, device=device)
    ox, oy, oz = torch.meshgrid(ax, ax, ax, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1), oz.reshape(-1)], dim=-1)


def _padded_keys(grid_coord, batch, mask, depth, num_scenes):
    key_bits = 3 * depth + max((num_scenes + 1).bit_length(), 1)
    keys = ser.encode(grid_coord, batch, depth=depth, order="z")
    # padding slots share one key past every real key
    return torch.where(mask, keys, (1 << key_bits) - 1), key_bits


def _offset_lookup(grid_coord, batch, mask, depth, keys, key_bits, offs):
    """Table columns for the offsets ``offs`` (H, 3) by exact code match;
    N marks a missing neighbor."""
    n = grid_coord.shape[0]
    h = offs.shape[0]
    q_coord = grid_coord.to(torch.int64)[:, None, :] + offs[None]
    in_range = ((q_coord >= 0) & (q_coord < (1 << depth))).all(dim=-1)
    q_keys = ser.encode(q_coord.reshape(-1, 3), batch.repeat_interleave(h),
                        depth=depth, order="z")
    # run bound: voxels are unique per scene, so a code is shared by at most
    # one key and h queries
    nbr = exact_match_lookup(keys, _arange(n, keys, torch.int32), q_keys,
                             key_bits, missing=n, max_run=h).reshape(n, h)
    return torch.where(in_range & mask[:, None], nbr, n).to(torch.int32)


def build_neighbor_table(
    grid_coord: torch.Tensor,
    batch: torch.Tensor,
    mask: torch.Tensor,
    depth: int,
    kernel_size: int = 3,
    num_scenes: int = 1,
) -> torch.Tensor:
    """For each point, the index of the point at ``grid_coord + offset`` for
    every kernel offset, or ``N`` when the voxel is unoccupied.

    Neighborhoods are symmetric (``offs[K-1-t] = -offs[t]``), so only the
    first half of the offsets is looked up and the other half is one
    scatter. CONTRACT: voxels are unique per scene (the GridSample
    invariant)."""
    n = grid_coord.shape[0]
    offs = kernel_offsets(kernel_size, grid_coord.device)
    half = offs.shape[0] // 2
    keys, key_bits = _padded_keys(grid_coord, batch, mask, depth, num_scenes)
    nbr_h = _offset_lookup(grid_coord, batch, mask, depth, keys, key_bits,
                           offs[:half])

    # mirror scatter: nbr_h[i, t] = m  =>  neighbor[m, k-1-t] = i; row n of
    # the scratch buffer absorbs missing entries
    arange = _arange(n, grid_coord, torch.int32)
    mirror = torch.full((n + 1, half), n, dtype=torch.int32, device=grid_coord.device)
    cols = _arange(half, grid_coord).expand(n, half)
    mirror[nbr_h.long(), cols] = arange[:, None].expand(n, half)
    mirror = mirror[:n].flip(1)
    center = torch.where(mask, arange, n)[:, None]
    return torch.cat([nbr_h, center, mirror], dim=1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _k5_static_maps():
    """``(k3_map, shell_half)``: the k3 index of each k5 offset with
    Chebyshev radius <= 1 (else -1), and the 49 first-half k5 offsets on the
    radius-2 shell."""
    offs5 = np.array([(x, y, z) for x in range(-2, 3) for y in range(-2, 3)
                      for z in range(-2, 3)])
    idx3 = {(x, y, z): ((x + 1) * 3 + (y + 1)) * 3 + (z + 1)
            for x in (-1, 0, 1) for y in (-1, 0, 1) for z in (-1, 0, 1)}
    k3_map = np.array([idx3.get(tuple(o), -1) if np.abs(o).max() <= 1 else -1
                       for o in offs5], np.int64)
    shell_half = np.array([j for j in range(62) if np.abs(offs5[j]).max() == 2],
                          np.int64)
    return k3_map, shell_half


def build_k5_shell_table(
    grid_coord: torch.Tensor,
    batch: torch.Tensor,
    mask: torch.Tensor,
    n3: torch.Tensor,
    depth: int,
    num_scenes: int = 1,
) -> torch.Tensor:
    """Exact 5x5x5 submanifold neighbor table from the k3 table ``n3`` plus
    a lookup over only the radius-2 shell (49 queries, mirrored to 98).
    Same unique-voxels contract as `build_neighbor_table`."""
    k3_map, shell_half = _k5_static_maps()
    dev = grid_coord.device
    n = grid_coord.shape[0]
    keys, key_bits = _padded_keys(grid_coord, batch, mask, depth, num_scenes)
    shell = torch.as_tensor(shell_half, device=dev)
    nbr_s = _offset_lookup(grid_coord, batch, mask, depth, keys, key_bits,
                           kernel_offsets(5, dev)[shell])
    h = shell.shape[0]
    out = torch.full((n + 1, 125), n, dtype=torch.int32, device=dev)
    # radius-<=1 columns straight from the k3 table
    k3_cols = np.nonzero(k3_map >= 0)[0]
    out[:n, torch.as_tensor(k3_cols, device=dev)] = n3[:, torch.as_tensor(
        k3_map[k3_cols], device=dev)].to(torch.int32)
    out[:n, shell] = nbr_s
    # mirror scatter: nbr_s[i, t] = m  =>  out[m, 124 - shell_half[t]] = i
    out[nbr_s.long(), (124 - shell)[None, :].expand(n, h)] = (
        _arange(n, grid_coord, torch.int32)[:, None].expand(n, h))
    return out[:n]


# ---------------------------------------------------------------------------
# Multigrid parity lookup: exact neighbor tables with no sorting. A stride-2
# pooled level's clusters are the 2x2x2 voxel blocks of its parent, so
# (cluster slot, voxel-parity bits) <-> parent voxel is a bijection per
# scene, and every target voxel of a |d|_inf <= 2 offset lies in a block of
# the child's own 3x3x3 neighborhood, which the child's k3 table indexes.
# ---------------------------------------------------------------------------


def _parity_bits(gc: torch.Tensor) -> torch.Tensor:
    """(N, 3) voxel coords -> (N,) 3-bit position within its 2x2x2 block."""
    return ((gc[:, 0] & 1) << 2) | ((gc[:, 1] & 1) << 1) | (gc[:, 2] & 1)


def build_cluster_members(
    parent_inverse: torch.Tensor,
    grid_coord: torch.Tensor,
    mask: torch.Tensor,
    m: int,
) -> torch.Tensor:
    """(M+1, 8) table: ``members[cluster, parity] = parent index`` (or N).
    Parents of the overflow cluster (slot m-1) and padding go to row m,
    which is re-armed as the empty sentinel."""
    n = grid_coord.shape[0]
    row = torch.where(mask & (parent_inverse < m - 1), parent_inverse.long(), m)
    members = torch.full((m + 1, 8), n, dtype=torch.int32, device=grid_coord.device)
    members[row, _parity_bits(grid_coord).long()] = _arange(n, grid_coord, torch.int32)
    members[m] = n
    return members


@functools.lru_cache(maxsize=None)
def _parity_select_tables(kernel_size: int) -> np.ndarray:
    """(8, K) indices into the flattened (27*8) member block: for parity
    bits r and offset d, the target's block is ``floor((r+d)/2)`` relative
    to the point's own and its member slot is ``(r+d) & 1``."""
    r = kernel_size // 2
    offs = [(x, y, z) for x in range(-r, r + 1) for y in range(-r, r + 1)
            for z in range(-r, r + 1)]
    sel = np.zeros((8, len(offs)), np.int64)
    for pi in range(8):
        pb = ((pi >> 2) & 1, (pi >> 1) & 1, pi & 1)
        for c, d in enumerate(offs):
            e = [(pb[a] + d[a]) // 2 for a in range(3)]
            sb = [(pb[a] + d[a]) % 2 for a in range(3)]
            cidx = ((e[0] + 1) * 3 + (e[1] + 1)) * 3 + (e[2] + 1)
            sel[pi, c] = cidx * 8 + ((sb[0] << 2) | (sb[1] << 1) | sb[2])
    return sel


def parity_neighbor_table(
    grid_coord: torch.Tensor,
    mask: torch.Tensor,
    depth: int,
    parent_inverse: torch.Tensor,
    child_nbr: torch.Tensor,
    kernel_size: int = 3,
) -> torch.Tensor:
    """Exact submanifold neighbor table (kernel 3 or 5) through the stride-2
    child level's cluster structure: row gathers and a static select, no
    sort. Exact only when the child dropped no point to its overflow slot
    (`build_pyramid` checks that) and voxels are unique per scene.

    Args:
      grid_coord/mask/depth: the PARENT level's voxels (N points).
      parent_inverse: (N,) parent index -> child cluster slot.
      child_nbr: (M, 27) the child level's k3 table (missing = M).
    Returns (N, K) int32; N marks a missing neighbor.
    """
    if kernel_size not in (3, 5):
        raise ValueError("parity lookup supports kernel 3 or 5 only")
    dev = grid_coord.device
    sel_tab = torch.as_tensor(_parity_select_tables(kernel_size), device=dev)
    n = grid_coord.shape[0]
    m = child_nbr.shape[0]
    members = build_cluster_members(parent_inverse, grid_coord, mask, m)
    own = torch.where(mask & (parent_inverse < m - 1), parent_inverse.long(), m)
    nbr_rows = child_nbr[own.clamp(max=m - 1)].long()
    nbr_rows = torch.where((own < m)[:, None], nbr_rows, m)  # (N, 27)
    # each point's 27 adjacent member rows, then its parity class's columns
    blocks = members[nbr_rows].reshape(n, 27 * 8)
    nb = blocks.gather(1, sel_tab[_parity_bits(grid_coord).long()])
    t = grid_coord.to(torch.int64)[:, None, :] + kernel_offsets(kernel_size, dev)[None]
    in_range = ((t >= 0) & (t < (1 << depth))).all(dim=-1) & mask[:, None]
    return torch.where(in_range, nb, n).to(torch.int32)


def _k3_from_k5_cols():
    """k5 column index of each k3 offset (k3 enumeration order)."""
    return tuple((x + 2) * 25 + (y + 2) * 5 + (z + 2)
                 for x in (-1, 0, 1) for y in (-1, 0, 1) for z in (-1, 0, 1))


K3_FROM_K5_COLS = _k3_from_k5_cols()


@functools.lru_cache(maxsize=None)
def _k5_decompositions():
    """For every k5 offset d, all (a, b) k3-offset pairs with a + b = d:
    (125, R) index pairs, padded by repeating the first candidate."""
    offs3 = [(x, y, z) for x in (-1, 0, 1) for y in (-1, 0, 1) for z in (-1, 0, 1)]
    idx3 = {o: i for i, o in enumerate(offs3)}
    offs5 = [(x, y, z) for x in range(-2, 3) for y in range(-2, 3)
             for z in range(-2, 3)]
    cands = []
    for d in offs5:
        pairs = []
        for a in offs3:
            b = tuple(int(d[i] - a[i]) for i in range(3))
            if b in idx3:
                pairs.append((idx3[a], idx3[b]))
        cands.append(pairs)
    r = max(len(p) for p in cands)
    a_idx = np.zeros((125, r), np.int64)
    b_idx = np.zeros((125, r), np.int64)
    for j, pairs in enumerate(cands):
        for t in range(r):
            a_idx[j, t], b_idx[j, t] = pairs[min(t, len(pairs) - 1)]
    return a_idx, b_idx


def compose_k5_table(n3: torch.Tensor) -> torch.Tensor:
    """The k5 table as the 2-hop closure of the k3 table: the neighbor at
    offset d = a + b is reached through any occupied voxel at offset a
    (min over candidate paths; the sentinel N dominates)."""
    a_idx, b_idx = _k5_decompositions()
    n = n3.shape[0]
    padded = torch.cat([n3, n3.new_full((1, n3.shape[1]), n)])  # row n: missing
    rows = padded[n3.long()]  # (N, 27, 27): rows[i, a, b]
    cand = rows[:, torch.as_tensor(a_idx, device=n3.device),
                torch.as_tensor(b_idx, device=n3.device)]
    return cand.min(dim=-1).values
