"""Shared geometry pyramid: serialization and pooling structure per level.

Port of `cdsegnet_tpu/models/pyramid.py`, with the metric-grid pyramid of
the kNN models (`build_metric_pyramid`). Both CDSegNet branches run on the
same points, and the c-branch strides visit a subset of the n-branch grids,
so codes, sort orders, neighbor tables and cluster maps are built once per
level and shared. Levels have static capacities; padding and empty slots
carry the sentinel scene id and ``mask=False``, and the last slot of each
pooled level absorbs cluster overflow and is always invalid.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from cdsegnet_torch.models.structure import (
    K3_FROM_K5_COLS,
    PointBatch,
    _inverse,
    build_k5_shell_table,
    build_neighbor_table,
    packed_sort,
    parity_neighbor_table,
    serialize,
)
from cdsegnet_torch.ops import segments as seg_ops
from cdsegnet_torch.utils import tracing


@dataclasses.dataclass
class Level:
    """Geometry of one resolution level (static size M)."""

    point: PointBatch  # feat unused; geometry, codes, orders, tables
    # pooling maps from the parent level (None at level 0):
    pool_sort: Optional[torch.Tensor] = None  # (Mp,) parent indices, key-sorted
    pool_seg: Optional[torch.Tensor] = None  # (Mp,) segment id per sorted pos
    pool_valid: Optional[torch.Tensor] = None  # (Mp,) contribution validity
    parent_inverse: Optional[torch.Tensor] = None  # (Mp,) parent -> slot
    parent_head: Optional[torch.Tensor] = None  # (M,) head parent index
    # number of valid parent points routed to the overflow slot when pooling
    # into this level: an int32 scalar tensor from `build_pooled_level` and
    # `build_metric_level`, a Python int once `build_pyramid` (or PTv2's
    # `precompute_geometry`) has read it (None at level 0)
    dropped: Optional[object] = None

    @property
    def size(self) -> int:
        return self.point.num_points

    def replace(self, **changes) -> "Level":
        return dataclasses.replace(self, **changes)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_level0(point: PointBatch, orders: Tuple[str, ...],
                 perm: Optional[Sequence[int]] = None) -> Level:
    """Level 0: the serialized input points, curves shuffled by ``perm``
    (neighbor tables come later, from `build_pyramid`)."""
    return Level(point=serialize(point, orders=orders, perm=perm))


def build_pooled_level(parent: Level, stride: int, capacity: int,
                       perm: Optional[Sequence[int]] = None) -> Level:
    """Derive the coarse level geometry from ``parent`` (no features): cluster
    by the first (possibly shuffled) order's code right-shifted
    3*log2(stride) bits, take head grid coords and mean coords, re-serialize
    at reduced depth on the parent's curves, then shuffle those by ``perm``.
    Neighbor tables come later, from `build_pyramid`."""
    pd = (stride - 1).bit_length()  # log2(stride)
    pp = parent.point
    mp = pp.num_points
    m = capacity
    dev = pp.coord.device

    sort0 = pp.orders[0]
    keys_sorted = pp.codes_sorted[0] >> (3 * pd)
    seg = seg_ops.sorted_segment_ids(keys_sorted)  # ascending per sorted pos
    seg_c = torch.clamp(seg, max=m - 1).to(torch.int32)
    mask_sorted = pp.mask_sorted[0]
    valid = mask_sorted & (seg < m - 1)
    dropped = (mask_sorted & (seg >= m - 1)).sum().to(torch.int32)

    first_pos = seg_ops.segment_first_position(seg_c, m)
    head_parent = sort0[first_pos]  # (M,) parent index of each cluster head
    new_mask = seg_ops.segment_any(valid, seg_c, m)

    grid = torch.where(new_mask[:, None], pp.grid_coord[head_parent] >> pd, 0)
    batch = torch.where(new_mask, pp.batch[head_parent], pp.num_scenes)
    coord = seg_ops.segment_reduce(pp.coord[sort0], seg_c, m, reduce="mean",
                                   valid=valid)
    parent_inverse = torch.zeros(mp, dtype=torch.int32, device=dev)
    parent_inverse[sort0.long()] = seg_c

    # every point of a cluster shares the shifted code on every curve (the
    # high bits encode the coarse cell), so the heads give all child codes
    head_codes = pp.codes[:, head_parent] >> (3 * pd)
    iota_m = torch.arange(m, dtype=torch.int32, device=dev)
    used = iota_m <= torch.clamp(seg[-1], max=m - 1)
    # unused-slot sentinel: one above the child key range, so it survives
    # the packed sort's 63-bit budget and stays above every real code
    kb_child = 3 * (pp.depth - pd) + max(pp.num_scenes.bit_length(), 1)
    codes = torch.where(used[None, :], head_codes, 1 << kb_child)  # (O, M)

    # curve 0 is free: clusters are numbered by rank along curve 0, so the
    # child's order and inverse are the identity and codes[0] is sorted
    order, inverse, codes_sorted = iota_m[None], iota_m[None], codes[:1]
    if len(codes) > 1:  # the tail curves: one packed sort each
        order_t, cs_t = map(torch.stack, zip(*(packed_sort(c, kb_child + 1)
                                               for c in codes[1:])))
        order = torch.cat([order, order_t])
        inverse = torch.cat([inverse, _inverse(order_t)])
        codes_sorted = torch.cat([codes_sorted, cs_t])
    if perm is not None:
        perm = list(perm)
        codes, order, inverse, codes_sorted = (
            codes[perm], order[perm], inverse[perm], codes_sorted[perm])

    child = PointBatch(
        coord=coord,
        grid_coord=grid.to(torch.int32),
        feat=torch.zeros((m, 1), dtype=torch.float32, device=dev),
        mask=new_mask,
        batch=batch.to(torch.int32),
        codes=codes,
        orders=order,
        inverses=inverse,
        codes_sorted=codes_sorted,
        batch_sorted=batch.to(torch.int32)[order.long()],
        mask_sorted=new_mask[order.long()],
        depth=pp.depth - pd,
        num_scenes=pp.num_scenes,
    )
    return Level(
        point=child, pool_sort=sort0, pool_seg=seg_c, pool_valid=valid,
        parent_inverse=parent_inverse, parent_head=head_parent, dropped=dropped,
    )


def build_metric_level(parent: Level, grid_size: float, capacity: int) -> Level:
    """Derive a coarse level by metric voxel clustering (reference PTv2
    `GridPool`, `point_transformer_v2m2_base.py:229-269`): voxelize ``coord -
    per-scene min`` at ``grid_size``, cluster equal voxels by one stable
    argsort of their int64 keys (scene, x, y, z), mean coords. The level has
    no codes, orders or neighbor tables: kNN models need coords and masks
    only; their means repeat run to run (`segments.segment_reduce` sums
    each cluster in order). ``dropped`` is the int32 count of valid parent
    points routed to the overflow slot."""
    pp = parent.point
    mp, m, s = pp.num_points, capacity, pp.num_scenes
    dev = pp.coord.device
    batch_c = torch.clamp(pp.batch, max=s).long()
    masked = torch.where(pp.mask[:, None], pp.coord, torch.full_like(pp.coord, 1e9))
    cmin = torch.full((s + 1, 3), float("inf"), dtype=torch.float32, device=dev)
    cmin.scatter_reduce_(0, batch_c[:, None].expand(-1, 3), masked, "amin",
                         include_self=True)
    rel = pp.coord - cmin[batch_c]
    # a true division by a device tensor (not a multiplication by the
    # reciprocal of a host scalar), as JAX divides
    vox = torch.floor(rel / torch.full_like(rel, grid_size)).to(torch.int64)
    vox = torch.clamp(vox, 0, (1 << 20) - 1)
    key = (batch_c << 60) | (vox[:, 0] << 40) | (vox[:, 1] << 20) | vox[:, 2]
    key = torch.where(pp.mask, key, torch.iinfo(torch.int64).max)
    sort0 = torch.argsort(key, stable=True).to(torch.int32)
    seg = seg_ops.sorted_segment_ids(key[sort0])
    seg_c = torch.clamp(seg, max=m - 1).to(torch.int32)
    mask_sorted = pp.mask[sort0]
    valid = mask_sorted & (seg < m - 1)
    dropped = (mask_sorted & (seg >= m - 1)).sum().to(torch.int32)

    first_pos = seg_ops.segment_first_position(seg_c, m)
    head_parent = sort0[first_pos]
    new_mask = seg_ops.segment_any(valid, seg_c, m)
    batch = torch.where(new_mask, pp.batch[head_parent], s).to(torch.int32)
    coord = seg_ops.segment_reduce(pp.coord[sort0], seg_c, m, reduce="mean",
                                   valid=valid)
    grid = torch.where(new_mask[:, None], vox[head_parent], 0).to(torch.int32)
    parent_inverse = torch.zeros(mp, dtype=torch.int32, device=dev)
    parent_inverse[sort0.long()] = seg_c
    child = PointBatch(
        coord=coord, grid_coord=grid,
        feat=torch.zeros((m, 1), dtype=torch.float32, device=dev),
        mask=new_mask, batch=batch, depth=pp.depth, num_scenes=s)
    return Level(point=child, pool_sort=sort0, pool_seg=seg_c, pool_valid=valid,
                 parent_inverse=parent_inverse, parent_head=head_parent,
                 dropped=dropped)


def build_metric_pyramid(point: PointBatch, grid_sizes: Sequence[float],
                         capacities: Sequence[int]) -> List[Level]:
    """Metric-grid pyramid for kNN models: level 0 is the raw batch (no
    serialization or neighbor tables), each deeper level clusters its parent
    at the next grid size (reference PTv2 ``grid_sizes=(0.06, 0.12, 0.24,
    0.48)``, `point_transformer_v2m2_base.py:465`)."""
    levels = [Level(point=point)]
    for gs, cap in zip(grid_sizes, capacities):
        levels.append(build_metric_level(levels[-1], gs, cap))
    return levels


def _k3(pt: PointBatch) -> torch.Tensor:
    return build_neighbor_table(pt.grid_coord, pt.batch, pt.mask, depth=pt.depth,
                                kernel_size=3, num_scenes=pt.num_scenes)


def _sorted_tables(levels, n_pool, want_k5):
    """Per-level sorted exact builds, fine-level k5 stem included; exact
    whatever overflowed. Tables are listed coarse -> fine."""
    tables = [_k3(levels[lv].point) for lv in range(n_pool - 1, -1, -1)]
    stem = tables[-1]
    if want_k5:
        p0 = levels[0].point
        stem = build_k5_shell_table(p0.grid_coord, p0.batch, p0.mask, tables[-1],
                                    depth=p0.depth, num_scenes=p0.num_scenes)
    return tables, stem


def _parity_chain(levels, n_pool, want_k5):
    """Parity gathers coarse -> fine through each stride-2 child; exact only
    when no pooled level dropped a point."""
    child_tbl = levels[-1].point.neighbor_idx
    tables, stem = [], None
    for lv in range(n_pool - 1, -1, -1):
        pt = levels[lv].point
        k = 5 if (want_k5 and lv == 0) else 3
        tbl = parity_neighbor_table(pt.grid_coord, pt.mask, pt.depth,
                                    levels[lv + 1].parent_inverse, child_tbl,
                                    kernel_size=k)
        if k == 5:
            stem = tbl
            tbl = tbl[:, list(K3_FROM_K5_COLS)]
        tables.append(tbl)
        child_tbl = tbl
    return tables, tables[-1] if stem is None else stem


def build_pyramid(
    point: PointBatch,
    strides: Sequence[int],
    capacities: Sequence[int],
    orders: Tuple[str, ...],
    stem_kernel: int = 5,
    exactness: str = "cond",
    perms: Optional[Sequence[Sequence[int]]] = None,
) -> Tuple[List[Level], torch.Tensor]:
    """Full geometry pyramid and the level-0 stem neighbor table.

    Phase 1 (fine -> coarse) serializes and pools. Phase 2 (coarse -> fine)
    builds the neighbor tables: the coarsest level by a sorted exact lookup,
    every finer one either by the parity chain or by sorted builds.

    ``exactness``: ``"cond"`` reads the per-level dropped counts from the
    device once (the only host read of the build), takes the parity chain
    when nothing dropped and the sorted builds otherwise; ``"parity"`` and
    ``"sorted"`` force one side. After the build every pooled level's
    ``dropped`` is a Python int.

    ``perms`` (training's curve shuffle) gives one permutation of the orders
    per level, level 0 first, as JAX's ``jax.random.permutation`` of
    ``jax.random.split(shuffle_key, len(strides) + 1)[i]`` does.
    """
    with tracing.span("geometry"):
        return _build_pyramid(point, strides, capacities, orders, stem_kernel, exactness, perms)


def _build_pyramid(point, strides, capacities, orders, stem_kernel, exactness, perms):
    if exactness not in ("cond", "parity", "sorted"):
        raise ValueError(f"unknown exactness {exactness!r}")
    if perms is None:
        perms = [None] * (len(strides) + 1)
    elif len(perms) != len(strides) + 1:
        raise ValueError(f"need {len(strides) + 1} permutations, got {len(perms)}")
    levels = [build_level0(point, orders, perms[0])]
    for s, cap, perm in zip(strides, capacities, perms[1:]):
        levels.append(build_pooled_level(levels[-1], s, cap, perm))
    n_pool = len(levels) - 1
    if n_pool:
        drops = torch.stack([lv.dropped for lv in levels[1:]]).tolist()
        if tracing.enabled():
            for i, d in enumerate(drops, 1):
                tracing.count(f"pyramid.dropped_l{i}", d)
        levels = [levels[0]] + [lv.replace(dropped=int(d))
                                for lv, d in zip(levels[1:], drops)]

    last = levels[-1].point
    levels[-1] = levels[-1].replace(point=last.replace(neighbor_idx=_k3(last)))
    want_k5 = stem_kernel == 5
    if not n_pool:  # level 0 is the coarsest level built above
        p0 = levels[0].point
        stem = p0.neighbor_idx if not want_k5 else build_k5_shell_table(
            p0.grid_coord, p0.batch, p0.mask, p0.neighbor_idx,
            depth=p0.depth, num_scenes=p0.num_scenes)
        return levels, stem

    parity_ok = all(s == 2 for s in strides)  # needs an unbroken stride-2 chain
    if exactness == "sorted" or not parity_ok:
        use_parity = False
    elif exactness == "parity":
        use_parity = True
    else:
        use_parity = sum(lv.dropped for lv in levels[1:]) == 0
        if not use_parity:
            tracing.count("pyramid.sorted_build")
    build = _parity_chain if use_parity else _sorted_tables
    tables, stem_nbr = build(levels, n_pool, want_k5)
    for tbl, lv in zip(tables, range(n_pool - 1, -1, -1)):
        levels[lv] = levels[lv].replace(
            point=levels[lv].point.replace(neighbor_idx=tbl))
    return levels, stem_nbr


def pool_features(feat: torch.Tensor, level: Level, reduce: str = "max") -> torch.Tensor:
    """Reduce parent features (Mp, C) into this level's slots (M, C)."""
    return seg_ops.segment_reduce(feat[level.pool_sort], level.pool_seg,
                                  level.size, reduce=reduce, valid=level.pool_valid)


def pool_head_gather(x: torch.Tensor, level: Level) -> torch.Tensor:
    """Gather a parent per-point array at each cluster's head (e.g. t_emb)."""
    # index_select: its backward scatters with index_add_, so the many empty
    # slots that share one head index do not form a serial run
    out = x.index_select(0, level.parent_head)
    return torch.where(level.point.mask[:, None], out, torch.zeros_like(out))


def unpool_features(feat: torch.Tensor, level: Level) -> torch.Tensor:
    """Broadcast level features (M, C) back to parent points (Mp, C); the
    overflow/trash slot is zeroed so dropped points receive no signal."""
    safe = torch.where(level.point.mask[:, None], feat, torch.zeros_like(feat))
    return safe.index_select(0, level.parent_inverse)  # many-to-one, as above
