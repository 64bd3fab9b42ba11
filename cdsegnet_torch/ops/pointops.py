"""Neighborhood ops over masked static shapes: kNN, ball query, grouping,
3-NN interpolation and the evaluator's 1-NN label remap.

Port of `cdsegnet_tpu/ops/pointops.py` (reference CUDA `libs/pointops`).
The definition is JAX's: squared distances by the expansion
``|q|^2 - 2 q.r + |r|^2`` in float32, BIG added at invalid references and
BIG across scenes, then the k smallest, ties to the lower index first (as
`lax.top_k` orders them). Invalid queries return index N (the guard row)
and distance BIG; a slot with no in-scene valid reference returns N.

`knn_dense` computes that definition as JAX does, every query against every
reference in chunks of rows; it is the plain version, run by the tests and
by `chip_smoke.py`'s check. `knn` computes only valid queries against the
valid references of their own scene (each scene's points sorted in index
order), which gives exactly the dense outputs at a fraction of the work
when a bucket is mostly padding or holds several scenes; it runs as span
``pointops.knn`` and counts ``knn.queries`` and ``knn.pairs``
(`utils.tracing`) from the scene sizes it already holds on the host. On a
CPU tensor each scene runs in tiles of distances and `k_smallest`; on a
CUDA tensor one launch of `cdsegnet_torch/csrc/knn.cu` (`knn_fused`)
computes every distance and keeps the k smallest in registers, writing no
distance to device memory and reading nothing back to the host. The dot
products are elementwise chains of fused multiply-adds, as XLA rounds them
on the CPU, so both forms give the same bits on any device (no TF32, no
tiling-dependent sums) and the same order among near-ties.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from cdsegnet_torch.ops.subm_conv import _gather_rows
from cdsegnet_torch.utils import tracing
from cdsegnet_torch.utils.cuda_build import bind, check_launch, register_launches, stream

BIG = 1e30
# distance elements per tile of `knn` on the CPU: 2^26 float32 (256 MiB)
# and a few temporaries of that size
_TILE = 1 << 26
# the kernel's lengths of the sorted list each query keeps (`knn_slots`)
SLOTS = (1, 4, 8, 16, 32, 64)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a0 b0 + a1 b1 + a2 b2`` as a chain of fused multiply-adds,
    ``fma(a2, b2, fma(a1, b1, a0 b0))``: the rounding of XLA's dot and row
    sum on the CPU (`torch.addcmul` is fused there)."""
    d = a[..., 0] * b[..., 0]
    d = torch.addcmul(d, a[..., 1], b[..., 1])
    return torch.addcmul(d, a[..., 2], b[..., 2])


def _dist2(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Squared distances (M, R) by the expansion ``qq - 2 q.r + rr``,
    clamped at 0."""
    qq = _dot3(q, q)[:, None]
    rr = _dot3(r, r)[None, :]
    d = _dot3(q[:, None, :], r[None, :, :])
    d = torch.add(qq, d, alpha=-2.0)  # qq - 2 cross: the doubling is exact
    d += rr
    return d.clamp_(min=0.0)


def _fix_boundary_ties(d, vals, idx, nxt, k):
    """Rows where the (k+1)-th candidate ties the k-th (below BIG / 2): the
    k-set itself must take the lowest columns among the tied values."""
    rows = torch.nonzero((vals[:, k - 1] == nxt) & (nxt < 0.5 * BIG)).flatten()
    if rows.numel() == 0:
        return vals, idx
    sub = d[rows]
    t = vals[rows, k - 1:k]
    less = sub < t
    eq = sub == t
    room = k - less.sum(1, keepdim=True)
    sel = less | (eq & (torch.cumsum(eq.to(torch.int32), 1) <= room))
    cols = torch.nonzero(sel)[:, 1].reshape(-1, k)  # ascending columns per row
    v, perm = torch.sort(sub.gather(1, cols), dim=1, stable=True)
    vals, idx = vals.clone(), idx.clone()
    vals[rows] = v
    idx[rows] = cols.gather(1, perm)
    return vals, idx


def k_smallest(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest entries of each row of ``d`` (k <= columns) in
    ascending (value, column) order, as `lax.top_k` of ``-d`` gives them:
    ``(values, columns)``.

    `torch.topk` promises no order among equal values. Its k + 1 candidates
    are re-sorted by column and then stably by value; a row whose k-th and
    (k+1)-th values tie (below BIG / 2: larger ones become the guard index)
    takes its k-set again from the whole row, lowest columns first among
    the tied values."""
    cols = d.shape[1]
    kk = min(k + 1, cols)
    vals, idx = torch.topk(d, kk, dim=1, largest=False, sorted=True)
    idx, perm = torch.sort(idx, dim=1)
    vals, perm = torch.sort(vals.gather(1, perm), dim=1, stable=True)
    idx = idx.gather(1, perm)
    if kk == k:
        return vals, idx
    return _fix_boundary_ties(d, vals[:, :k], idx[:, :k], vals[:, k], k)


def _defaults(query, ref, query_mask, ref_mask):
    m, n = query.shape[0], ref.shape[0]
    dev = query.device
    qm = (torch.ones(m, dtype=torch.bool, device=dev) if query_mask is None
          else query_mask.to(torch.bool))
    rm = (torch.ones(n, dtype=torch.bool, device=dev) if ref_mask is None
          else ref_mask.to(torch.bool))
    return qm, rm


def _finish(idx, dist, qm, n):
    """JAX's last step: slots whose candidate was invalid point at the guard
    row, invalid queries get distance BIG."""
    idx = torch.where(qm[:, None] & (dist < 0.5 * BIG), idx, n)
    dist = torch.where(qm[:, None], dist, torch.full_like(dist, BIG))
    return idx.to(torch.int32), dist


def knn_dense(query: torch.Tensor, ref: torch.Tensor, k: int,
              query_mask: Optional[torch.Tensor] = None,
              ref_mask: Optional[torch.Tensor] = None, chunk: int = 2048,
              query_batch: Optional[torch.Tensor] = None,
              ref_batch: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of `knn`: every query against every reference, in
    chunks of ``chunk`` rows, as `cdsegnet_tpu.ops.pointops.knn` computes it
    (BIG added at invalid references, BIG across scenes)."""
    m, n = query.shape[0], ref.shape[0]
    qm, rm = _defaults(query, ref, query_mask, ref_mask)
    query, ref = query.float(), ref.float()
    rbad = torch.where(rm, 0.0, BIG)[None, :].to(torch.float32)
    idxs, dists = [], []
    for s in range(0, m, chunk):
        d = _dist2(query[s:s + chunk], ref) + rbad
        if query_batch is not None:
            same = query_batch[s:s + chunk, None].int() == ref_batch[None, :].int()
            d = torch.where(same, d, torch.full_like(d, BIG))
        v, i = k_smallest(d, k)
        idxs.append(i)
        dists.append(v)
    return _finish(torch.cat(idxs), torch.cat(dists), qm, n)


def _scene_runs(keys: torch.Tensor):
    """``(order, {scene: (start, stop)})``: indices stably sorted by key (so
    ascending within a scene) and each non-negative key's run in them."""
    order = torch.argsort(keys, stable=True)
    uniq, counts = torch.unique_consecutive(keys[order], return_counts=True)
    runs, start = {}, 0
    for u, c in zip(*torch.stack([uniq, counts]).tolist()):
        if u >= 0:
            runs[u] = (start, start + c)
        start += c
    return order, runs


def knn(query: torch.Tensor, ref: torch.Tensor, k: int,
        query_mask: Optional[torch.Tensor] = None,
        ref_mask: Optional[torch.Tensor] = None, chunk: Optional[int] = None,
        query_batch: Optional[torch.Tensor] = None,
        ref_batch: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest references of each query: ``(idx (M, k) int32, dist2 (M, k)
    float32)``, equal to `knn_dense`'s.

    Invalid references never match; invalid queries return index N and
    distance BIG. With ``query_batch``/``ref_batch`` scene ids, neighbors
    never cross scenes; a slot that found no valid in-scene reference (a
    scene smaller than k) returns N and BIG. Each scene's valid queries are
    compared with its valid references only: on the CPU in tiles of about
    2^26 distances (``chunk`` rows when given), on CUDA by the kernel
    (`knn_fused`; ``chunk`` is not used, k at most 64)."""
    with tracing.span("pointops.knn"):
        return _knn(query, ref, k, query_mask, ref_mask, chunk, query_batch, ref_batch)


def _knn(query, ref, k, query_mask, ref_mask, chunk, query_batch, ref_batch):
    m, n = query.shape[0], ref.shape[0]
    dev = query.device
    kernel = dev.type != "cpu"
    if kernel:
        knn_slots(k)  # refuse k before any work
        if dev.type != "cuda":
            raise ValueError(f"no kNN kernel for device {dev}")
    qm, rm = _defaults(query, ref, query_mask, ref_mask)
    query, ref = query.float(), ref.float()
    if query_batch is None:
        qkey, rkey = torch.where(qm, 0, -1), torch.where(rm, 0, -1)
    else:
        qkey = torch.where(qm, query_batch.long(), -1)
        rkey = torch.where(rm, ref_batch.long(), -1)
    q_order, q_runs = _scene_runs(qkey)
    r_order, r_runs = _scene_runs(rkey)
    scenes = []  # (q0, q1, r0, r1) of each scene with queries and references
    for scene, (q0, q1) in q_runs.items():
        if scene in r_runs:
            r0, r1 = r_runs[scene]
            scenes.append((q0, q1, r0, r1))
            tracing.count("knn.queries", q1 - q0)
            tracing.count("knn.pairs", (q1 - q0) * (r1 - r0))
    if kernel:
        return knn_fused(query, ref, k, q_order, r_order, scenes, n)
    idx = torch.full((m, k), n, dtype=torch.int64, device=dev)
    dist = torch.full((m, k), BIG, dtype=torch.float32, device=dev)
    for q0, q1, r0, r1 in scenes:
        ri = r_order[r0:r1]
        r_pts = ref[ri]
        kk = min(k, r1 - r0)
        rows = chunk or max(1, _TILE // (r1 - r0))
        for s in range(q0, q1, rows):
            qi = q_order[s:min(s + rows, q1)]
            v, j = k_smallest(_dist2(query[qi], r_pts), kk)
            idx[qi, :kk] = ri[j]
            dist[qi, :kk] = v
    return _finish(idx, dist, qm, n)


# ---------------------------------------------------------------------------
# the kernel's wrapper (CUDA tensors only)


def knn_slots(k: int) -> int:
    """The kernel's list length for ``k`` neighbours: the smallest of
    `SLOTS` not below k. Raises for k outside 1..64."""
    if not 1 <= k <= SLOTS[-1]:
        raise ValueError(f"the kNN kernel takes 1 to {SLOTS[-1]} neighbours, not {k}")
    return next(s for s in SLOTS if s >= k)


_KNN_ARGS = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 4
             + (ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)))


def _packed(pts: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``(x, y, z, |p|^2)`` of the points ``order`` picks, (len, 4) float32,
    the squared norm in `_dot3`'s rounding."""
    p = pts.index_select(0, order)
    return torch.cat([p, _dot3(p, p)[:, None]], 1).contiguous()


def knn_fused(query: torch.Tensor, ref: torch.Tensor, k: int, q_order: torch.Tensor,
              r_order: torch.Tensor, scenes, guard: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`knn`'s outputs on CUDA tensors from one launch of the kernel:
    ``(idx (M, k) int32, dist (M, k) float32)``.

    ``q_order``/``r_order`` list the valid queries and references sorted by
    scene, ascending index within a scene; ``scenes`` holds each scene's
    ``(q0, q1, r0, r1)`` runs in them (host ints); ``guard`` is N. Rows of
    queries in no run keep index N and distance BIG. ``launches`` counts
    the kernel's launches (one a call of up to 64 scenes)."""
    slots = knn_slots(k)
    if query.device.type != "cuda":
        raise ValueError(f"the kNN kernel runs on CUDA tensors, not {query.device}")
    for name, t in (("query", query), ("ref", ref)):
        if t.dim() != 2 or t.shape[1] != 3 or t.dtype != torch.float32:
            raise TypeError(f"knn_fused: {name} must be float32 (N, 3), got {t.dtype} "
                            f"{tuple(t.shape)}")
    m = query.shape[0]
    idx = torch.full((m, k), guard, dtype=torch.int32, device=query.device)
    dist = torch.full((m, k), BIG, dtype=torch.float32, device=query.device)
    if not scenes:
        return idx, dist
    q_pack, r_pack = _packed(query, q_order), _packed(ref, r_order)
    runs = (ctypes.c_int * (4 * len(scenes)))(*[v for sc in scenes for v in sc])
    launched = ctypes.c_int(0)
    err = bind("knn", "cdseg_knn_fused", _KNN_ARGS)(
        q_pack.data_ptr(), r_pack.data_ptr(), q_order.data_ptr(), r_order.data_ptr(),
        idx.data_ptr(), dist.data_ptr(), runs, len(scenes), k, slots, guard, stream(query),
        ctypes.byref(launched))
    knn_fused.launches += launched.value
    check_launch(err, "knn_fused")
    return idx, dist


register_launches("knn", knn_fused)


def ball_query(query: torch.Tensor, ref: torch.Tensor, radius: float, nsample: int,
               query_mask: Optional[torch.Tensor] = None,
               ref_mask: Optional[torch.Tensor] = None,
               chunk: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``nsample`` references within ``radius``; short lists repeat the
    nearest neighbor (reference ball-query semantics)."""
    idx, dist = knn(query, ref, nsample, query_mask, ref_mask, chunk)
    inside = dist <= radius * radius
    idx = torch.where(inside, idx, idx[:, :1].expand_as(idx))
    dist = torch.where(inside, dist, dist[:, :1].expand_as(dist))
    return idx, dist


def _sq_dist3(coord: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``sum((coord - c)^2, -1)`` as XLA rounds it on the CPU: the three
    squares summed as a chain of fused multiply-adds,
    ``fma(d2, d2, fma(d1, d1, d0 d0))`` (`torch.addcmul`, fused on the CPU
    and on CUDA)."""
    diff = coord - c
    return _dot3(diff, diff)


def farthest_point_sampling(coord: torch.Tensor, n_samples: int,
                            mask: Optional[torch.Tensor] = None,
                            start: int = 0) -> torch.Tensor:
    """Iterative FPS: ``(n_samples,)`` int32 indices, the first ``start``
    (reference `src/sampling`).

    JAX's definition step for step, quirk included: the running minimum
    distance starts at BIG for every point, valid or not, and the mask
    enters only the argmax (-BIG at invalid points). Each pick stays on the
    device (no host read per pick)."""
    n = coord.shape[0]
    dev = coord.device
    valid = (torch.ones(n, dtype=torch.bool, device=dev) if mask is None
             else mask.to(torch.bool))
    neg = torch.full((n,), -BIG, dtype=coord.dtype, device=dev)
    mind = torch.full((n,), BIG, dtype=coord.dtype, device=dev)
    sel = torch.zeros(n_samples, dtype=torch.int64, device=dev)
    sel[0] = start
    last = sel[:1]
    for i in range(1, n_samples):
        mind = torch.minimum(mind, _sq_dist3(coord, coord.index_select(0, last)))
        last = torch.argmax(torch.where(valid, mind, neg)).view(1)
        sel[i:i + 1] = last
    return sel.to(torch.int32)


def farthest_point_sampling_batched(coord: torch.Tensor, batch: torch.Tensor,
                                    mask: torch.Tensor, n_samples: int, stride: int,
                                    num_scenes: int) -> torch.Tensor:
    """Per-scene FPS at ``stride``: ``(n_samples,)`` int32 indices into
    ``coord``, unused slots N (reference `point_transformer_seg.py:93-116`).

    JAX's definition step for step: scene s takes ``count_s // stride``
    picks (at least 1 when it has a valid point); one loop of
    ``n_samples`` picks drives every scene at once, each pick the first
    argmax of ``score = where(eligible, mind, -1)`` over the whole bucket,
    accepted when ``score >= 0`` (coincident points, at distance 0, still
    count), its distances updating only its own scene's running minimum.
    Every scene is so seeded by its first valid slot (its minimum is BIG
    until then). ``ok``, ``pick`` and the picked scene stay 0-dim device
    tensors: the loop makes no host read."""
    n = coord.shape[0]
    dev = coord.device
    coord = coord.float()
    b = torch.where(mask.to(torch.bool), batch.long(), num_scenes)
    counts = torch.zeros(num_scenes + 1, dtype=torch.int64, device=dev)
    counts.index_add_(0, b, torch.ones_like(b))
    quota = counts[:num_scenes] // stride
    quota = torch.where(counts[:num_scenes] > 0, quota.clamp(min=1), 0)
    quota_b = torch.cat([quota, quota.new_zeros(1)])[b]  # each slot's scene quota
    mind = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    chosen = torch.zeros(n, dtype=torch.bool, device=dev)
    taken = torch.zeros(num_scenes + 1, dtype=torch.int64, device=dev)
    sel = torch.full((n_samples,), n, dtype=torch.int64, device=dev)
    neg = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
    guard = torch.full((1,), n, dtype=torch.int64, device=dev)
    for t in range(n_samples):
        eligible = ~chosen & (taken.index_select(0, b) < quota_b)
        score = torch.where(eligible, mind, neg)
        pick = torch.argmax(score).view(1)
        ok = score.index_select(0, pick) >= 0.0
        pb = b.index_select(0, pick)
        d = _sq_dist3(coord, coord.index_select(0, pick))
        mind = torch.where(ok & (b == pb), torch.minimum(mind, d), mind)
        chosen.scatter_(0, pick, chosen.index_select(0, pick) | ok)
        taken.index_add_(0, pb, ok.long())
        sel[t:t + 1] = torch.where(ok, pick, guard)
    return sel.to(torch.int32)


def grouping(feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather neighbor features ``(M, k, C)``; index N reads zeros. The
    backward scatters with `index_add_` (guard indices repeat)."""
    return _gather_rows(feat, idx).reshape(idx.shape + feat.shape[1:])


def three_interpolation(target_coord: torch.Tensor, source_coord: torch.Tensor,
                        source_feat: torch.Tensor,
                        target_mask: Optional[torch.Tensor] = None,
                        source_mask: Optional[torch.Tensor] = None,
                        target_batch: Optional[torch.Tensor] = None,
                        source_batch: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-distance-weighted 3-NN interpolation (reference
    `src/interpolation`)."""
    idx, d2 = knn(target_coord, source_coord, 3, target_mask, source_mask,
                  query_batch=target_batch, ref_batch=source_batch)
    w = 1.0 / torch.clamp(d2, min=1e-8)
    w = w / w.sum(-1, keepdim=True)
    neigh = grouping(source_feat, idx)  # (M, 3, C)
    return (neigh * w[..., None].to(source_feat.dtype)).sum(1)


def knn_remap_labels(origin_coord: torch.Tensor, sampled_coord: torch.Tensor,
                     sampled_pred: torch.Tensor,
                     origin_mask: Optional[torch.Tensor] = None,
                     sampled_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1-NN label transfer from grid-sampled points to the original points
    (the evaluator's remap, reference `hooks/evaluator.py:132-141`)."""
    idx, _ = knn(origin_coord, sampled_coord, 1, origin_mask, sampled_mask)
    guard = torch.cat([sampled_pred, sampled_pred.new_zeros(1)])
    return guard[idx[:, 0].long()]
