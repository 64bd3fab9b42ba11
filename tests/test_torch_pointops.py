"""The port's neighborhood ops and metric pyramid against the JAX package:
`knn` (with and without scene ids and masks, guard rows, exact ties from
duplicated points, near-empty scenes), its compacted path against the dense
plain version, `ball_query`, `grouping`, `three_interpolation`,
`knn_remap_labels` and `build_metric_pyramid` (every `Level` field). Inputs
are made with numpy from a seed."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cdsegnet_tpu.models import pyramid as jpyr  # noqa: E402
from cdsegnet_tpu.models.structure import make_point_batch as jmake  # noqa: E402
from cdsegnet_tpu.ops import pointops as jops  # noqa: E402
from cdsegnet_torch.models import pyramid as tpyr  # noqa: E402
from cdsegnet_torch.models.structure import make_point_batch as tmake  # noqa: E402
from cdsegnet_torch.ops import pointops as tops  # noqa: E402

torch.set_num_threads(2)
T = lambda x: None if x is None else torch.from_numpy(np.asarray(x))
J = lambda x: None if x is None else jnp.asarray(x)


def cloud(seed, n=600, scenes=3):
    """Coordinates with exact duplicates (a run copied, one point repeated),
    a validity mask and sorted scene ids: ``scenes`` random scenes, then a
    scene of 2 valid points, then padding (the sentinel id, invalid)."""
    rng = np.random.RandomState(seed)
    coord = (rng.rand(n, 3) * np.array([2.0, 1.5, 1.0])).astype(np.float32)
    coord[120:170] = coord[60:110]
    coord[300:312] = coord[300]
    batch = np.sort(rng.randint(0, scenes, n)).astype(np.int32)
    mask = rng.rand(n) > 0.15
    batch[n - 42:n - 40], mask[n - 42:n - 40] = scenes, True
    batch[n - 40:], mask[n - 40:] = scenes + 1, False
    return coord, mask, batch


KNN_CASES = {
    "plain": dict(masks=False, ids=False, k=16),
    "masked": dict(masks=True, ids=False, k=16),
    "scenes": dict(masks=True, ids=True, k=16),
    "scenes_k1": dict(masks=True, ids=True, k=1),
    "more_than_a_scene": dict(masks=True, ids=True, k=48),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(KNN_CASES))
def test_knn_matches_jax(case, seed):
    c = KNN_CASES[case]
    coord, mask, batch = cloud(seed)
    kw = dict(query_mask=mask if c["masks"] else None, ref_mask=mask if c["masks"] else None,
              query_batch=batch if c["ids"] else None, ref_batch=batch if c["ids"] else None)
    ji, jd = jops.knn(J(coord), J(coord), c["k"], chunk=256,
                      **{k: J(v) for k, v in kw.items()})
    ti, td = tops.knn(T(coord), T(coord), c["k"], **{k: T(v) for k, v in kw.items()})
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    n = len(coord)
    if c["masks"]:  # invalid queries: the guard row and BIG
        assert (ti.numpy()[~mask] == n).all()
        assert (td.numpy()[~mask] == np.float32(tops.BIG)).all()
    if c["k"] > 2 and c["ids"]:  # the 2-point scene fills 2 slots, then N
        tail = ti.numpy()[n - 42:n - 40]
        assert (tail[:, 2:] == n).all() and (tail[:, :2] < n).all()


def test_knn_ties_go_to_the_lower_index():
    """Eight copies of one point around a query at the same distance: the
    k nearest are the lowest indices, in index order, as `lax.top_k` gives
    them."""
    rng = np.random.RandomState(5)
    ref = rng.rand(40, 3).astype(np.float32) + 5.0
    ref[[3, 7, 11, 19, 23, 29, 31, 37]] = 0.5
    query = np.full((2, 3), 0.5, np.float32)
    ji, _ = jops.knn(J(query), J(ref), 5)
    ti, td = tops.knn(T(query), T(ref), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy()[0], [3, 7, 11, 19, 23])
    assert (td.numpy() == 0).all()


@pytest.mark.parametrize("chunk", [None, 7])
@pytest.mark.parametrize("case", list(KNN_CASES))
def test_compacted_knn_equals_the_dense_plain_version(case, chunk):
    c = KNN_CASES[case]
    coord, mask, batch = cloud(2)
    kw = dict(query_mask=T(mask) if c["masks"] else None,
              ref_mask=T(mask) if c["masks"] else None,
              query_batch=T(batch) if c["ids"] else None,
              ref_batch=T(batch) if c["ids"] else None)
    ci, cd = tops.knn(T(coord), T(coord), c["k"], chunk=chunk, **kw)
    di, dd = tops.knn_dense(T(coord), T(coord), c["k"], chunk=128, **kw)
    assert torch.equal(ci, di) and torch.equal(cd, dd)


def test_knn_between_two_clouds_matches_jax():
    coord, mask, batch = cloud(3)
    rng = np.random.RandomState(3)
    q = coord[::3] + rng.rand(200, 3).astype(np.float32) * 0.01
    qm, qb = mask[::3], batch[::3]
    ji, jd = jops.knn(J(q), J(coord), 8, J(qm), J(mask), query_batch=J(qb), ref_batch=J(batch))
    ti, td = tops.knn(T(q), T(coord), 8, T(qm), T(mask), query_batch=T(qb), ref_batch=T(batch))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)


def test_ball_query_and_grouping_match_jax():
    coord, mask, _ = cloud(4)
    ji, jd = jops.ball_query(J(coord), J(coord), 0.1, 12, J(mask), J(mask))
    ti, td = tops.ball_query(T(coord), T(coord), 0.1, 12, T(mask), T(mask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    feat = np.random.RandomState(4).randn(len(coord), 5).astype(np.float32)
    got = tops.grouping(T(feat), ti)
    want = np.asarray(jops.grouping(J(feat), ji))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[~mask] == 0).all()  # index N reads zeros


def test_three_interpolation_matches_jax():
    coord, mask, batch = cloud(5)
    src = np.arange(0, len(coord), 4)
    feat = np.random.RandomState(5).randn(len(src), 6).astype(np.float32)
    args = (coord, coord[src], feat, mask, mask[src], batch, batch[src])
    want = np.asarray(jops.three_interpolation(*map(J, args)))
    got = tops.three_interpolation(*map(T, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_knn_remap_labels_matches_jax():
    coord, _, _ = cloud(6)
    sampled = np.unique(np.floor(coord / 0.1), axis=0).astype(np.float32) * 0.1 + 0.05
    pred = np.random.RandomState(6).randint(0, 20, len(sampled)).astype(np.int64)
    want = np.asarray(jops.knn_remap_labels(J(coord), J(sampled), J(pred)))
    got = tops.knn_remap_labels(T(coord), T(sampled), T(pred)).numpy()
    np.testing.assert_array_equal(got, want)


LEVEL_FIELDS = ("pool_sort", "pool_seg", "pool_valid", "parent_inverse", "parent_head",
                "dropped")
POINT_FIELDS = ("coord", "grid_coord", "feat", "mask", "batch")


@pytest.mark.parametrize("caps", [(2048,) * 4, (512, 256, 64, 16)],
                         ids=["fit", "overflow"])
def test_metric_pyramid_matches_jax(caps):
    """Every `Level` field at every level, the counts of dropped points
    included (the second capacities overflow every level)."""
    coord, mask, batch = cloud(7, n=2048, scenes=1)
    coord = coord * 2.0
    grid = np.floor(coord / 0.02).astype(np.int32)
    feat = np.random.RandomState(7).rand(len(coord), 6).astype(np.float32)
    args = dict(coord=coord, feat=feat, grid_coord=grid, batch=batch, mask=mask)
    jl = jax.jit(lambda p: jpyr.build_metric_pyramid(p, (0.06, 0.12, 0.24, 0.48), caps))(
        jmake(**{k: jnp.asarray(v) for k, v in args.items()}, depth=9, num_scenes=2))
    tl = tpyr.build_metric_pyramid(tmake(**args, depth=9, num_scenes=2, device="cpu"),
                                   (0.06, 0.12, 0.24, 0.48), caps)
    drops = [int(lv.dropped) for lv in jl[1:]]
    assert (sum(drops) > 0) == (caps[-1] == 16)
    for a, b in zip(jl[1:], tl[1:]):
        for f in LEVEL_FIELDS:
            x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(y, x, err_msg=f)
        for f in POINT_FIELDS:
            x, y = np.asarray(getattr(a.point, f)), getattr(b.point, f).numpy()
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(y, x, err_msg=f)
        assert (b.point.depth, b.point.num_scenes) == (a.point.depth, a.point.num_scenes)


def test_segment_max_gradient_splits_ties_as_jax():
    """GridPool's segment max after a relu: ties at 0 share the gradient
    equally among the rows at the max, as JAX's scatter-max does (the
    empty initial value is not one of them)."""
    from cdsegnet_tpu.ops import segments as jseg
    from cdsegnet_torch.ops import segments as tseg

    x = np.array([[0.0, 1.0], [0.0, 1.0], [1.0, 0.0], [0.0, 0.0], [2.0, -1.0], [2.0, 3.0]],
                 np.float32)
    seg = np.array([0, 0, 1, 1, 2, 2], np.int32)
    valid = np.array([1, 1, 1, 1, 1, 0], bool)
    w = np.arange(8, dtype=np.float32).reshape(4, 2) + 1
    want = jax.grad(lambda v: (jseg.segment_reduce(v, J(seg), 4, reduce="max",
                                                   valid=J(valid)) * w).sum())(J(x))
    t = T(x).requires_grad_()
    (tseg.segment_reduce(t, T(seg), 4, reduce="max", valid=T(valid)) * T(w)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
    assert t.grad[0, 0] == t.grad[1, 0] == 0.5
