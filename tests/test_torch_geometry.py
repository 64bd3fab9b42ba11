"""Port geometry against the JAX package: serialization codes, packed sorts,
neighbor tables and the whole pyramid, equal array for array."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from __graft_entry__ import _synthetic_point_batch  # noqa: E402
from cdsegnet_tpu.models import pyramid as jpyr  # noqa: E402
from cdsegnet_tpu.models import structure as jst  # noqa: E402
from cdsegnet_torch.models import pyramid as tpyr  # noqa: E402
from cdsegnet_torch.models import structure as tst  # noqa: E402
from cdsegnet_torch.ops import serialization as tser  # noqa: E402
from cdsegnet_torch.utils.synthetic import synthetic_arrays  # noqa: E402
from helpers import synthetic_batch  # noqa: E402

torch.set_num_threads(2)
ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")
GOLDEN = json.load(open(os.path.join(os.path.dirname(__file__),
                                     "golden_serialization.json")))
POINT_FIELDS = ("coord", "grid_coord", "feat", "mask", "batch", "codes", "orders",
                "inverses", "codes_sorted", "batch_sorted", "mask_sorted",
                "neighbor_idx")
LEVEL_FIELDS = ("pool_sort", "pool_seg", "pool_valid", "parent_inverse",
                "parent_head")


def T(x):
    return torch.from_numpy(np.array(x))


def to_port(pt):
    return tst.make_point_batch(
        np.array(pt.coord), np.array(pt.feat), np.array(pt.grid_coord),
        np.array(pt.batch), np.array(pt.mask), np.array(pt.segment),
        depth=pt.depth, num_scenes=pt.num_scenes, device="cpu")


def assert_same(got, want, name):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("order", ORDERS)
def test_serialization_golden(order):
    code = tser.encode(torch.tensor(GOLDEN["grid_coord"], dtype=torch.int64),
                       torch.tensor(GOLDEN["batch"], dtype=torch.int64),
                       depth=10, order=order)
    np.testing.assert_array_equal(code.numpy(), np.array(GOLDEN[order], np.int64))


def test_synthetic_scene_matches_jax():
    want = _synthetic_point_batch(4096, 2, depth=8, seed=5)
    got = tst.make_point_batch(**synthetic_arrays(4096, 2, depth=8, seed=5),
                               depth=8, num_scenes=2, device="cpu")
    for f in ("coord", "grid_coord", "feat", "mask", "batch", "segment"):
        assert_same(getattr(got, f), getattr(want, f), f)


def test_packed_sorts_and_lookup_match():
    rng = np.random.RandomState(0)
    keys = rng.randint(0, 1 << 20, size=3000).astype(np.int64)
    order, srt = tst.packed_sort(T(keys), 20)
    stable = torch.sort(T(keys), stable=True)
    assert_same(order, stable.indices.int(), "order")
    assert_same(srt, stable.values, "sorted keys")
    assert_same(tst.packed_argsort(T(keys), 20), order, "argsort")
    # beyond the 63-bit budget: the stable fallback, with a warning
    with pytest.warns(UserWarning, match="plain stable argsort"):
        assert_same(tst.packed_argsort(T(keys), 60), order, "fallback")
    uniq = np.unique(keys)[:1000]
    queries = np.concatenate([uniq[::3], rng.randint(0, 1 << 20, size=500)])
    for max_run in (None, 4):
        want = jst.exact_match_lookup(jnp.asarray(uniq), jnp.arange(len(uniq)),
                                      jnp.asarray(queries), 20, missing=len(uniq),
                                      max_run=max_run)
        got = tst.exact_match_lookup(T(uniq), torch.arange(len(uniq)), T(queries),
                                     20, missing=len(uniq), max_run=max_run)
        assert_same(got, want, f"lookup max_run={max_run}")


def test_neighbor_tables_match_jax():
    pt = synthetic_batch(np.random.RandomState(1), counts=(150, 90),
                         num_points=320, depth=6)
    tp = to_port(pt)
    for k in (3, 5):
        want = jst.build_neighbor_table(pt.grid_coord, pt.batch, pt.mask, depth=6,
                                        kernel_size=k, num_scenes=2)
        got = tst.build_neighbor_table(tp.grid_coord, tp.batch, tp.mask, depth=6,
                                       kernel_size=k, num_scenes=2)
        assert_same(got, want, f"k{k}")
    n3 = np.asarray(jst.build_neighbor_table(pt.grid_coord, pt.batch, pt.mask,
                                             depth=6, num_scenes=2))
    assert_same(tst.build_k5_shell_table(tp.grid_coord, tp.batch, tp.mask, T(n3),
                                         depth=6, num_scenes=2),
                jst.build_k5_shell_table(pt.grid_coord, pt.batch, pt.mask,
                                         jnp.asarray(n3), depth=6, num_scenes=2),
                "k5 shell")
    assert_same(tst.compose_k5_table(T(n3)), jst.compose_k5_table(jnp.asarray(n3)),
                "k5 composed")
    assert tst.K3_FROM_K5_COLS == jst.K3_FROM_K5_COLS


def _surface_batch():
    from cdsegnet_tpu.models.structure import make_point_batch

    a = synthetic_arrays(512, 2, depth=6, seed=3)
    return make_point_batch(**{k: jnp.asarray(v) for k, v in a.items()},
                            depth=6, num_scenes=2)


# (batch, strides, capacities, expected dropped total): a surface batch that
# fits its capacities, and the overflow-forcing batch of test_structure.py
CASES = {
    "no_drop": (_surface_batch, (2, 2, 2), (256, 128, 64), 0),
    "overflow": (lambda: synthetic_batch(np.random.RandomState(0), counts=(150,),
                                         num_points=256, depth=6),
                 (2, 2), (64, 64), None),
}


@pytest.mark.parametrize("case,exactness", [
    ("no_drop", "cond"), ("no_drop", "parity"), ("no_drop", "sorted"),
    ("overflow", "cond")])
def test_pyramid_matches_jax(case, exactness):
    make, strides, caps, dropped = CASES[case]
    pt = make()
    jl, js = jpyr.build_pyramid(pt, strides=strides, capacities=caps, orders=ORDERS,
                                shuffle_key=None, stem_kernel=5, exactness=exactness)
    tl, ts = tpyr.build_pyramid(to_port(pt), strides=strides, capacities=caps,
                                orders=ORDERS, stem_kernel=5, exactness=exactness)
    total = sum(lv.dropped for lv in tl[1:])
    assert total == sum(int(lv.dropped) for lv in jl[1:])
    assert total == dropped if dropped is not None else total > 0
    assert_same(ts, js, "stem_nbr")
    assert len(tl) == len(jl)
    for i, (a, b) in enumerate(zip(jl, tl)):
        for f in POINT_FIELDS:
            assert_same(getattr(b.point, f), getattr(a.point, f), f"L{i}.{f}")
        for f in LEVEL_FIELDS:
            if getattr(a, f) is not None:
                assert_same(getattr(b, f), getattr(a, f), f"L{i}.{f}")


@pytest.mark.parametrize("case", ["no_drop", "overflow"])
def test_shuffled_pyramid_matches_jax(case):
    """Training's curve shuffle: one permutation of the orders per level,
    taken from JAX's own split and permutation of one key."""
    import jax

    make, strides, caps, _ = CASES[case]
    pt = make()
    key = jax.random.PRNGKey(7)
    perms = [np.asarray(jax.random.permutation(k, len(ORDERS))).tolist()
             for k in jax.random.split(key, len(strides) + 1)]
    assert any(p != sorted(p) for p in perms)
    jl, js = jpyr.build_pyramid(pt, strides=strides, capacities=caps, orders=ORDERS,
                                shuffle_key=key, stem_kernel=5)
    tl, ts = tpyr.build_pyramid(to_port(pt), strides=strides, capacities=caps,
                                orders=ORDERS, stem_kernel=5, perms=perms)
    assert_same(ts, js, "stem_nbr")
    for i, (a, b) in enumerate(zip(jl, tl)):
        for f in POINT_FIELDS:
            assert_same(getattr(b.point, f), getattr(a.point, f), f"L{i}.{f}")
        for f in LEVEL_FIELDS:
            if getattr(a, f) is not None:
                assert_same(getattr(b, f), getattr(a, f), f"L{i}.{f}")
    with pytest.raises(ValueError, match="permutations"):
        tpyr.build_pyramid(to_port(pt), strides=strides, capacities=caps,
                           orders=ORDERS, perms=perms[:1])


def test_pool_and_unpool_match_jax():
    pt = _surface_batch()
    jl, _ = jpyr.build_pyramid(pt, strides=(2, 2), capacities=(256, 128),
                               orders=ORDERS, shuffle_key=None, stem_kernel=3)
    tl, _ = tpyr.build_pyramid(to_port(pt), strides=(2, 2), capacities=(256, 128),
                               orders=ORDERS, stem_kernel=3)
    rng = np.random.RandomState(6)
    f0 = rng.randn(512, 7).astype(np.float32)
    f1 = rng.randn(256, 7).astype(np.float32)
    np.testing.assert_allclose(tpyr.pool_features(T(f0), tl[1]).numpy(),
                               np.asarray(jpyr.pool_features(jnp.asarray(f0), jl[1])))
    np.testing.assert_allclose(tpyr.pool_head_gather(T(f0), tl[1]).numpy(),
                               np.asarray(jpyr.pool_head_gather(jnp.asarray(f0), jl[1])))
    np.testing.assert_allclose(tpyr.unpool_features(T(f1), tl[1]).numpy(),
                               np.asarray(jpyr.unpool_features(jnp.asarray(f1), jl[1])))
