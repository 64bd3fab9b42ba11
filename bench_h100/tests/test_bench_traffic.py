"""The traffic generator: the same seed gives the same inputs, and each
mix's maker is found by its kind."""

from __future__ import annotations

import numpy as np
import pytest

from bench_h100 import manifest, traffic
from bench_h100.tests import tiny


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("mix", [tiny.TRAIN_MIX, tiny.TEST_MIX], ids=["train", "test"])
def test_same_seed_same_inputs(mix):
    seed = 2 ** 33 + 17
    _same(traffic.make(mix, seed)[1], traffic.make(mix, seed)[1])
    other = traffic.make(mix, seed + 1)[1]
    assert not np.array_equal(traffic.make(mix, seed)[1][0]["coord"], other[0]["coord"])


def test_train_buckets_fill_their_slots_with_unique_voxels():
    buckets = traffic.make(tiny.TRAIN_MIX, 5)[1]
    for b in buckets:
        assert b["mask"].sum() == 2 * tiny.TRAIN_MIX["points_per_scene"]
        for s in range(2):
            g = b["grid_coord"][b["batch"] == s]
            assert len(np.unique(g, axis=0)) == len(g)
        assert set(np.unique(b["segment"][b["mask"]])) <= {0, 1, 2, 3, 4, 6}


def test_test_fragments_cover_each_augmentation():
    mix = tiny.TEST_MIX
    frags = traffic.make(mix, 9)[1]
    assert len(frags) >= len(mix["augmentations"])
    for f in frags:
        assert f["feat"].shape[1] == 6 and len(np.unique(f["grid_coord"], axis=0)) == len(f["coord"])


def test_the_shipped_mixes_load():
    assert traffic.load("train_rooms")["points_per_scene"] == 102400
    assert len(traffic.load("test_fragments")["augmentations"]) == 13


@pytest.mark.parametrize("name", sorted({w["traffic"] for w in manifest.benchmark()["workloads"]}))
def test_each_mix_finds_its_maker_and_loop_by_kind(name):
    loop = manifest.loop(traffic.load(name)["kind"])
    assert callable(loop.make) and callable(loop.run)
