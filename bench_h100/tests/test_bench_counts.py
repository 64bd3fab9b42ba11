"""The operation and byte counters against counts by hand on tiny shapes."""

from __future__ import annotations

import itertools

import torch

from bench_h100 import counts
from bench_h100.reference import geometry as geo
from bench_h100.reference import spunet as RS


def test_attention_counts_by_hand():
    # 8 slots, 6 valid (3 per scene), heads 2, dim 16, bf16
    fl, nb = counts.attention_fwd(8, 6, 18, 2, 16, "bfloat16")
    assert fl == 4 * 16 * 2 * 18
    assert nb == (8 + 3 * 6) * 2 * 16 * 2 + 5 * 8
    fl, nb = counts.attention_bwd(8, 6, 18, 2, 16, "bfloat16")
    assert fl == 8 * 16 * 2 * 18
    assert nb == 5 * 6 * 2 * 16 * 2 + 4 * 6 * 2 + 3 * 8 * 2 * 16 * 2 + 5 * 8
    assert counts.bound_seconds(989e12, 0, "bfloat16") == 1.0
    assert counts.bound_seconds(0, 3.35e12, "float32") == 1.0


def _level(batch, mask):
    n = len(batch)
    return dict(order=torch.arange(n)[None], batch=torch.tensor(batch), mask=torch.tensor(mask),
                num_scenes=2)


def test_attention_pairs_by_hand():
    # two windows of 4: [s0, s0, s1, pad] and [s1, s1, s1, pad]
    lv = _level([0, 0, 1, 2, 1, 1, 1, 2], [1, 1, 1, 0, 1, 1, 1, 0])
    assert geo.attention_pairs(lv, 4) == (2 * 2 + 1 * 1) + 3 * 3
    brute = sum(lv["batch"][i] == lv["batch"][j] and bool(lv["mask"][j])
                for w in (0, 4) for i, j in itertools.product(range(w, w + 4), repeat=2))
    assert geo.attention_pairs(lv, 4) == int(brute)


def test_neighbor_pairs_and_spunet_flops_by_hand():
    # a 2x2x1 plate of voxels in one scene, and one padding slot
    grid = torch.tensor([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0], [0, 0, 0]])
    mask = torch.tensor([1, 1, 1, 1, 0], dtype=torch.bool)
    batch = torch.tensor([0, 0, 0, 0, 1])
    nbr = geo.neighbor_table(grid, batch, mask, 4, 3)
    assert int((nbr[mask] < 5).sum()) == 16  # every point sees all four
    assert (nbr[4] == 5).all()
    arch = RS.Arch(dict(backbone=dict(in_channels=6, num_classes=20, base_channels=4,
                                      channels=[4, 4, 4, 4, 4, 4, 4, 4],
                                      layers=[1, 1, 1, 1, 1, 1, 1, 1],
                                      capacity_div=[1, 1, 1, 1, 1])))
    stats = [dict(valid=4, k3_pairs=16, k5_pairs=16)] + [dict(valid=1, k3_pairs=1)] * 4
    want = 2 * 16 * 6 * 4  # stem
    want += 2 * 4 * 4 * 4 + 2 * 2 * 1 * 16  # stage 0: down proj on 4 points, a block at level 1
    want += 3 * (2 * 1 * 4 * 4 + 2 * 2 * 1 * 16)  # stages 1-3
    want += 3 * (2 * 1 * 4 * 4 + 2 * 1 * 8 * 4 + 2 * 2 * 1 * 16)  # decoder stages 3-1
    want += 2 * 1 * 4 * 4 + 2 * 4 * 8 * 4 + 2 * 2 * 16 * 16  # decoder stage 0
    want += 2 * 4 * 4 * 20  # head
    assert RS.forward_flops(arch, stats) == want
