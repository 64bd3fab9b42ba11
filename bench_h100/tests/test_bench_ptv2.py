"""The ``ptv2_scannet.train`` cell: its plain reference against the port at
the tests' size on the CPU, the planted faults and the control against the
cell's own limits, the FLOP count by hand, and, on the card, the kNN tables
of the timed path against the reference's at the cell's own size."""

from __future__ import annotations

import copy
import statistics
import time

import pytest
import torch

from bench_h100 import compare, manifest, program, traffic, weights
from bench_h100.loops.train_buckets import reference_steps
from bench_h100.reference import ptv2 as RP
from bench_h100.reference.nn import Precision

NAME = "ptv2_scannet.train"
SEED = 2 ** 40 + 3
NARROW = dict(patch_embed_channels=8, patch_embed_groups=2, enc_channels=[8, 16, 16, 24],
              enc_groups=[2, 4, 4, 6], dec_channels=[8, 8, 16, 16], dec_groups=[2, 2, 4, 4],
              capacity_div=[1, 1, 2, 4, 8], dtype="float32")
TRAIN_MIX = dict(kind="train_buckets_coord", buckets=4, scenes_per_bucket=3, points_per_scene=1024,
                 cell=0.04, grid_size=0.04)


def tiny_cell():
    """The cell with its widths narrowed, float32, on 3 x 1,024-point
    rooms sampled at 4 cm, with its own limits."""
    c = copy.deepcopy(manifest.cell(NAME))
    c["cfg"]["model"]["backbone"].update(NARROW)
    c["cfg"]["dtype"] = "float32"
    c["traffic"] = TRAIN_MIX
    return c


def _run(seconds, device="cpu", **kw):
    cell = tiny_cell()
    drive = manifest.loop(manifest.traffic_kind(cell["traffic"]))
    run = drive.run(cell, SEED, seconds, False, device, time.perf_counter(), **kw)
    return compare.judge(run["numbers"], cell["limits"])[0], run


def test_the_first_step_agrees():
    cell = tiny_cell()
    cfg = cell["cfg"]
    arch = RP.Arch(cfg["model"])
    mix, buckets = traffic.make(cell["traffic"], SEED)
    scenes = mix["scenes_per_bucket"]
    tb = [{k: torch.as_tensor(v) for k, v in b.items()} for b in buckets]
    model = program.build_model(cfg, weights.make(RP.param_shapes(arch), traffic.derive(SEED, 10),
                                                  "cpu"), "cpu")
    step, opt = program.train_step(cfg, model, 1, "cpu")
    draws = RP.train_draws(arch, tb[0], scenes, traffic.derive(SEED, 20, 0))
    step.generators["dropout"] = program.path_draws(draws.pop("path_masks"))
    loss = float(step(program.to_point(buckets[0], cfg["serialization_depth"], scenes, "cpu"))
                 ["loss"])
    grad = compare.leaf_norms(program.first_gradients(opt, cfg))
    ref = reference_steps(cell, tb, scenes, SEED, Precision("f32"), "cpu")
    assert abs(loss - ref["losses"][0]) <= 1e-5 * abs(ref["losses"][0])
    med = statistics.median(ref["grad"].values())
    for n, r in ref["grad"].items():
        assert abs(grad[n] - r) <= 1e-3 * max(r, med), n


@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
def test_a_broken_step_is_not_correct(fault):
    correct, run = _run(0.5, fault=fault)
    assert not correct, run["numbers"]


def test_the_sound_path_is_correct():
    correct, run = _run(0.5)
    assert correct, run["numbers"]


def test_the_fp8_control_is_not_correct():
    correct, run = _run(0.5, control=True)
    assert not correct, run["numbers"]


def test_forward_flops_by_hand():
    arch = RP.Arch(dict(backbone=dict(
        in_channels=6, num_classes=20, patch_embed_channels=4, patch_embed_groups=2,
        enc_depths=[1], enc_channels=[8], enc_groups=[2], enc_neighbours=[16],
        dec_depths=[1], dec_channels=[4], dec_groups=[2], dec_neighbours=[16],
        grid_sizes=[0.1], capacity_div=[1, 2])))
    stats = [dict(valid=10, k3_pairs=100, k5_pairs=60), dict(valid=3, k3_pairs=9)]

    def blk(v, p, c, g):  # fc1, q, k, v, fc3; position and weight encodings per pair
        return 2 * (5 * v * c * c + p * (3 * c + c * c + c * g + g * g))

    want = 2 * 10 * 6 * 4 + blk(10, 60, 4, 2)  # patch embed
    want += 2 * 10 * 4 * 8 + blk(3, 9, 8, 2)  # GridPool, encoder block
    want += 2 * 3 * 8 * 4 + 2 * 10 * 4 * 4 + blk(10, 100, 4, 2)  # unpool, skip, decoder block
    want += 2 * 10 * 4 * 4 + 2 * 10 * 4 * 20  # head
    assert RP.forward_flops(arch, stats) == want


@pytest.mark.cuda
def test_the_control_is_not_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    correct, run = _run(1.0, device="cuda", control=True)
    assert not correct, run["numbers"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 11])
def test_the_timed_paths_knn_tables_equal_the_references(seed):
    """At the cell's own size (3 x 100,000 points): every level's table of
    the port's geometry, slot for slot, against the reference's blocked
    kNN, guard slots mapped to the reference's slot count; no level drops
    a point."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = manifest.cell(NAME)
    cfg = cell["cfg"]
    arch = RP.Arch(cfg["model"])
    mix, buckets = traffic.make(cell["traffic"], seed)
    scenes = mix["scenes_per_bucket"]
    with torch.device("cuda"):
        model = program.build_model(cfg, weights.make(RP.param_shapes(arch), 0, "cuda"), "cuda")
    for b in buckets[:2]:
        point = program.to_point(b, cfg["serialization_depth"], scenes, "cuda")
        levels, tables = model.backbone.precompute_geometry(point)
        ref = RP.pyramid(arch, {k: torch.as_tensor(v, device="cuda") for k, v in b.items()},
                         scenes)
        assert [lv.dropped for lv in levels[1:]] == [lv["dropped"] for lv in ref[1:]] == [0] * 4
        for i, (t, r) in enumerate(zip(tables, ref)):
            n = r["nbr"].shape[0]
            got = t[:n].long()
            got = torch.where(got >= n, n, got)
            assert int((got != r["nbr"]).sum()) == 0, i
