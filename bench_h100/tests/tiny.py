"""Cells cut to a size that the CPU runs in seconds, for the tests: the
shipped configurations with their widths narrowed, float32, and rooms
sampled on an 8 cm grid."""

from __future__ import annotations

import copy

from bench_h100 import manifest

NARROW_PTV3 = dict(
    c_enc_depths=[1, 1, 1], c_enc_channels=[8, 16, 16], c_enc_num_head=[1, 2, 2],
    c_enc_patch_size=[64, 64, 64], c_dec_depths=[1, 1], c_dec_channels=[8, 8],
    c_dec_num_head=[1, 1], c_dec_patch_size=[64, 64], n_enc_depths=[1, 1, 1, 1, 1],
    n_enc_channels=[8, 16, 16, 16, 16], n_enc_num_head=[1, 2, 2, 2, 2],
    n_enc_patch_size=[64, 64, 64, 64, 64], n_dec_depths=[1, 1, 1, 1],
    n_dec_channels=[8, 8, 16, 16], n_dec_num_head=[1, 1, 2, 2],
    n_dec_patch_size=[64, 64, 64, 64], mlp_ratio=2, T_dim=16, drop_path=0.2,
    capacity_div=[1, 2, 4, 8, 8], dtype="float32")
NARROW_SPUNET = dict(base_channels=8, channels=[8, 16, 16, 16, 16, 16, 8, 8])
TRAIN_MIX = dict(kind="train_buckets", buckets=4, scenes_per_bucket=2, points_per_scene=1024,
                 cell=0.08, grid_size=0.08)
TEST_MIX = dict(kind="test_fragments", rooms=1, cell=0.08, grid_size=0.08,
                augmentations=[{"rotate_z": 0}, {"rotate_z": 0.5, "scale": 0.95}, {"flip": True}])


def cell(name: str):
    """The cell ``name`` at the tests' size, with its own limits."""
    c = copy.deepcopy(manifest.cell(name))
    cfg = c["cfg"]
    bb = cfg["model"]["backbone"]
    bb.update(NARROW_PTV3 if cfg["reference"] == "cdsegnet" else NARROW_SPUNET)
    cfg.update(dtype="float32", serialization_depth=8,
               test_buckets=[2048, 4096, 8192])
    if cfg["reference"] == "cdsegnet":
        cfg["model"]["T_dim"] = 16
    c["traffic"] = TEST_MIX if c["traffic"] == "test_fragments" else TRAIN_MIX
    return c
