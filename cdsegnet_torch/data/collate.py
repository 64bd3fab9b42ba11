"""Static-shape batch collation with Mix3D.

Port of `mix3d`, `collate_scenes` and `pick_bucket` of
`cdsegnet_tpu/data/collate.py`: scenes are concatenated into a fixed
``num_points`` bucket with a validity mask and per-point scene ids, the
layout `models.structure.PointBatch` takes. The bucket size also sets the
pyramid's per-level capacities (``capacity_div``), so the same buckets as
the JAX package keep the same drops. Mix3D merges scene pairs with
probability ``mix_prob`` (reference `point_collate_fn`).
`collate_pair_scenes` packs MSC's two views into two aligned buckets. JAX's
`collate_sharded`, its stack of every device's bucket, is not ported: each
rank of the port collates its own. With ``CDSEG_VALIDATE`` set,
`collate_scenes` checks that every scene's voxels are unique
(`models.structure.assert_unique_voxels`), as JAX's does.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np


def mix3d(scenes: List[Dict], rng: np.random.Generator, mix_prob: float = 0.8):
    """Merge consecutive scene pairs with probability ``mix_prob``.

    Coincident voxels of the two merged scenes are deduplicated (first
    wins, like re-running GridSample on the union): the neighbor tables
    take voxels unique per scene, and the reference's spconv hash likewise
    keeps one winner per coincident voxel.
    """
    if len(scenes) > 1 and rng.random() < mix_prob:
        merged = []
        for i in range(0, len(scenes) - 1, 2):
            a, b = scenes[i], scenes[i + 1]
            m = {
                k: np.concatenate([a[k], b[k]])
                for k in a.keys()
                if k in b and hasattr(a[k], "ndim")
            }
            if "grid_coord" in m:
                _, first = np.unique(m["grid_coord"], axis=0, return_index=True)
                if len(first) < len(m["grid_coord"]):
                    keep = np.sort(first)
                    m = {
                        k: v[keep] if v.shape[:1] == m["grid_coord"].shape[:1] else v
                        for k, v in m.items()
                    }
            merged.append(m)
        if len(scenes) % 2 == 1:
            merged.append(scenes[-1])
        return merged
    return scenes


def collate_scenes(
    scenes: List[Dict],
    num_points: int,
    num_scenes: Optional[int] = None,
    feat_dim: Optional[int] = None,
    extra_float_keys: Sequence[str] = (),
) -> Dict[str, np.ndarray]:
    """Pack scenes into one static bucket.

    Returns numpy arrays: coord (N,3) f32, grid_coord (N,3) i32, feat (N,C)
    f32, segment (N,) i32, batch (N,) i32, mask (N,) bool. Scenes overflowing
    the bucket are truncated tail-first (with a stderr warning).
    """
    num_scenes = num_scenes or len(scenes)
    assert len(scenes) <= num_scenes, (len(scenes), num_scenes)
    if feat_dim is None:
        feat_dim = scenes[0]["feat"].shape[-1]
    coord = np.zeros((num_points, 3), np.float32)
    grid = np.zeros((num_points, 3), np.int32)
    feat = np.zeros((num_points, feat_dim), np.float32)
    segment = np.full((num_points,), -1, np.int32)
    batch = np.full((num_points,), num_scenes, np.int32)
    mask = np.zeros((num_points,), bool)
    has_inst = any("instance" in s for s in scenes)
    instance = np.full((num_points,), -1, np.int32) if has_inst else None
    centroid = np.zeros((num_points, 3), np.float32) if has_inst else None
    extras = {
        k: np.zeros((num_points, scenes[0][k].shape[-1]), np.float32)
        for k in extra_float_keys
    }
    pos = 0
    inst_base = 0  # keep instance ids unique across scenes in the bucket
    for i, s in enumerate(scenes):
        n = s["coord"].shape[0]
        room = num_points - pos
        if n > room:
            print(f"collate_scenes: truncating scene {i} ({n} -> {room} points)",
                  file=sys.stderr)
            n = room
        if n <= 0:
            break
        sl = slice(pos, pos + n)
        coord[sl] = s["coord"][:n]
        if "grid_coord" in s:
            grid[sl] = s["grid_coord"][:n]
        feat[sl] = s["feat"][:n]
        if "segment" in s:
            segment[sl] = np.asarray(s["segment"][:n]).reshape(-1)
        if has_inst and "instance" in s:
            inst = np.asarray(s["instance"][:n]).reshape(-1).astype(np.int32)
            instance[sl] = np.where(inst >= 0, inst + inst_base, -1)
            inst_base += int(inst.max()) + 1 if inst.size and inst.max() >= 0 else 0
            if "instance_centroid" in s:
                centroid[sl] = s["instance_centroid"][:n]
        for k in extra_float_keys:
            extras[k][sl] = s[k][:n]
        batch[sl] = i
        mask[sl] = True
        pos += n
    out = dict(
        coord=coord, grid_coord=grid, feat=feat, segment=segment,
        batch=batch, mask=mask,
    )
    if has_inst:
        out["instance"] = instance
        out["instance_centroid"] = centroid
    out.update(extras)
    if os.environ.get("CDSEG_VALIDATE"):
        # the neighbor tables trust unique voxels per scene
        from cdsegnet_torch.models.structure import assert_unique_voxels

        assert_unique_voxels(grid, batch, mask, where="collate_scenes")
    return out


def collate_pair_scenes(
    scenes: List[Dict],
    num_points: int,
    num_scenes: Optional[int] = None,
    feat_keys: Sequence[str] = ("color", "normal"),
) -> Dict[str, np.ndarray]:
    """Pack two augmented views per scene (``view1_*``/``view2_*`` from
    `ContrastiveViewsGenerator`) into two aligned static buckets for MSC
    pretraining: ``view{1,2}_{coord,grid_coord,feat,batch,mask}``, the
    un-augmented ``origin_coord`` (the view's ``coord`` when it has none)
    and the reconstruction targets ``target_<key>`` of ``feat_keys``, each
    packed as its view's points. Raises `ValueError` when a view pipeline
    subsampled ``coord`` without ``origin_coord``."""
    out: Dict[str, np.ndarray] = {}
    for v in (1, 2):
        pref = f"view{v}_"
        sub = []
        for s in scenes:
            origin_coord = np.asarray(s.get(pref + "origin_coord", s[pref + "coord"]),
                                      np.float32)
            if len(origin_coord) != len(s[pref + "coord"]):
                raise ValueError(
                    f"{pref}origin_coord has {len(origin_coord)} rows but "
                    f"{pref}coord has {len(s[pref + 'coord'])}: the view "
                    "pipeline subsampled coord without origin_coord (add "
                    "origin_coord to GridSample keys)")
            d = dict(coord=s[pref + "coord"], grid_coord=s[pref + "grid_coord"],
                     feat=np.concatenate([np.asarray(s[pref + k], np.float32)
                                          for k in feat_keys], axis=1),
                     origin_coord=origin_coord)
            for k in feat_keys:
                d["target_" + k] = np.asarray(s[pref + k], np.float32)
            sub.append(d)
        b = collate_scenes(sub, num_points, num_scenes,
                           extra_float_keys=("origin_coord",)
                           + tuple("target_" + k for k in feat_keys))
        b.pop("segment")
        out.update({pref + k: arr for k, arr in b.items()})
    return out


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits n points (largest bucket if none fit)."""
    for b in sorted(buckets):
        if n <= b:
            return b
    return max(buckets)
