"""Synthetic scenes for smoke runs and benchmarks.

`synthetic_arrays` is a numpy copy of the JAX package's
``__graft_entry__._synthetic_point_batch``: the same seed gives the same
arrays. Each scene is a smooth height field
sampled over a dense (x, y) patch, so voxels are unique per scene (the
GridSample invariant the neighbor tables rely on) and stride-2 pooling
reduces 2-4x per level, as real indoor scans do; the shipped capacity
divisors (1, 2, 4, 16, 64) then drop nothing. 90% of the slots are real
points, the rest padding. `room_scene` is a raw scan for the tester: a
room in the fields of a Pointcept ScanNet archive, before any voxelization.
"""

from __future__ import annotations

import numpy as np

from cdsegnet_torch.models.structure import PointBatch, make_point_batch
from cdsegnet_torch.utils.device import resolve_device


def synthetic_arrays(num_points: int, num_scenes: int, depth: int, seed: int = 0):
    """``dict(coord, feat, grid_coord, batch, mask, segment)`` as numpy."""
    rng = np.random.RandomState(seed)
    n_real = int(num_points * 0.9)
    per = n_real // num_scenes
    side = 1 << min(depth, 9)
    grid = np.zeros((num_points, 3), np.int64)
    for s in range(num_scenes):
        lo = s * per
        n_s = per if s < num_scenes - 1 else n_real - per * (num_scenes - 1)
        w = int(np.ceil(np.sqrt(n_s)))
        if w > side:
            raise ValueError("scene too large for the voxel grid")
        xs = np.arange(n_s) % w
        ys = np.arange(n_s) // w
        fx, fy = rng.uniform(0.002, 0.01, 2)  # max slope ~1.3 voxel/voxel
        ph = rng.uniform(0, 2 * np.pi, 2)
        amp = side / 4
        z = (amp * (np.sin(fx * xs + ph[0]) + np.sin(fy * ys + ph[1]))
             + side / 2).astype(np.int64)
        grid[lo:lo + n_s, 0] = xs
        grid[lo:lo + n_s, 1] = ys
        grid[lo:lo + n_s, 2] = np.clip(z, 0, side - 1)
    return dict(
        coord=grid * 0.02 + rng.rand(num_points, 3) * 0.02,
        feat=rng.randn(num_points, 6).astype(np.float32),
        grid_coord=grid,
        batch=np.minimum(np.arange(num_points) // per, num_scenes - 1),
        mask=np.arange(num_points) < n_real,
        segment=rng.randint(0, 20, size=(num_points,)),
    )


def synthetic_point_batch(num_points: int, num_scenes: int, depth: int,
                          seed: int = 0, device=None) -> PointBatch:
    """The synthetic scene as a `PointBatch` on ``device`` (the GPU unless
    the caller names another)."""
    device = resolve_device(device)
    return make_point_batch(**synthetic_arrays(num_points, num_scenes, depth, seed),
                            depth=depth, num_scenes=num_scenes, device=device)


def room_scene(seed: int = 0, cell: float = 0.02) -> dict:
    """A synthetic ScanNet v2 room (Pointcept `.pth` fields): a 4.4 x 3.6 m
    floor, four walls 1.2 m high and four boxes, each face sampled on the
    2 cm grid with 2-4 points in each cell; colors 0-255 per face with
    noise, face normals, `semantic_gt20` per face (wall, floor, cabinet,
    table, chair, bed)."""
    rng = np.random.default_rng(seed)
    w, d, h = 4.4, 3.6, 1.2
    faces = [((0, 0, 0), (w, 0, 0), (0, d, 0), (0, 0, 1), 1),
             ((0, 0, 0), (0, d, 0), (0, 0, h), (1, 0, 0), 0),
             ((w, 0, 0), (0, d, 0), (0, 0, h), (-1, 0, 0), 0),
             ((0, 0, 0), (w, 0, 0), (0, 0, h), (0, 1, 0), 0),
             ((0, d, 0), (w, 0, 0), (0, 0, h), (0, -1, 0), 0)]
    for x, y, sx, sy, sz, label in ((0.4, 0.4, 0.8, 0.5, 0.9, 2),
                                    (2.6, 0.6, 1.2, 0.8, 0.75, 6),
                                    (1.2, 2.2, 0.6, 0.6, 0.45, 4),
                                    (3.2, 2.4, 0.9, 0.9, 0.5, 3)):
        faces += [((x, y, sz), (sx, 0, 0), (0, sy, 0), (0, 0, 1), label),
                  ((x, y, 0), (sx, 0, 0), (0, 0, sz), (0, -1, 0), label),
                  ((x, y + sy, 0), (sx, 0, 0), (0, 0, sz), (0, 1, 0), label),
                  ((x, y, 0), (0, sy, 0), (0, 0, sz), (-1, 0, 0), label),
                  ((x + sx, y, 0), (0, sy, 0), (0, 0, sz), (1, 0, 0), label)]
    parts = dict(coord=[], color=[], normal=[], semantic_gt20=[])
    for origin, u, v, normal, label in faces:
        u, v = np.array(u, float), np.array(v, float)
        nu = int(round(np.linalg.norm(u) / cell))
        nv = int(round(np.linalg.norm(v) / cell))
        ij = np.stack(np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij"),
                      -1).reshape(-1, 2)
        k = rng.choice([2, 3, 4], size=len(ij), p=[0.75, 0.2, 0.05])
        ij = np.repeat(ij, k, axis=0) + rng.random((int(k.sum()), 2))
        p = np.array(origin, float) + ij[:, :1] / nu * u + ij[:, 1:] / nv * v
        parts["coord"].append(p)
        parts["normal"].append(np.broadcast_to(np.array(normal, float), p.shape))
        parts["color"].append(np.clip(rng.uniform(40, 215, 3)
                                      + rng.normal(0, 12, p.shape), 0, 255))
        parts["semantic_gt20"].append(np.full(len(p), label))
    return {k: np.concatenate(v).astype(np.int64 if k == "semantic_gt20" else np.float32)
            for k, v in parts.items()}
