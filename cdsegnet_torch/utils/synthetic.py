"""Synthetic surface-like scenes for smoke runs and benchmarks.

A numpy copy of the JAX package's ``__graft_entry__._synthetic_point_batch``:
the same seed gives the same arrays. Each scene is a smooth height field
sampled over a dense (x, y) patch, so voxels are unique per scene (the
GridSample invariant the neighbor tables rely on) and stride-2 pooling
reduces 2-4x per level, as real indoor scans do; the shipped capacity
divisors (1, 2, 4, 16, 64) then drop nothing. 90% of the slots are real
points, the rest padding.
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
