"""Synthetic ScanNet rooms and the geometric part of the ScanNet pipelines,
in numpy, from a seed.

`room` is a 4.4 x 3.6 m room with 1.2 m walls and four boxes, each face
sampled on a 2 cm grid with 2-4 points per cell (about 263,000 points, a
mid-sized ScanNet v2 scene), colors per face with noise, face normals and
the 20-class labels of wall, floor, cabinet, table, chair and bed. The
transforms follow Pointcept's: `center_shift`, `grid_sample` (FNV-1a voxel
hash; one point per voxel in training, every rotation of the per-voxel
picks as fragments in testing), `sphere_crop` (the nearest points to a
random center), `normalize_color`, and the test-time rotation, scale and
flip.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def room(seed: int, cell: float = 0.02) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    w, d, h = 4.4, 3.6, 1.2
    faces = [((0, 0, 0), (w, 0, 0), (0, d, 0), (0, 0, 1), 1),
             ((0, 0, 0), (0, d, 0), (0, 0, h), (1, 0, 0), 0),
             ((w, 0, 0), (0, d, 0), (0, 0, h), (-1, 0, 0), 0),
             ((0, 0, 0), (w, 0, 0), (0, 0, h), (0, 1, 0), 0),
             ((0, d, 0), (w, 0, 0), (0, 0, h), (0, -1, 0), 0)]
    for x, y, sx, sy, sz, label in ((0.4, 0.4, 0.8, 0.5, 0.9, 2), (2.6, 0.6, 1.2, 0.8, 0.75, 6),
                                    (1.2, 2.2, 0.6, 0.6, 0.45, 4), (3.2, 2.4, 0.9, 0.9, 0.5, 3)):
        faces += [((x, y, sz), (sx, 0, 0), (0, sy, 0), (0, 0, 1), label),
                  ((x, y, 0), (sx, 0, 0), (0, 0, sz), (0, -1, 0), label),
                  ((x, y + sy, 0), (sx, 0, 0), (0, 0, sz), (0, 1, 0), label),
                  ((x, y, 0), (0, sy, 0), (0, 0, sz), (-1, 0, 0), label),
                  ((x + sx, y, 0), (0, sy, 0), (0, 0, sz), (1, 0, 0), label)]
    parts = dict(coord=[], color=[], normal=[], segment=[])
    for origin, u, v, normal, label in faces:
        u, v = np.array(u, float), np.array(v, float)
        nu, nv = int(round(np.linalg.norm(u) / cell)), int(round(np.linalg.norm(v) / cell))
        ij = np.stack(np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij"), -1).reshape(-1, 2)
        k = rng.choice([2, 3, 4], size=len(ij), p=[0.75, 0.2, 0.05])
        ij = np.repeat(ij, k, axis=0) + rng.random((int(k.sum()), 2))
        p = np.array(origin, float) + ij[:, :1] / nu * u + ij[:, 1:] / nv * v
        parts["coord"].append(p)
        parts["normal"].append(np.broadcast_to(np.array(normal, float), p.shape))
        parts["color"].append(np.clip(rng.uniform(40, 215, 3) + rng.normal(0, 12, p.shape), 0, 255))
        parts["segment"].append(np.full(len(p), label))
    return {k: np.concatenate(v).astype(np.int64 if k == "segment" else np.float32)
            for k, v in parts.items()}


def center_shift(data: Dict, apply_z: bool) -> Dict:
    lo, hi = data["coord"].min(0), data["coord"].max(0)
    shift = np.array([(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2, lo[2] if apply_z else 0.0])
    return dict(data, coord=data["coord"] - shift)


def normalize_color(data: Dict) -> Dict:
    return dict(data, color=data["color"] / 127.5 - 1.0)


def fnv_hash(grid: np.ndarray) -> np.ndarray:
    g = grid.astype(np.uint64)
    h = np.full(g.shape[0], np.uint64(14695981039346656037), np.uint64)
    for j in range(g.shape[1]):
        h *= np.uint64(1099511628211)
        h ^= g[:, j]
    return h


def _voxels(coord: np.ndarray, grid_size: float):
    grid = np.floor(coord / np.array(grid_size)).astype(np.int64)
    grid -= grid.min(0)
    return grid, fnv_hash(grid)


def _take(data: Dict, idx: np.ndarray, keys) -> Dict:
    return {k: (v[idx] if k in keys else v) for k, v in data.items()}


POINT_KEYS = ("coord", "color", "normal", "segment")


def grid_sample_train(data: Dict, grid_size: float, rng: np.random.Generator) -> Dict:
    """One random point per occupied voxel, voxels in hash order."""
    grid, key = _voxels(data["coord"], grid_size)
    order = np.argsort(key, kind="stable")
    _, counts = np.unique(key[order], return_counts=True)
    starts = np.cumsum(np.insert(counts, 0, 0))[:-1]
    pick = rng.integers(0, np.iinfo(np.int64).max, key.shape[0])[: counts.size] % counts
    idx = order[starts + pick]
    out = _take(data, idx, POINT_KEYS)
    out["grid_coord"] = grid[idx]
    return out


def grid_sample_test(data: Dict, grid_size: float) -> List[Dict]:
    """Fragment i takes the (i mod count)-th point of every voxel."""
    grid, key = _voxels(data["coord"], grid_size)
    order = np.argsort(key)
    _, inverse, counts = np.unique(key[order], return_inverse=True, return_counts=True)
    starts = np.cumsum(np.insert(counts, 0, 0)[:-1])
    frags = []
    for i in range(counts.max()):
        idx = order[starts + i % counts]
        part = _take(data, idx, ("coord", "color", "normal"))
        part.update(grid_coord=grid[idx], index=idx)
        frags.append(part)
    return frags


def sphere_crop(data: Dict, point_max: int, rng: np.random.Generator) -> Dict:
    n = data["coord"].shape[0]
    if n <= point_max:
        return data
    center = data["coord"][rng.integers(n)]
    idx = np.argsort(np.sum((data["coord"] - center) ** 2, 1))[:point_max]
    return _take(data, idx, POINT_KEYS + ("grid_coord",))


def augment(data: Dict, aug: Dict) -> Dict:
    """A test-time augmentation: a rotation about z by ``rotate_z`` half
    turns around the origin, then a scale, then a flip of x and y."""
    out = dict(data)
    if "rotate_z" in aug:
        a = aug["rotate_z"] * np.pi
        c, s = np.cos(a), np.sin(a)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        out["coord"] = out["coord"] @ rot.T
        out["normal"] = out["normal"] @ rot.T
    if "scale" in aug:
        out["coord"] = out["coord"] * aug["scale"]
    if aug.get("flip"):
        out["coord"] = out["coord"] * np.array([-1.0, -1.0, 1.0])
        out["normal"] = out["normal"] * np.array([-1.0, -1.0, 1.0])
    return out


def collect(data: Dict) -> Dict:
    out = {k: data[k] for k in ("coord", "grid_coord", "segment", "index") if k in data}
    out["feat"] = np.concatenate([data["color"], data["normal"]], -1).astype(np.float32)
    return out


def collate(scenes: List[Dict], num_points: int) -> Dict[str, np.ndarray]:
    """Scenes packed into one bucket of ``num_points`` slots: padding has
    ``mask`` False, scene id ``len(scenes)``, label -1 and zeros."""
    s = len(scenes)
    out = dict(coord=np.zeros((num_points, 3), np.float32),
               grid_coord=np.zeros((num_points, 3), np.int32),
               feat=np.zeros((num_points, scenes[0]["feat"].shape[1]), np.float32),
               segment=np.full(num_points, -1, np.int32),
               batch=np.full(num_points, s, np.int32), mask=np.zeros(num_points, bool))
    pos = 0
    for i, sc in enumerate(scenes):
        n = sc["coord"].shape[0]
        if pos + n > num_points:
            raise ValueError(f"{pos + n} points for a bucket of {num_points}")
        sl = slice(pos, pos + n)
        out["coord"][sl], out["grid_coord"][sl], out["feat"][sl] = \
            sc["coord"], sc["grid_coord"], sc["feat"]
        if "segment" in sc:
            out["segment"][sl] = sc["segment"]
        out["batch"][sl], out["mask"][sl] = i, True
        pos += n
    return out
