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
`lidar_sweep` is a raw nuScenes keyframe sweep; `write_nuscenes` and
`write_semantic_kitti` lay sweeps out as `NuScenesDataset` and
`SemanticKITTIDataset` read them. `write_modelnet` and
`write_shapenet_part` write seeded primitive shapes (spheres, boxes,
cylinders, with normals and part labels) in the datasets' own file formats
at their published point counts. `write_s3dis`, `write_structured3d`,
`write_arkitscenes` and `write_scannet_pair` lay rooms out as Pointcept
`.pth` archives in those datasets' layouts and label spaces, `write_waymo`
sweeps as Waymo frames.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List

import numpy as np
import torch

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


def room_scene(seed: int = 0, cell: float = 0.02, instances: bool = False) -> dict:
    """A synthetic ScanNet v2 room (Pointcept `.pth` fields): a 4.4 x 3.6 m
    floor, four walls 1.2 m high and four boxes, each face sampled on the
    2 cm grid with 2-4 points in each cell; colors 0-255 per face with
    noise, face normals, `semantic_gt20` per face (wall, floor, cabinet,
    table, chair, bed) and `semantic_gt200`, the same classes among the
    ScanNet200 benchmark's. ``instances`` adds `instance_gt`: the box's
    index (0-3) on each box's points and -1 on the walls and the floor. It
    draws nothing: the other arrays are the same with or without it."""
    rng = np.random.default_rng(seed)
    w, d, h = 4.4, 3.6, 1.2
    faces = [((0, 0, 0), (w, 0, 0), (0, d, 0), (0, 0, 1), 1),
             ((0, 0, 0), (0, d, 0), (0, 0, h), (1, 0, 0), 0),
             ((w, 0, 0), (0, d, 0), (0, 0, h), (-1, 0, 0), 0),
             ((0, 0, 0), (w, 0, 0), (0, 0, h), (0, 1, 0), 0),
             ((0, d, 0), (w, 0, 0), (0, 0, h), (0, -1, 0), 0)]
    face_instance = [-1] * len(faces)
    for box, (x, y, sx, sy, sz, label) in enumerate(((0.4, 0.4, 0.8, 0.5, 0.9, 2),
                                                     (2.6, 0.6, 1.2, 0.8, 0.75, 6),
                                                     (1.2, 2.2, 0.6, 0.6, 0.45, 4),
                                                     (3.2, 2.4, 0.9, 0.9, 0.5, 3))):
        faces += [((x, y, sz), (sx, 0, 0), (0, sy, 0), (0, 0, 1), label),
                  ((x, y, 0), (sx, 0, 0), (0, 0, sz), (0, -1, 0), label),
                  ((x, y + sy, 0), (sx, 0, 0), (0, 0, sz), (0, 1, 0), label),
                  ((x, y, 0), (0, sy, 0), (0, 0, sz), (-1, 0, 0), label),
                  ((x + sx, y, 0), (0, sy, 0), (0, 0, sz), (1, 0, 0), label)]
        face_instance += [box] * 5
    parts = dict(coord=[], color=[], normal=[], semantic_gt20=[])
    instance = []
    for (origin, u, v, normal, label), inst in zip(faces, face_instance):
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
        instance.append(np.full(len(p), inst))
    out = {k: np.concatenate(v).astype(np.int64 if k == "semantic_gt20" else np.float32)
           for k, v in parts.items()}
    if instances:
        out["instance_gt"] = np.concatenate(instance).astype(np.int64)
    # ScanNet-20 index -> ScanNet200 index (wall 0, chair 1, floor 2, table 3,
    # cabinet 6, bed 10 among the benchmark's valid ids)
    out["semantic_gt200"] = np.array([0, 2, 6, 10, 1, -1, 3], np.int64)[out["semantic_gt20"]]
    return out


# nuScenes raw lidarseg ids of the synthetic street
_DRIVEABLE, _SIDEWALK, _CAR, _MANMADE = 24, 26, 17, 28


def lidar_sweep(seed: int = 0) -> Dict[str, np.ndarray]:
    """A synthetic nuScenes keyframe sweep in the lidar frame: a 32-beam
    ring pattern like the HDL-32E's (elevations -30.67 to +10.67 degrees,
    1,085 returns per ring, the sensor 1.84 m above the road) cast against a
    street: the road and the sidewalks (ground plane), building fronts 12 m
    high on both sides and at the ends (y = +-12 m, x = +-50 m) and parked
    and driving cars (boxes). ``points`` (N, 5) float32 (x, y, z, intensity
    0-255, ring) and ``labels`` (N,) uint8 raw lidarseg ids; about 34,000
    points (rays that hit nothing within 70 m give no return)."""
    rng = np.random.default_rng(seed)
    height, max_range = 1.84, 70.0
    elev = np.deg2rad(np.linspace(-30.67, 10.67, 32))
    azim = np.linspace(0, 2 * np.pi, 1085, endpoint=False)
    azim = azim[None, :] + rng.uniform(0, 2 * np.pi / 1085, (32, 1))
    el = np.broadcast_to(elev[:, None], azim.shape)
    d = np.stack([np.cos(el) * np.cos(azim), np.cos(el) * np.sin(azim),
                  np.sin(el)], -1).reshape(-1, 3)
    ring = np.repeat(np.arange(32), 1085)
    t = np.full(len(d), np.inf)
    label = np.zeros(len(d), np.int64)

    def hit(t_new, ok, lab):
        better = ok & (t_new > 0) & (t_new < t)
        t[better] = t_new[better]
        label[better] = lab

    with np.errstate(divide="ignore", invalid="ignore"):
        # ground: the road between the curbs at |y| = 7 m, sidewalks outside
        tg = -height / d[:, 2]
        yg = tg * d[:, 1]
        hit(tg, d[:, 2] < 0, _DRIVEABLE)
        side = (d[:, 2] < 0) & (np.abs(yg) > 7.0) & (t == tg)
        label[side] = _SIDEWALK
        # building fronts: planes y = +-12 and x = +-50, 12 m high
        for axis, pos in ((1, 12.0), (1, -12.0), (0, 50.0), (0, -50.0)):
            tw = pos / d[:, axis]
            z = tw * d[:, 2]
            hit(tw, (z > -height) & (z < 12.0 - height), _MANMADE)
        # cars: 4.5 x 1.9 x 1.6 m boxes along both lanes and curbs
        n_cars = 14
        cx = rng.uniform(-40, 40, n_cars)
        cy = rng.choice([-5.6, -2.0, 2.0, 5.6], n_cars) + rng.normal(0, 0.2, n_cars)
        for x0, y0 in zip(cx, cy):
            if abs(x0) < 3.5 and abs(y0) < 3.5:
                continue  # not on the ego car
            lo = np.array([x0 - 2.25, y0 - 0.95, -height])
            hi = np.array([x0 + 2.25, y0 + 0.95, 1.6 - height])
            t1, t2 = lo / d, hi / d
            t_in = np.minimum(t1, t2).max(1)
            t_out = np.maximum(t1, t2).min(1)
            hit(t_in, t_in <= t_out, _CAR)
    keep = t < max_range
    r = t[keep] + rng.normal(0, 0.02, int(keep.sum()))
    xyz = d[keep] * r[:, None]
    lab = label[keep]
    base = np.select([lab == _DRIVEABLE, lab == _SIDEWALK, lab == _CAR],
                     [12.0, 30.0, 60.0], 45.0)
    intensity = np.clip(base + rng.normal(0, 6, len(lab)), 0, 255)
    points = np.concatenate([xyz, intensity[:, None], ring[keep, None]], 1)
    return dict(points=points.astype(np.float32), labels=lab.astype(np.uint8))


def write_nuscenes(root: str, splits: Dict[str, List[Dict[str, np.ndarray]]],
                   sweeps: int = 10) -> None:
    """Lay sweeps out under ``root`` as `NuScenesDataset` reads them: per
    split, ``info/nuscenes_infos_{sweeps}sweeps_{split}.pkl`` listing each
    sweep's ``raw/samples/LIDAR_TOP/<token>.bin`` and, outside the test
    split, its ``raw/lidarseg/<token>_lidarseg.bin``. Tokens are
    ``<split><i>``."""
    os.makedirs(os.path.join(root, "info"), exist_ok=True)
    for d in ("samples/LIDAR_TOP", "lidarseg"):
        os.makedirs(os.path.join(root, "raw", d), exist_ok=True)
    for split, items in splits.items():
        infos = []
        for i, item in enumerate(items):
            token = f"{split}{i}"
            info = dict(lidar_path=f"samples/LIDAR_TOP/{token}.bin", lidar_token=token)
            item["points"].astype(np.float32).tofile(
                os.path.join(root, "raw", info["lidar_path"]))
            if split != "test":
                info["gt_segment_path"] = f"lidarseg/{token}_lidarseg.bin"
                item["labels"].astype(np.uint8).tofile(
                    os.path.join(root, "raw", info["gt_segment_path"]))
            infos.append(info)
        with open(os.path.join(root, "info",
                               f"nuscenes_infos_{sweeps}sweeps_{split}.pkl"), "wb") as f:
            pickle.dump(infos, f)


# the 40 ModelNet classes (sorted: their rank is the label) and the 16
# ShapeNetPart categories with their synset ids
MODELNET40_CLASSES = (
    "airplane", "bathtub", "bed", "bench", "bookshelf", "bottle", "bowl", "car",
    "chair", "cone", "cup", "curtain", "desk", "door", "dresser", "flower_pot",
    "glass_box", "guitar", "keyboard", "lamp", "laptop", "mantel", "monitor",
    "night_stand", "person", "piano", "plant", "radio", "range_hood", "sink",
    "sofa", "stairs", "stool", "table", "tent", "toilet", "tv_stand", "vase",
    "wardrobe", "xbox")
SHAPENET_PART_SYNSETS = (
    ("Airplane", "02691156"), ("Bag", "02773838"), ("Cap", "02954340"),
    ("Car", "02958343"), ("Chair", "03001627"), ("Earphone", "03261776"),
    ("Guitar", "03467517"), ("Knife", "03624134"), ("Lamp", "03636649"),
    ("Laptop", "03642806"), ("Motorbike", "03790512"), ("Mug", "03797390"),
    ("Pistol", "03948459"), ("Rocket", "04099429"), ("Skateboard", "04225987"),
    ("Table", "04379243"))


# SemanticKITTI raw label ids that `write_semantic_kitti` gives each
# synthetic surface, by azimuth sector: the learning map sends them to all
# 19 classes (0, unlabeled, goes to the ignore index)
_KITTI_RAW = {
    _DRIVEABLE: (40, 44, 40, 0),  # road, parking, road, unlabeled
    _SIDEWALK: (48, 49, 72),  # sidewalk, other-ground, terrain
    _CAR: (10, 11, 15, 18, 20, 30, 31, 32),  # vehicles, person, riders
    _MANMADE: (50, 51, 70, 71, 80, 81),  # building, fence, vegetation, trunk, pole, sign
}


def write_semantic_kitti(root: str, sequences: Dict[str, List[Dict[str, np.ndarray]]]
                         ) -> None:
    """Lay `lidar_sweep` sweeps out under ``root`` as `SemanticKITTIDataset`
    reads them: ``dataset/sequences/<seq>/velodyne/<frame:06d>.bin``
    float32 (x, y, z, remission = intensity / 255) and
    ``labels/<frame:06d>.label`` uint32 raw ids. Each nuScenes class of the
    sweep maps to several SemanticKITTI raw ids by the point's azimuth
    sector, so that the 19 learning classes (and the ignored unlabeled id)
    all occur."""
    for seq, sweeps in sequences.items():
        base = os.path.join(root, "dataset", "sequences", seq)
        for d in ("velodyne", "labels"):
            os.makedirs(os.path.join(base, d), exist_ok=True)
        for i, sweep in enumerate(sweeps):
            pts = sweep["points"]
            scan = np.concatenate([pts[:, :3], pts[:, 3:4] / 255.0], 1).astype(np.float32)
            scan.tofile(os.path.join(base, "velodyne", f"{i:06d}.bin"))
            azim = np.arctan2(pts[:, 1], pts[:, 0]) + np.pi
            raw = np.zeros(len(pts), np.uint32)
            for lab, ids in _KITTI_RAW.items():
                sel = sweep["labels"] == lab
                sector = (azim[sel] / (2 * np.pi) * 16).astype(np.int64) % len(ids)
                raw[sel] = np.asarray(ids, np.uint32)[sector]
            raw.tofile(os.path.join(base, "labels", f"{i:06d}.label"))


def _primitive(kind: int, n: int, dims: np.ndarray, rng) -> tuple:
    """``n`` points on the surface of a sphere (kind 0), box (1) or
    cylinder (2) of half-extents ``dims``, centered at 0, with outward unit
    normals."""
    if kind == 0:
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        normal = d / dims
        return d * dims, normal / np.linalg.norm(normal, axis=1, keepdims=True)
    if kind == 1:
        area = np.array([dims[1] * dims[2], dims[0] * dims[2], dims[0] * dims[1]])
        axis = rng.choice(3, size=n, p=area / area.sum())
        p = rng.uniform(-1, 1, (n, 3)) * dims
        sign = rng.choice([-1.0, 1.0], size=n)
        p[np.arange(n), axis] = sign * dims[axis]
        normal = np.zeros((n, 3))
        normal[np.arange(n), axis] = sign
        return p, normal
    side = 2 * np.pi * np.sqrt(dims[0] * dims[1]) * 2 * dims[2]
    cap = np.pi * dims[0] * dims[1]
    on_side = rng.random(n) < side / (side + 2 * cap)
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = np.where(on_side, 1.0, np.sqrt(rng.random(n)))
    z = np.where(on_side, rng.uniform(-1, 1, n), rng.choice([-1.0, 1.0], size=n))
    p = np.stack([rad * np.cos(ang), rad * np.sin(ang), z], 1) * dims
    normal = np.where(on_side[:, None],
                      np.stack([np.cos(ang) / dims[0], np.sin(ang) / dims[1],
                                np.zeros(n)], 1),
                      np.stack([np.zeros(n), np.zeros(n), z], 1))
    return p, normal / np.linalg.norm(normal, axis=1, keepdims=True)


def _class_dims(i: int, rng) -> np.ndarray:
    """Half-extents of class ``i``'s primitive, jittered 5% per shape."""
    base = 0.3 + 0.7 * np.modf(np.array([0.618, 0.414, 0.732]) * (i + 1))[0]
    return base * rng.uniform(0.95, 1.05, 3)


def _unit(p: np.ndarray) -> np.ndarray:
    p = p - p.mean(0)
    return p / np.linalg.norm(p, axis=1).max()


def write_modelnet(root: str, shapes: Dict[str, int], num_points: int = 10000,
                   seed: int = 0) -> None:
    """ModelNet40 as `ModelNetDataset` reads it, at the published 10,000
    points per shape: ``<class>/<class>_<id>.txt`` files of ``x,y,z,nx,ny,nz``
    text and one ``modelnet40_<split>.txt`` list per split. ``shapes[split]``
    shapes per split, shape k of class ``k % 40``; each class a sphere, box
    or cylinder of its own proportions, scaled into the unit sphere."""
    rng = np.random.default_rng(seed)
    for c in MODELNET40_CLASSES:
        os.makedirs(os.path.join(root, c), exist_ok=True)
    serial = 0
    for split, count in shapes.items():
        names = []
        for k in range(count):
            i = k % len(MODELNET40_CLASSES)
            cls = MODELNET40_CLASSES[i]
            serial += 1
            p, normal = _primitive(i % 3, num_points, _class_dims(i, rng), rng)
            name = f"{cls}_{serial:04d}"
            np.savetxt(os.path.join(root, cls, name + ".txt"),
                       np.concatenate([_unit(p), normal], 1), fmt="%.6f", delimiter=",")
            names.append(name)
        with open(os.path.join(root, f"modelnet40_{split}.txt"), "w") as f:
            f.write("\n".join(names) + "\n")


def write_shapenet_part(root: str, shapes: Dict[str, int], num_points: int = 2500,
                        seed: int = 0) -> None:
    """ShapeNetPart as `ShapeNetPartDataset` reads it, at about the published
    2,500 points per shape (2,300-2,700): ``<synset>/<name>.txt`` files of
    ``x y z nx ny nz part``, ``synsetoffset2category.txt`` and
    ``train_test_split/shuffled_<split>_file_list.json``. ``shapes[split]``
    shapes per split, shape k of category ``k % 16``: a stack along z of
    one primitive per part of the category's span, each labeled with its
    part, scaled into the unit sphere."""
    from cdsegnet_torch.data.datasets import ShapeNetPartDataset

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "train_test_split"), exist_ok=True)
    with open(os.path.join(root, "synsetoffset2category.txt"), "w") as f:
        f.write("".join(f"{c}\t{s}\n" for c, s in SHAPENET_PART_SYNSETS))
    serial = 0
    for split, count in shapes.items():
        entries = []
        for k in range(count):
            c = k % len(SHAPENET_PART_SYNSETS)
            cat, synset = SHAPENET_PART_SYNSETS[c]
            parts = ShapeNetPartDataset.CATEGORY2PART[cat]
            n = int(rng.integers(num_points - 200, num_points + 201))
            counts = np.diff(np.linspace(0, n, len(parts) + 1).astype(int))
            pts, normals, labels = [], [], []
            for j, (part, m) in enumerate(zip(parts, counts)):
                dims = _class_dims(c + 7 * j, rng) * 0.5
                p, normal = _primitive((c + j) % 3, m, dims, rng)
                p[:, 2] += j * 0.8
                pts.append(p)
                normals.append(normal)
                labels.append(np.full(m, part))
            serial += 1
            name = f"{serial:06d}"
            os.makedirs(os.path.join(root, synset), exist_ok=True)
            np.savetxt(os.path.join(root, synset, name + ".txt"),
                       np.concatenate([_unit(np.concatenate(pts)), np.concatenate(normals),
                                       np.concatenate(labels)[:, None]], 1),
                       fmt=["%.6f"] * 6 + ["%d"])
            entries.append(f"shape_data/{synset}/{name}")
        with open(os.path.join(root, "train_test_split",
                               f"shuffled_{split}_file_list.json"), "w") as f:
            json.dump(entries, f)


# `room_scene`'s ScanNet-20 classes (wall, floor, cabinet, bed, chair,
# table) in the S3DIS (13 classes: wall 2, floor 1, clutter 12, chair 8,
# table 7) and Structured3D (25 classes, PPT's first `valid_index` row)
# label spaces; ScanNet-20 ids the room does not use map to the ignore index
_S3DIS_OF_SCANNET = np.array([2, 1, 12, 12, 8, -1, 7], np.int64)
_STRUCTURED3D_OF_SCANNET = np.array([0, 1, 2, 3, 4, -1, 6], np.int64)
# Waymo semantic ids (1-22; 0 unlabeled) of `lidar_sweep`'s surfaces
_WAYMO_OF_NUSCENES = {_DRIVEABLE: 18, _SIDEWALK: 22, _CAR: 1, _MANMADE: 14}


def _relabelled(room: dict, table: np.ndarray, key: str) -> dict:
    """``room`` (a `room_scene`) with ``semantic_gt20`` mapped by ``table``
    into ``key``, and without the ScanNet label fields."""
    out = {k: v for k, v in room.items() if not k.startswith("semantic_gt")}
    out[key] = table[room["semantic_gt20"]]
    return out


def write_s3dis(root: str, areas: Dict[str, List[dict]]) -> None:
    """Lay `room_scene` rooms out as `S3DISDataset` reads them:
    ``<root>/<area>/room_<i>.pth`` (``areas`` maps e.g. ``"Area_1"`` to its
    rooms) with coord, color, normal and the 13-class ``semantic_gt``
    (``instance_gt`` when the room has it)."""
    for area, rooms in areas.items():
        os.makedirs(os.path.join(root, area), exist_ok=True)
        for i, room in enumerate(rooms):
            _save(_relabelled(room, _S3DIS_OF_SCANNET, "semantic_gt"),
                  os.path.join(root, area, f"room_{i}.pth"))


def write_structured3d(root: str, splits: Dict[str, List[dict]]) -> None:
    """Lay `room_scene` rooms out as `Structured3DDataset` reads them:
    ``<root>/<split>/scene_<i:05d>/room_0.pth`` with coord, color, normal
    and the 25-class ``segment``."""
    for split, rooms in splits.items():
        for i, room in enumerate(rooms):
            d = os.path.join(root, split, f"scene_{i:05d}")
            os.makedirs(d, exist_ok=True)
            _save(_relabelled(room, _STRUCTURED3D_OF_SCANNET, "segment"),
                  os.path.join(d, "room_0.pth"))


def write_arkitscenes(root: str, splits: Dict[str, List[dict]]) -> None:
    """Lay `room_scene` rooms out as `ArkitScenesDataset` reads them:
    ``<root>/<split>/<i:08d>.pth`` with coord, color and normal only (the
    scans are unlabeled)."""
    for split, rooms in splits.items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for i, room in enumerate(rooms):
            _save({k: room[k] for k in ("coord", "color", "normal")},
                  os.path.join(root, split, f"{i:08d}.pth"))


def write_waymo(root: str, splits: Dict[str, List[Dict[str, np.ndarray]]]) -> None:
    """Lay `lidar_sweep` sweeps out as `WaymoDataset` reads them: split
    ``s``'s sweep i as ``<root>/<s>/segment-<i>/velodyne/000000.bin``
    float32 (x, y, z, intensity / 255) and ``labels/000000.label`` int32
    (N, 2): instance 0, then the Waymo class (road, sidewalk, car,
    building; every tenth return unlabeled, 0)."""
    for split, sweeps in splits.items():
        for i, sweep in enumerate(sweeps):
            base = os.path.join(root, split, f"segment-{i}")
            for d in ("velodyne", "labels"):
                os.makedirs(os.path.join(base, d), exist_ok=True)
            pts = sweep["points"]
            scan = np.concatenate([pts[:, :3], pts[:, 3:4] / 255.0], 1).astype(np.float32)
            scan.tofile(os.path.join(base, "velodyne", "000000.bin"))
            sem = np.zeros(len(pts), np.int32)
            for lab, cls in _WAYMO_OF_NUSCENES.items():
                sem[sweep["labels"] == lab] = cls
            sem[::10] = 0
            labels = np.stack([np.zeros_like(sem), sem], 1).astype(np.int32)
            labels.tofile(os.path.join(base, "labels", "000000.label"))


def write_scannet_pair(root: str, scenes: List[List[dict]],
                       overlaps: List[List[float]]) -> None:
    """Lay scans out as `ScanNetPairDataset` reads them: scene k's views as
    ``<root>/scene<k:04d>_00/pcd/<j:06d>.pth`` (coord, color, normal), and
    ``pcd/overlap.txt`` listing each consecutive pair ``j, j + 1`` with its
    overlap ``overlaps[k][j]``, names with their leading separator (the
    dataset reads ``data_root + name``)."""
    for k, (views, ov) in enumerate(zip(scenes, overlaps)):
        name = f"scene{k:04d}_00"
        pcd = os.path.join(root, name, "pcd")
        os.makedirs(pcd, exist_ok=True)
        for j, view in enumerate(views):
            _save({f: view[f] for f in ("coord", "color", "normal")},
                  os.path.join(pcd, f"{j:06d}.pth"))
        with open(os.path.join(pcd, "overlap.txt"), "w") as f:
            for j, o in enumerate(ov):
                f.write(f"/{name}/pcd/{j:06d}.pth /{name}/pcd/{j + 1:06d}.pth {o}\n")


def _save(data: dict, path: str) -> None:
    torch.save(data, path)
