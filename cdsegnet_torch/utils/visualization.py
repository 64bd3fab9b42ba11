"""Point-cloud visualization: binary PLY dumps (reference
`pointcept/utils/visualization.py`, without the plyfile/open3d deps).

Port of `cdsegnet_tpu/utils/visualization.py`: the same palette and the same
PLY bytes. `save_segmentation` colours points by class id; `remap_to_origin`
lifts grid-sampled predictions back to the original points by a 1-NN search
(`ops.pointops.knn`) on a device, the card unless the caller names another,
in tiles: JAX's fallback there builds the dense (m, n) distance matrix.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from cdsegnet_torch.ops.pointops import knn
from cdsegnet_torch.utils.device import resolve_device

PLY_VERTEX = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
              ("r", "u1"), ("g", "u1"), ("b", "u1")]


def _palette(num_classes: int) -> np.ndarray:
    rng = np.random.RandomState(7)
    pal = rng.randint(40, 255, (max(num_classes, 1), 3)).astype(np.uint8)
    pal[: min(num_classes, 8)] = np.array(
        [
            (174, 199, 232), (152, 223, 138), (31, 119, 180), (255, 187, 120),
            (188, 189, 34), (140, 86, 75), (255, 152, 150), (214, 39, 40),
        ][: min(num_classes, 8)],
        np.uint8,
    )
    return pal


def save_point_cloud(coord: np.ndarray, color: Optional[np.ndarray] = None,
                     file_path: str = "pc.ply"):
    """Write a binary little-endian PLY of (N, 3) coords and optional
    (N, 3) colours (uint8, or clipped to 0-255)."""
    os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
    coord = np.asarray(coord, np.float32)
    n = coord.shape[0]
    if color is None:
        color = np.full((n, 3), 200, np.uint8)
    color = np.asarray(color)
    if color.dtype != np.uint8:
        color = np.clip(color, 0, 255).astype(np.uint8)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    rec = np.zeros(n, dtype=PLY_VERTEX)
    rec["x"], rec["y"], rec["z"] = coord[:, 0], coord[:, 1], coord[:, 2]
    rec["r"], rec["g"], rec["b"] = color[:, 0], color[:, 1], color[:, 2]
    with open(file_path, "wb") as f:
        f.write(header.encode())
        f.write(rec.tobytes())


def save_segmentation(coord: np.ndarray, labels: np.ndarray, file_path: str,
                      num_classes: Optional[int] = None, ignore_index: int = -1):
    """Colour points by class id (ignored points gray)."""
    labels = np.asarray(labels).reshape(-1)
    k = num_classes or int(labels.max()) + 1
    pal = _palette(k)
    color = np.full((labels.shape[0], 3), 128, np.uint8)
    ok = labels != ignore_index
    color[ok] = pal[np.clip(labels[ok], 0, k - 1)]
    save_point_cloud(coord, color, file_path)


def read_ply(file_path: str):
    """Read back a PLY written by `save_point_cloud`: (coord, color)."""
    with open(file_path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        n = int([ln for ln in header.decode().splitlines()
                 if ln.startswith("element")][0].split()[-1])
        rec = np.frombuffer(f.read(), dtype=PLY_VERTEX, count=n)
    coord = np.stack([rec["x"], rec["y"], rec["z"]], -1)
    color = np.stack([rec["r"], rec["g"], rec["b"]], -1)
    return coord, color


def remap_to_origin(origin_coord: np.ndarray, coord: np.ndarray, labels: np.ndarray,
                    device: Optional[Union[str, torch.device]] = None) -> np.ndarray:
    """The label of each original point's nearest sampled point (the
    lowest index among equal distances), searched on ``device``."""
    dev = resolve_device(device)
    query = torch.as_tensor(np.asarray(origin_coord, np.float32), device=dev)
    ref = torch.as_tensor(np.asarray(coord, np.float32), device=dev)
    idx, _ = knn(query, ref, 1)
    return np.asarray(labels)[idx[:, 0].cpu().numpy()]
