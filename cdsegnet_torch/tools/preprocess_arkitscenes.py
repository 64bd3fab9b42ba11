"""Offline ARKitScenes preprocessing: 3DoD mesh plys -> per-scene archives.

Port of `tools/preprocess_arkitscenes.py` (host numpy, no JAX): the same archives
from the same raw input. Run as `python -m cdsegnet_torch.tools.preprocess_arkitscenes`;
`main(argv)` takes the arguments as a list.

Counterpart of
`pointcept/datasets/preprocessing/arkitscenes/preprocess_arkitscenes_mesh.py`
(87 LoC): reads `3dod/{Training,Validation}/<scene>/<scene>_3dod_mesh.ply`,
computes area-weighted vertex normals from the face mesh, and writes
`{split}/{scene}.pth` archives with coord/color/normal — the format
`ArkitScenesDataset` loads (scans are unlabeled; segment is synthesized by
the dataset class).

Self-contained: ships a minimal numpy PLY reader (binary little-endian and
ascii) instead of depending on `plyfile`, and computes vertex normals with a
vectorized scatter-add instead of the reference's Python loop over faces.
"""

import argparse
import glob
import os
from concurrent.futures import ProcessPoolExecutor
from itertools import repeat

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply_mesh(path):
    """Minimal PLY mesh reader -> (vertex record array, (F, 3) face indices).

    Supports binary_little_endian and ascii with fixed-arity vertex
    properties and one `list` property (vertex_indices) on faces — the
    layout ARKitScenes `_3dod_mesh.ply` files use.
    """
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype) ...], list_prop)
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens or tokens[0] == "comment":
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                elements.append([tokens[1], int(tokens[2]), [], None])
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    elements[-1][3] = (
                        tokens[4], _PLY_DTYPES[tokens[2]], _PLY_DTYPES[tokens[3]]
                    )
                else:
                    elements[-1][2].append((tokens[2], _PLY_DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break
        if fmt not in ("binary_little_endian", "ascii"):
            raise ValueError(f"{path}: unsupported PLY format {fmt}")

        out = {}
        for name, count, props, list_prop in elements:
            if list_prop is None:
                dtype = np.dtype([(p, "<" + t) for p, t in props])
                if fmt == "ascii":
                    rows = np.loadtxt(
                        [f.readline() for _ in range(count)], ndmin=2
                    )
                    arr = np.zeros(count, dtype)
                    for i, (p, _) in enumerate(props):
                        arr[p] = rows[:, i]
                else:
                    arr = np.frombuffer(f.read(count * dtype.itemsize), dtype)
                out[name] = arr
            else:
                _, cnt_t, idx_t = list_prop
                if fmt == "ascii":
                    faces = [
                        np.array(f.readline().split()[1:], dtype=np.int64)
                        for _ in range(count)
                    ]
                else:
                    cnt_dt = np.dtype("<" + cnt_t)
                    idx_dt = np.dtype("<" + idx_t)
                    faces = []
                    for _ in range(count):
                        (n,) = np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)
                        faces.append(
                            np.frombuffer(f.read(int(n) * idx_dt.itemsize), idx_dt)
                        )
                out[name + "_list"] = np.asarray(faces, np.int64)
        return out


def vertex_normals(coord: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (vectorized; reference loops per-face,
    `preprocess_arkitscenes_mesh.py:38-48`)."""
    v01 = coord[faces[:, 1]] - coord[faces[:, 0]]
    v02 = coord[faces[:, 2]] - coord[faces[:, 0]]
    fn = np.cross(v01, v02)  # magnitude = 2 * area: area weighting built in
    nv = np.zeros_like(coord)
    np.add.at(nv, faces.reshape(-1), np.repeat(fn, 3, axis=0))
    nv /= np.linalg.norm(nv, axis=1, keepdims=True) + 1e-8
    return nv


def parse_scene(scene_path: str, output_root: str) -> str:
    import torch  # CPU torch: Pointcept-compatible .pth archives

    split = os.path.basename(os.path.dirname(os.path.dirname(scene_path)))
    scene_id = os.path.basename(os.path.dirname(scene_path))
    ply = read_ply_mesh(scene_path)
    vtx = ply["vertex"]
    coord = np.stack(
        [vtx["x"], vtx["y"], vtx["z"]], axis=1
    ).astype(np.float32)
    color = np.stack(
        [vtx["red"], vtx["green"], vtx["blue"]], axis=1
    ).astype(np.float32)
    faces = ply["face_list"]
    data = dict(
        coord=coord,
        color=color,
        normal=vertex_normals(coord.astype(np.float64), faces).astype(np.float32),
        scene_id=scene_id,
    )
    os.makedirs(os.path.join(output_root, split), exist_ok=True)
    out_path = os.path.join(output_root, split, f"{scene_id}.pth")
    torch.save(data, out_path)
    return out_path


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_root", required=True,
                        help="ARKitScenes root containing 3dod/")
    parser.add_argument("--output_root", required=True)
    parser.add_argument("--num_workers", default=os.cpu_count(), type=int)
    args = parser.parse_args(argv)

    scene_paths = sorted(
        glob.glob(os.path.join(args.dataset_root, "3dod", "*", "*", "*_mesh.ply"))
    )
    if not scene_paths:
        raise SystemExit(f"no */*_mesh.ply under {args.dataset_root}/3dod")
    print(f"Processing {len(scene_paths)} scenes...")
    if args.num_workers <= 1:
        for p in scene_paths:
            parse_scene(p, args.output_root)
    else:
        with ProcessPoolExecutor(max_workers=args.num_workers) as pool:
            list(pool.map(parse_scene, scene_paths, repeat(args.output_root)))


if __name__ == "__main__":
    main()
