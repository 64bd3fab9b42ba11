"""Offline Structured3D preprocessing: rendered zips -> per-room archives.

Port of `tools/preprocess_structured3d.py` (host numpy, no JAX): the same archives
from the same raw input. Run as `python -m cdsegnet_torch.tools.preprocess_structured3d`;
`main(argv)` takes the arguments as a list.

Counterpart of
`pointcept/datasets/preprocessing/structured3d/preprocess_structured3d.py`
(431 LoC): unprojects the official 2D renderings (perspective and/or
panorama depth+rgb+semantic) into fused room point clouds, computes
cross-product normals, maps the NYU-40 semantic ids onto the 25-class
subset, and writes `{split}/{scene}/room_{id}.pth` archives — the format
`Structured3DDataset` loads. Scene→split follows the official id ranges
(<3000 train, 3000-3249 val, rest test).

Image decoding uses PIL only (16-bit depth PNGs load as mode "I"); no cv2
dependency.
"""

import argparse
import io
import os
import zipfile
from concurrent.futures import ProcessPoolExecutor
from itertools import repeat

import numpy as np

# NYU-40 ids retained in the 25-class benchmark subset (reference
# `preprocess_structured3d.py:30-56`; constants, must match to reproduce)
VALID_CLASS_IDS_25 = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 14, 15, 16, 17, 18, 19, 22, 24, 25, 32,
    34, 35, 38, 39, 40,
)

_Z2Y_TOP = np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]], np.float32)
_SWAP_YZ = np.array([[1, 0, 0], [0, 0, 1], [0, 1, 0]], np.float32)


def normals_from_grid(points_2d: np.ndarray) -> np.ndarray:
    """Cross-product normals on an (H, W, 3) unprojected depth grid."""
    pad = np.pad(points_2d, ((0, 1), (0, 1), (0, 0)), mode="symmetric")
    ver = (pad[:, :-1, :] - pad[:, 1:, :])[:-1, :, :]
    hor = (pad[:-1, :, :] - pad[1:, :, :])[:, :-1, :]
    n = np.cross(hor, ver)
    dist = np.linalg.norm(n, axis=-1, keepdims=True)
    return np.divide(n, dist, out=np.zeros_like(n), where=dist != 0)


class ZipSceneReader:
    """Random access over the sharded Structured3D zip files."""

    def __init__(self, zip_paths):
        if isinstance(zip_paths, str):
            zip_paths = [zip_paths]
        self.readers = [zipfile.ZipFile(p, "r") for p in zip_paths]
        self.index = {}
        for i, r in enumerate(self.readers):
            for name in r.namelist():
                self.index[name] = i

    def listdir(self, prefix):
        prefix = prefix.strip("/") + "/"
        names = {
            n[len(prefix):].split("/")[0]
            for n in self.index
            if n.startswith(prefix) and n != prefix
        }
        names.discard("")
        return sorted(names)

    def read(self, name):
        return self.readers[self.index[name]].read(name)

    def read_image(self, name):
        from PIL import Image

        return np.asarray(Image.open(io.BytesIO(self.read(name))))

    def read_depth(self, name):
        depth = self.read_image(name).astype(np.float32)[..., None]
        depth[depth == 0] = 65535.0  # 0 = no return -> filtered as far
        return depth

    def read_color(self, name):
        return self.read_image(name)[..., :3]

    def read_segment(self, name):
        return self.read_image(name)[..., None]

    def read_camera(self, name):
        ext = np.array(self.read(name).split(), np.float32)
        cam_t = _Z2Y_TOP @ (ext[:3] / 1000.0)
        if ext.shape[0] > 3:
            front, up = ext[3:6], ext[6:9]
            n = np.cross(front, up)
            cam_r = _Z2Y_TOP @ np.stack((front, up, n), axis=1).astype(np.float32)
            cam_f = ext[9:11]
        else:
            cam_r, cam_f = np.eye(3, dtype=np.float32), None
        return cam_r, cam_t, cam_f


def _filter_and_pack(cam_grid, world_grid, color, segment, depth, out_lists):
    """Validity filter in the CAMERA frame (view-ray/normal cosine is only
    meaningful relative to the camera origin), world-frame normals on the
    transformed grid — matching `preprocess_structured3d.py:241-262`."""
    cam_normal = normals_from_grid(cam_grid)
    view_dist = np.maximum(
        np.linalg.norm(cam_grid, axis=-1, keepdims=True), 1e-4
    )
    cosine = np.abs(np.sum(cam_grid * cam_normal / view_dist, axis=-1,
                           keepdims=True))
    mask = ((cosine > 0.15) & (depth < 65535) & (segment > 0))[..., 0].reshape(-1)
    if not mask.any():
        return False
    world_normal = normals_from_grid(world_grid)
    coords, colors, normals, segments = out_lists
    coords.append(world_grid.reshape(-1, 3)[mask])
    colors.append(color.reshape(-1, 3)[mask])
    normals.append(world_normal.reshape(-1, 3)[mask])
    segments.append(segment.reshape(-1, 1)[mask])
    return True


def unproject_perspective(reader, frame_path):
    """Perspective frame -> (camera grid, world grid, color, segment, depth)."""
    cam_r, cam_t, cam_f = reader.read_camera(
        os.path.join(frame_path, "camera_pose.txt")
    )
    depth = reader.read_depth(os.path.join(frame_path, "depth.png"))
    color = reader.read_color(os.path.join(frame_path, "rgb_rawlight.png"))
    segment = reader.read_segment(os.path.join(frame_path, "semantic.png"))
    fx, fy = cam_f
    h, w = depth.shape[:2]
    pixel = np.transpose(np.indices((w, h)), (2, 1, 0)).reshape(-1, 2)
    pixel = np.hstack([pixel, np.ones((pixel.shape[0], 1))])
    k = np.diag([w / 2 / np.tan(fx), h / 2 / np.tan(fy), 1.0])
    k[0, 2], k[1, 2] = w / 2, h / 2
    rays = (np.linalg.inv(k) @ pixel.T).T
    cam_grid = (depth.reshape(-1, 1) * rays).reshape(h, w, 3)
    cam_grid = cam_grid @ np.array([[0, 0, 1], [0, -1, 0], [1, 0, 0]], np.float32)
    world_grid = (cam_grid / 1000.0) @ cam_r.T + cam_t
    return cam_grid, world_grid, color, segment, depth


def unproject_panorama(reader, pano_path):
    """Equirectangular panorama -> (camera grid, world grid, color, segment,
    depth)."""
    _, cam_t, _ = reader.read_camera(os.path.join(pano_path, "camera_xyz.txt"))
    depth = reader.read_depth(os.path.join(pano_path, "full", "depth.png"))
    color = reader.read_color(os.path.join(pano_path, "full", "rgb_rawlight.png"))
    segment = reader.read_segment(os.path.join(pano_path, "full", "semantic.png"))
    h, w = depth.shape[:2]
    az = (np.arange(w, dtype=np.float32) / w * 2 * np.pi - np.pi)[None, :, None]
    el = (np.pi / 2 - np.arange(h, dtype=np.float32) / h * np.pi)[:, None, None]
    cam_grid = np.concatenate(
        [
            depth * np.cos(az) * np.cos(el),
            depth * np.sin(el),
            depth * np.sin(az) * np.cos(el),
        ],
        axis=-1,
    ) / 1000.0
    return cam_grid, cam_grid + cam_t, color, segment, depth


def parse_scene(scene, zip_paths, output_root, ignore_index=-1,
                fuse_prsp=True, fuse_pano=True):
    import torch  # CPU torch: Pointcept-compatible .pth archives

    assert fuse_prsp or fuse_pano
    reader = ZipSceneReader(zip_paths)
    scene_id = int(scene.split("_")[-1])
    split = "train" if scene_id < 3000 else ("val" if scene_id < 3250 else "test")
    scene_out = os.path.join(output_root, split, scene)
    os.makedirs(scene_out, exist_ok=True)
    written = []
    for room in reader.listdir(f"Structured3D/{scene}/2D_rendering"):
        room_path = f"Structured3D/{scene}/2D_rendering/{room}"
        lists = ([], [], [], [])
        if fuse_prsp:
            prsp = os.path.join(room_path, "perspective", "full")
            for frame in reader.listdir(prsp):
                try:
                    grids = unproject_perspective(
                        reader, os.path.join(prsp, frame)
                    )
                except (KeyError, ValueError, OSError):
                    continue
                _filter_and_pack(*grids, lists)
        if fuse_pano:
            try:
                grids = unproject_panorama(
                    reader, os.path.join(room_path, "panorama")
                )
            except (KeyError, ValueError, OSError):
                grids = None
            if grids is not None:
                _filter_and_pack(*grids, lists)
        coords, colors, normals, segments = lists
        if not coords:
            continue
        coord = np.concatenate(coords) @ _SWAP_YZ
        normal = np.concatenate(normals) @ _SWAP_YZ
        segment = np.concatenate(segments)
        segment25 = np.full_like(segment, ignore_index, dtype=np.int64)
        for new_id, nyu_id in enumerate(VALID_CLASS_IDS_25):
            segment25[segment == nyu_id] = new_id
        out_path = os.path.join(scene_out, f"room_{room}.pth")
        torch.save(
            dict(
                coord=coord.astype(np.float32),
                color=np.concatenate(colors).astype(np.uint8),
                normal=normal.astype(np.float32),
                semantic_gt=segment25.reshape(-1).astype(np.int16),
            ),
            out_path,
        )
        written.append(out_path)
    return written


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_root", required=True,
                        help="dir containing the Structured3D .zip shards")
    parser.add_argument("--output_root", required=True)
    parser.add_argument("--num_workers", default=os.cpu_count(), type=int)
    parser.add_argument("--ignore_index", default=-1, type=int)
    parser.add_argument("--no_perspective", action="store_true")
    parser.add_argument("--no_panorama", action="store_true")
    args = parser.parse_args(argv)

    zips = sorted(
        os.path.join(args.dataset_root, f)
        for f in os.listdir(args.dataset_root)
        if f.endswith(".zip")
    )
    if not zips:
        raise SystemExit(f"no .zip shards under {args.dataset_root}")
    scenes = ZipSceneReader(zips).listdir("Structured3D")
    print(f"Processing {len(scenes)} scenes from {len(zips)} shards...")
    for split in ("train", "val", "test"):
        os.makedirs(os.path.join(args.output_root, split), exist_ok=True)
    if args.num_workers <= 1:
        for s in scenes:
            parse_scene(s, zips, args.output_root, args.ignore_index,
                        not args.no_perspective, not args.no_panorama)
    else:
        with ProcessPoolExecutor(max_workers=args.num_workers) as pool:
            list(pool.map(
                parse_scene, scenes, repeat(zips), repeat(args.output_root),
                repeat(args.ignore_index), repeat(not args.no_perspective),
                repeat(not args.no_panorama),
            ))


if __name__ == "__main__":
    main()
