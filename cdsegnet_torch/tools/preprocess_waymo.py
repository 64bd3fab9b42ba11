"""Offline Waymo Open preprocessing: segmentation tfrecords -> kitti layout.

Port of `tools/preprocess_waymo.py` (host numpy, no JAX): the same archives
from the same raw input. Run as `python -m cdsegnet_torch.tools.preprocess_waymo`;
`main(argv)` takes the arguments as a list.

Counterpart of
`pointcept/datasets/preprocessing/waymo/preprocess_waymo.py` (204 LoC):
iterates the per-sequence `.tfrecord` shards, keeps only frames that carry
3D segmentation labels, converts both lidar returns of every laser from
range-image to vehicle-frame cartesian points, and writes
`{split}/{sequence}/velodyne/{frame:06d}.bin` ([x, y, z, intensity]
float32) plus `labels/{frame:06d}.label` ((N, 2) int32
[instance_id, semantic_class]) — the exact layout `WaymoDataset` loads.

The reference leans on TensorFlow + `waymo_open_dataset.utils.frame_utils`
for everything. Here only the *proto schema* comes from the
`waymo_open_dataset` devkit (gated import — it is the sole authoritative
definition of the Frame message); TFRecord framing is read with the
stdlib, and the range-image -> point-cloud math (beam inclinations,
azimuth correction, extrinsic transform, per-pixel rolling-shutter pose
for the top lidar) is reimplemented as pure numpy so it is unit-testable
without the devkit.
"""

import argparse
import glob
import os
import struct
import zlib
from concurrent.futures import ProcessPoolExecutor
from itertools import repeat

import numpy as np


def iter_tfrecord(path):
    """Yield raw record payloads from a TFRecord file (stdlib only).

    Framing per record: uint64-LE length, uint32 masked-crc32c of the
    length, `length` payload bytes, uint32 masked-crc32c of the payload.
    CRCs are skipped (crc32c is not in the stdlib; corrupt shards fail in
    the proto parser anyway).
    """
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            payload = f.read(length)
            if len(payload) < length:
                raise EOFError(f"{path}: truncated record ({len(payload)}/{length})")
            f.read(4)  # payload crc
            yield payload


def _pose_rotation(pose):
    """(..., 6) [roll, pitch, yaw, x, y, z] -> (..., 3, 3) rotation."""
    roll, pitch, yaw = pose[..., 0], pose[..., 1], pose[..., 2]
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    r = np.empty(pose.shape[:-1] + (3, 3), np.float64)
    r[..., 0, 0] = cy * cp
    r[..., 0, 1] = cy * sp * sr - sy * cr
    r[..., 0, 2] = cy * sp * cr + sy * sr
    r[..., 1, 0] = sy * cp
    r[..., 1, 1] = sy * sp * sr + cy * cr
    r[..., 1, 2] = sy * sp * cr - cy * sr
    r[..., 2, 0] = -sp
    r[..., 2, 1] = cp * sr
    r[..., 2, 2] = cp * cr
    return r


def range_image_to_cartesian(
    range_image: np.ndarray,
    inclinations: np.ndarray,
    extrinsic: np.ndarray,
    pixel_pose: np.ndarray = None,
    frame_pose: np.ndarray = None,
):
    """Range image -> (H, W, 3) vehicle-frame cartesian points.

    Pure-numpy equivalent of the devkit's
    `range_image_utils.extract_point_cloud_from_range_image`:

    - `range_image`: (H, W) ranges in meters; row 0 is the *top* beam.
    - `inclinations`: (H,) per-row beam inclination in radians, already in
      row order (top first).
    - `extrinsic`: (4, 4) sensor-to-vehicle transform. Azimuth is offset
      by the sensor yaw so column azimuths stay aligned with the vehicle
      frame, matching the devkit's `azimuth_correction`.
    - `pixel_pose`: optional (H, W, 6) [roll, pitch, yaw, x, y, z]
      per-pixel vehicle-to-world pose (top lidar rolling-shutter
      correction); requires `frame_pose` (4, 4) vehicle-to-world at the
      frame timestamp; points come back in the frame's vehicle frame.
    """
    h, w = range_image.shape
    azimuth_correction = np.arctan2(extrinsic[1, 0], extrinsic[0, 0])
    azimuth = (
        (0.5 - (np.arange(w, dtype=np.float64) + 0.5) / w) * 2.0 * np.pi
        - azimuth_correction
    )[None, :]
    incl = np.asarray(inclinations, np.float64)[:, None]
    r = np.asarray(range_image, np.float64)
    cos_incl = np.cos(incl)
    points = np.stack(
        [
            r * cos_incl * np.cos(azimuth),
            r * cos_incl * np.sin(azimuth),
            r * np.sin(incl) * np.ones_like(azimuth),
        ],
        axis=-1,
    )
    points = points @ extrinsic[:3, :3].T + extrinsic[:3, 3]
    if pixel_pose is not None:
        rot = _pose_rotation(pixel_pose)
        world = np.einsum("hwij,hwj->hwi", rot, points) + pixel_pose[..., 3:6]
        inv = np.linalg.inv(np.asarray(frame_pose, np.float64))
        points = world @ inv[:3, :3].T + inv[:3, 3]
    return points


def convert_frame_arrays(lasers, testing=False):
    """Per-laser dicts -> (velodyne (N, 4) float32, labels (N, 2) int32).

    `lasers` is a list of dicts sorted by laser name, each with:
      ``ri``: list of (H, W, C) float range images (returns 1, 2) where
      channel 0 = range (m), channel 1 = intensity;
      ``inclinations``: (H,) top-first; ``extrinsic``: (4, 4);
      optional ``pixel_pose`` (H, W, 6) + ``frame_pose`` (4, 4);
      optional ``labels``: list of (H, W, 2) int32 per return.

    Mirrors the reference's concatenation order — all lasers for return 1,
    then all lasers for return 2 (`preprocess_waymo.py:40-61`) — and its
    column choice velodyne=[x, y, z, intensity] (`:63`).
    """
    points_by_return = ([], [])
    labels_by_return = ([], [])
    for laser in lasers:
        for ri_index, ri in enumerate(laser["ri"]):
            mask = ri[..., 0] > 0
            xyz = range_image_to_cartesian(
                ri[..., 0],
                laser["inclinations"],
                laser["extrinsic"],
                laser.get("pixel_pose"),
                laser.get("frame_pose"),
            )
            pts = np.concatenate([xyz[mask], ri[..., 1][mask][:, None]], axis=1)
            points_by_return[ri_index].append(pts.astype(np.float32))
            if not testing:
                lab = laser.get("labels")
                if lab is not None and lab[ri_index] is not None:
                    labels_by_return[ri_index].append(
                        np.asarray(lab[ri_index], np.int32)[mask]
                    )
                else:
                    labels_by_return[ri_index].append(
                        np.zeros((int(mask.sum()), 2), np.int32)
                    )
    velodyne = np.concatenate(points_by_return[0] + points_by_return[1], axis=0)
    if testing:
        return velodyne.astype(np.float32), None
    labels = np.concatenate(labels_by_return[0] + labels_by_return[1], axis=0)
    return velodyne.astype(np.float32), labels


def write_frame(save_path, frame_idx, velodyne, labels):
    name = f"{frame_idx:06d}"
    os.makedirs(os.path.join(save_path, "velodyne"), exist_ok=True)
    velodyne.astype(np.float32).tofile(
        os.path.join(save_path, "velodyne", f"{name}.bin")
    )
    if labels is not None:
        os.makedirs(os.path.join(save_path, "labels"), exist_ok=True)
        labels.astype(np.int32).tofile(
            os.path.join(save_path, "labels", f"{name}.label")
        )


def _decompress_matrix(compressed, proto_cls):
    """zlib-compressed MatrixFloat/MatrixInt32 proto -> numpy array."""
    m = proto_cls()
    m.ParseFromString(zlib.decompress(compressed))
    return np.array(m.data).reshape(tuple(m.shape.dims))


def _frame_lasers(frame, dataset_pb2):
    """waymo_open_dataset Frame proto -> the plain dicts
    `convert_frame_arrays` consumes."""
    calibrations = {
        c.name: c for c in frame.context.laser_calibrations
    }
    frame_pose = np.array(frame.pose.transform, np.float64).reshape(4, 4)
    top_pose = None
    lasers = []
    for laser in sorted(frame.lasers, key=lambda l: l.name):
        c = calibrations[laser.name]
        extrinsic = np.array(c.extrinsic.transform, np.float64).reshape(4, 4)
        ris, labs = [], []
        for ri_proto in (laser.ri_return1, laser.ri_return2):
            ri = _decompress_matrix(
                ri_proto.range_image_compressed, dataset_pb2.MatrixFloat
            )
            ris.append(ri)
            if ri_proto.segmentation_label_compressed:
                sl = _decompress_matrix(
                    ri_proto.segmentation_label_compressed,
                    dataset_pb2.MatrixInt32,
                )
                labs.append(sl.astype(np.int32))
            else:
                labs.append(None)
            if (
                laser.name == dataset_pb2.LaserName.TOP
                and top_pose is None
                and ri_proto.range_image_pose_compressed
            ):
                top_pose = _decompress_matrix(
                    ri_proto.range_image_pose_compressed,
                    dataset_pb2.MatrixFloat,
                )
        if len(c.beam_inclinations) > 0:
            # calibration stores bottom-first; range-image rows are
            # top-first (devkit reverses, frame_utils.py)
            inclinations = np.array(c.beam_inclinations, np.float64)[::-1]
        else:
            h = ris[0].shape[0]
            inclinations = np.linspace(
                c.beam_inclination_min, c.beam_inclination_max, h
            )[::-1]
        entry = dict(
            ri=ris, labels=labs, inclinations=inclinations, extrinsic=extrinsic
        )
        if laser.name == dataset_pb2.LaserName.TOP and top_pose is not None:
            entry["pixel_pose"] = top_pose
            entry["frame_pose"] = frame_pose
        lasers.append(entry)
    return lasers


def handle_process(file_path, output_root):
    try:
        from waymo_open_dataset import dataset_pb2
    except ImportError as e:  # the devkit owns the Frame proto schema
        raise SystemExit(
            "preprocess_waymo requires the `waymo-open-dataset` devkit for "
            "the Frame proto schema (pip install waymo-open-dataset-tf-*); "
            f"import failed: {e}"
        )

    file = os.path.basename(file_path)
    split = os.path.basename(os.path.dirname(file_path))
    print(f"Parsing {split}/{file}")
    save_path = os.path.join(output_root, split, file.split(".")[0])
    testing = split == "testing"

    count = 0
    for payload in iter_tfrecord(file_path):
        frame = dataset_pb2.Frame()
        frame.ParseFromString(payload)
        # keep only frames with 3D segmentation labels (reference `:145`)
        if not frame.lasers[0].ri_return1.segmentation_label_compressed:
            continue
        lasers = _frame_lasers(frame, dataset_pb2)
        velodyne, labels = convert_frame_arrays(lasers, testing=testing)
        write_frame(save_path, count, velodyne, labels)
        count += 1
    return count


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_root", required=True,
                        help="dir with {training,validation,testing}/*.tfrecord")
    parser.add_argument("--output_root", required=True)
    parser.add_argument("--splits", nargs="+", default=["training", "validation"],
                        choices=["training", "validation", "testing"])
    parser.add_argument("--num_workers", default=os.cpu_count(), type=int)
    args = parser.parse_args(argv)

    file_list = [
        f
        for f in glob.glob(
            os.path.join(os.path.abspath(args.dataset_root), "*", "*.tfrecord")
        )
        if os.path.basename(os.path.dirname(f)) in args.splits
    ]
    if not file_list:
        raise SystemExit(f"no */*.tfrecord under {args.dataset_root}")
    for split in args.splits:
        os.makedirs(os.path.join(args.output_root, split), exist_ok=True)
    print(f"Processing {len(file_list)} sequences...")
    if args.num_workers <= 1:
        for f in file_list:
            handle_process(f, args.output_root)
    else:
        with ProcessPoolExecutor(max_workers=args.num_workers) as pool:
            list(pool.map(handle_process, file_list, repeat(args.output_root)))


if __name__ == "__main__":
    main()
