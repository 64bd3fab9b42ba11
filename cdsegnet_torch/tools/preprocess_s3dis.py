"""Offline S3DIS preprocessing: Stanford raw rooms -> per-room tensors.

Port of `tools/preprocess_s3dis.py` (host numpy, no JAX): the same archives
from the same raw input. Run as `python -m cdsegnet_torch.tools.preprocess_s3dis`;
`main(argv)` takes the arguments as a list.

Counterpart of
`pointcept/datasets/preprocessing/s3dis/preprocess_s3dis.py` (234 LoC):
every `Area_*/room_*/Annotations/<class>_<i>.txt` object file contributes
its points; semantic labels come from the 13-class table (unknown classes
fold into "clutter" like the reference), instances are the object files.
Writes `{Area_X}/{room}.pth` archives compatible with `S3DISDataset`.

Normal parsing (reference's open3d/trimesh mesh-crop path) is omitted —
S3DIS recipes here use coord+color features.
"""

import argparse
import glob
import os
import sys

import numpy as np

CLASSES = [
    "ceiling", "floor", "wall", "beam", "column", "window", "door",
    "table", "chair", "sofa", "bookcase", "board", "clutter",
]
CLASS2LABEL = {c: i for i, c in enumerate(CLASSES)}


def parse_room(room_dir: str, save_path: str):
    import torch

    coords, colors, segs, insts = [], [], [], []
    object_files = sorted(glob.glob(os.path.join(room_dir, "Annotations", "*.txt")))
    if not object_files:
        return False
    for object_id, path in enumerate(object_files):
        name = os.path.basename(path).split("_")[0]
        cls = name if name in CLASS2LABEL else "clutter"  # e.g. 'stairs'
        obj = np.loadtxt(path)
        coords.append(obj[:, :3])
        colors.append(obj[:, 3:6])
        segs.append(np.full((obj.shape[0],), CLASS2LABEL[cls], np.int64))
        insts.append(np.full((obj.shape[0],), object_id, np.int64))
    os.makedirs(os.path.dirname(save_path), exist_ok=True)
    torch.save(
        dict(
            coord=np.ascontiguousarray(np.vstack(coords)).astype(np.float32),
            color=np.ascontiguousarray(np.vstack(colors)).astype(np.float32),
            semantic_gt=np.concatenate(segs),
            instance_gt=np.concatenate(insts),
        ),
        save_path,
    )
    return True


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset_root", required=True,
                    help="Stanford3dDataset_v1.2_Aligned_Version root")
    ap.add_argument("--output_root", required=True)
    args = ap.parse_args(argv)
    rooms = sorted(
        glob.glob(os.path.join(args.dataset_root, "Area_*", "*"))
    )
    n = 0
    for room_dir in rooms:
        if not os.path.isdir(room_dir):
            continue
        rel = os.path.relpath(room_dir, args.dataset_root)
        if parse_room(room_dir, os.path.join(args.output_root, rel + ".pth")):
            n += 1
            print(rel)
    if n == 0:
        print("no rooms found", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
