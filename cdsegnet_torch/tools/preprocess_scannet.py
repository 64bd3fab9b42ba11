"""Offline ScanNet preprocessing: raw scans -> per-scene tensors.

Port of `tools/preprocess_scannet.py` (host numpy, no JAX): the same archives
from the same raw input. Run as `python -m cdsegnet_torch.tools.preprocess_scannet`;
`main(argv)` takes the arguments as a list.

Counterpart of
`pointcept/datasets/preprocessing/scannet/preprocess_scannet.py` (247 LoC):
reads `scene*/_vh_clean_2.ply`, the over-segmentation
(`*.0.010000.segs.json`), the aggregation file (`*.aggregation.json`) and
the `scannetv2-labels.combined.tsv` category table, and writes
`{split}/{scene}.pth` archives with
coord/color/normal/semantic_gt20/semantic_gt200/instance_gt — the format
`ScanNetDataset`/`ScanNet200Dataset` load.

Requires `plyfile` (not bundled in this image) — degrades to a clear error
when missing. Pointcept-preprocessed data needs no preprocessing.
"""

import argparse
import csv
import glob
import json
import os
import sys

import numpy as np

try:
    from plyfile import PlyData
except ImportError:  # pragma: no cover
    PlyData = None

from cdsegnet_torch.data.datasets import (
    VALID_CLASS_IDS_20,
    VALID_CLASS_IDS_200,
)

IGNORE = -1


def load_label_map(tsv_path):
    """raw category string -> (nyu40 id, scannet raw id) from the combined
    labels TSV."""
    out = {}
    with open(tsv_path, newline="") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            try:
                out[row["raw_category"]] = (
                    int(row["nyu40id"]) if row.get("nyu40id") else 0,
                    int(row["id"]) if row.get("id") else 0,
                )
            except ValueError:
                continue
    return out


def vertex_normals(vertices, faces):
    """Area-weighted vertex normals (reference `preprocess_scannet.py:73-93`)."""
    v01 = vertices[faces[:, 1]] - vertices[faces[:, 0]]
    v02 = vertices[faces[:, 2]] - vertices[faces[:, 0]]
    nf = np.cross(v01, v02)  # length = 2x area -> area weighting built in
    nv = np.zeros_like(vertices)
    for i in range(3):
        np.add.at(nv, faces[:, i], nf)
    return nv / (np.linalg.norm(nv, axis=1, keepdims=True) + 1e-8)


def process_scene(scene_dir, out_dir, label_map, with_labels=True):
    import torch

    scene = os.path.basename(scene_dir.rstrip("/"))
    ply = PlyData.read(os.path.join(scene_dir, f"{scene}_vh_clean_2.ply"))
    v = ply["vertex"]
    coord = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    color = np.stack([v["red"], v["green"], v["blue"]], axis=1).astype(np.float32)
    faces = np.stack(ply["face"]["vertex_indices"]).astype(np.int64)
    data = dict(
        coord=coord,
        color=color,
        normal=vertex_normals(coord, faces).astype(np.float32),
        scene_id=scene,
    )

    segs_file = os.path.join(scene_dir, f"{scene}_vh_clean_2.0.010000.segs.json")
    agg_file = os.path.join(scene_dir, f"{scene}.aggregation.json")
    if with_labels and os.path.exists(segs_file) and os.path.exists(agg_file):
        with open(segs_file) as f:
            seg_indices = np.asarray(json.load(f)["segIndices"])
        with open(agg_file) as f:
            seg_groups = json.load(f)["segGroups"]
        gt20 = np.full((coord.shape[0],), IGNORE, np.int64)
        gt200 = np.full((coord.shape[0],), IGNORE, np.int64)
        inst = np.full((coord.shape[0],), IGNORE, np.int64)
        for group in seg_groups:
            nyu40, raw_id = label_map.get(group["label"], (0, 0))
            id20 = (
                VALID_CLASS_IDS_20.index(nyu40)
                if nyu40 in VALID_CLASS_IDS_20 else IGNORE
            )
            id200 = (
                VALID_CLASS_IDS_200.index(raw_id)
                if raw_id in VALID_CLASS_IDS_200 else IGNORE
            )
            point_idx = np.where(np.isin(seg_indices, group["segments"]))[0]
            gt20[point_idx] = id20
            gt200[point_idx] = id200
            inst[point_idx] = group["id"]
        data.update(semantic_gt20=gt20, semantic_gt200=gt200, instance_gt=inst)

    torch.save(data, os.path.join(out_dir, f"{scene}.pth"))


def main(argv=None):
    if PlyData is None:
        print("plyfile is required for raw ScanNet preprocessing; "
              "use Pointcept-preprocessed data instead.", file=sys.stderr)
        sys.exit(1)
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset_root", required=True)
    ap.add_argument("--output_root", required=True)
    ap.add_argument("--splits", nargs="*", default=["train", "val"])
    args = ap.parse_args(argv)
    meta = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "data", "meta", "scannetv2")
    tsv = os.path.join(args.dataset_root, "scannetv2-labels.combined.tsv")
    label_map = load_label_map(tsv) if os.path.exists(tsv) else {}
    for split in args.splits:
        out = os.path.join(args.output_root, split)
        os.makedirs(out, exist_ok=True)
        split_file = os.path.join(meta, f"scannetv2_{split}.txt")
        if os.path.exists(split_file):
            scenes = [s.strip() for s in open(split_file)]
        else:
            scenes = [os.path.basename(d) for d in
                      glob.glob(os.path.join(args.dataset_root, "scans", "scene*"))]
        for scene in scenes:
            process_scene(
                os.path.join(args.dataset_root, "scans", scene), out,
                label_map, with_labels=split != "test",
            )
            print(f"[{split}] {scene}")


if __name__ == "__main__":
    main()
