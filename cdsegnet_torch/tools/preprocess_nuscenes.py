"""Generate nuScenes lidarseg info pickles (devkit-free).

Port of `tools/preprocess_nuscenes.py` (host numpy, no JAX): the same archives
from the same raw input. Run as `python -m cdsegnet_torch.tools.preprocess_nuscenes`;
`main(argv)` takes the arguments as a list.

Counterpart of
`pointcept/datasets/preprocessing/nuscenes/preprocess_nuscenes_info.py`
(607 LoC over nuscenes-devkit), reduced to what `NuScenesDataset` consumes
per sample: ``lidar_path``, ``gt_segment_path`` and ``lidar_token``
(`data/datasets.py` NuScenesDataset.get_data). Reads the raw
JSON metadata tables directly:

    raw/v1.0-trainval/{scene,sample,sample_data,lidarseg}.json

Scene-level train/val splits come from `nuscenes.utils.splits` when the
devkit is importable, else from `--train_scenes/--val_scenes` text files
(one scene name per line).

Output: ``info/nuscenes_infos_{sweeps}sweeps_{split}.pkl`` under
``--output_root``.
"""

import argparse
import json
import os
import pickle
import sys


def load_table(meta_dir, name):
    with open(os.path.join(meta_dir, f"{name}.json")) as f:
        return json.load(f)


def build_infos(raw_root, version="v1.0-trainval"):
    meta = os.path.join(raw_root, version)
    scenes = {s["token"]: s for s in load_table(meta, "scene")}
    samples = load_table(meta, "sample")
    sample_data = load_table(meta, "sample_data")
    try:
        lidarseg = {
            r["sample_data_token"]: r["filename"]
            for r in load_table(meta, "lidarseg")
        }
    except FileNotFoundError:
        lidarseg = {}

    # keyframe LIDAR_TOP sample_data per sample
    lidar_by_sample = {}
    for sd in sample_data:
        if sd["is_key_frame"] and "LIDAR_TOP" in sd["filename"].upper():
            lidar_by_sample[sd["sample_token"]] = sd
    infos = {}
    for sample in samples:
        sd = lidar_by_sample.get(sample["token"])
        if sd is None:
            continue
        scene_name = scenes[sample["scene_token"]]["name"]
        info = dict(
            lidar_path=sd["filename"],
            lidar_token=sd["token"],
            sample_token=sample["token"],
            scene_name=scene_name,
            timestamp=sd["timestamp"],
        )
        if sd["token"] in lidarseg:
            info["gt_segment_path"] = lidarseg[sd["token"]]
        infos.setdefault(scene_name, []).append(info)
    return infos


def official_splits():
    try:
        from nuscenes.utils import splits

        return set(splits.train), set(splits.val)
    except ImportError:
        return None, None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset_root", required=True,
                    help="dir containing raw/ (with v1.0-trainval tables)")
    ap.add_argument("--output_root", required=True)
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--sweeps", type=int, default=10,
                    help="naming only; single-keyframe infos are emitted")
    ap.add_argument("--train_scenes", default=None)
    ap.add_argument("--val_scenes", default=None)
    args = ap.parse_args(argv)

    raw = os.path.join(args.dataset_root, "raw")
    if not os.path.isdir(os.path.join(raw, args.version)):
        raw = args.dataset_root
    infos = build_infos(raw, args.version)

    train_set, val_set = official_splits()
    if args.train_scenes:
        train_set = {ln.strip() for ln in open(args.train_scenes) if ln.strip()}
    if args.val_scenes:
        val_set = {ln.strip() for ln in open(args.val_scenes) if ln.strip()}
    if train_set is None:
        print("nuscenes-devkit not importable and no scene lists given: "
              "emitting everything as 'train'", file=sys.stderr)
        train_set = set(infos)
        val_set = set()

    out_dir = os.path.join(args.output_root, "info")
    os.makedirs(out_dir, exist_ok=True)
    for split, names in (("train", train_set), ("val", val_set)):
        entries = [
            info for scene, lst in sorted(infos.items()) if scene in names
            for info in lst
        ]
        path = os.path.join(
            out_dir, f"nuscenes_infos_{args.sweeps}sweeps_{split}.pkl"
        )
        with open(path, "wb") as f:
            pickle.dump(entries, f)
        print(f"{split}: {len(entries)} samples -> {path}")


if __name__ == "__main__":
    main()
