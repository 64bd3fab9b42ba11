"""Dump tester predictions (and ground truth) as coloured PLY point clouds.

Usage:
    python -m cdsegnet_torch.tools.visualize --scene data/scannet/val/scene0011_00.pth \
        [--pred exp/default/result/scene0011_00_pred.npy] \
        [--sampled-coord coords.npy] [--out exp/default/viz] [--num-classes 20] \
        [--device cpu]

Counterpart of `tools/visualize.py`, with the same arguments and files:
``<name>_rgb.ply`` (the scene's colours), ``<name>_gt.ply`` (its labels) and
``<name>_pred.ply``. A prediction made on a grid-sampled subset of the scene
is lifted to the original points by a 1-NN search over
``--sampled-coord``, on the card unless ``--device`` names another device.
`main(argv)` takes the arguments as a list.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from cdsegnet_torch.data.datasets import _load_scene
from cdsegnet_torch.utils.visualization import (remap_to_origin, save_point_cloud,
                                                 save_segmentation)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", required=True, help=".pth / .npy-dir scene file")
    ap.add_argument("--pred", default=None, help="prediction .npy (class ids)")
    ap.add_argument("--sampled-coord", default=None,
                    help="coords .npy matching --pred when it was produced "
                         "on a grid-sampled subset of the scene")
    ap.add_argument("--out", default="viz")
    ap.add_argument("--num-classes", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="device of the 1-NN lift (default: the GPU)")
    args = ap.parse_args(argv)

    data = _load_scene(args.scene)
    coord = np.asarray(data["coord"], np.float32)
    name = os.path.splitext(os.path.basename(args.scene))[0]
    if "color" in data:
        save_point_cloud(coord, np.asarray(data["color"]),
                         os.path.join(args.out, f"{name}_rgb.ply"))
    for key in ("semantic_gt20", "semantic_gt200", "semantic_gt", "segment"):
        if key in data:
            save_segmentation(coord, np.asarray(data[key]).reshape(-1),
                              os.path.join(args.out, f"{name}_gt.ply"), args.num_classes)
            break
    if args.pred:
        pred = np.load(args.pred).reshape(-1)
        if pred.shape[0] != coord.shape[0]:
            if not args.sampled_coord:
                raise SystemExit(
                    f"prediction has {pred.shape[0]} points but the scene has "
                    f"{coord.shape[0]}; grid-sampled points are a scattered "
                    "subset, not a prefix — pass --sampled-coord <npy> with "
                    "the sampled coordinates to 1-NN-lift the labels")
            sampled = np.load(args.sampled_coord).reshape(-1, 3)
            assert sampled.shape[0] == pred.shape[0]
            pred = remap_to_origin(coord, sampled, pred, device=args.device)
        save_segmentation(coord, pred, os.path.join(args.out, f"{name}_pred.ply"),
                          args.num_classes)
    print(f"wrote PLYs to {args.out}/")


if __name__ == "__main__":
    main()
