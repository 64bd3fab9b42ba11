"""Datasets: the base dataset, ScanNet, ScanNet200, nuScenes, SemanticKITTI,
ModelNet40, ShapeNetPart, S3DIS, Structured3D, Waymo, ARKitScenes, ScanNet
view pairs and their concatenation.

Port of the datasets of `cdsegnet_tpu/data/datasets.py` and its
`build_dataset` (reference `pointcept/datasets/{defaults,scannet,nuscenes,
semantic_kitti,modelnet,shapenet_part,s3dis,structure3d,waymo,arkitscenes,
scannet_pair}.py`): plain indexable objects whose ``get(idx, rng)`` runs
the transform pipeline with an explicit numpy generator; in test mode it
expands every test-time augmentation into fragments. Scene files are
Pointcept `.pth` archives or per-field `.npy` directories; nuScenes sweeps
are listed by an info pickle and read from `.bin` files, SemanticKITTI and
Waymo scans are globbed per sequence; ModelNet40 and ShapeNetPart shapes are
text files, with the shape's class in ``category``. `ConcatDataset` chains
datasets (PPT's multi-dataset training reads each through its own loader);
`ScanNetPairDataset` gives two transformed views of overlapping scans (MSC
pretraining). With ``cache=True`` the datasets that read `.pth` or `.npy`
scenes decode each once into the shared cache (`data/cache.py`); in test
mode a ``crop`` (`SphereCrop` mode "all") splits every voxelized part into
covering crops.
"""

from __future__ import annotations

import glob
import json
import os
import pickle
from copy import deepcopy
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from cdsegnet_torch.data.cache import shared_dict
from cdsegnet_torch.data.transforms import TRANSFORMS, Compose
from cdsegnet_torch.utils.registry import Registry

DATASETS = Registry("datasets")


def _load_scene(path: str) -> Dict:
    if os.path.isdir(path):
        data = {}
        for f in glob.glob(os.path.join(path, "*.npy")):
            data[os.path.splitext(os.path.basename(f))[0]] = np.load(f)
        data["scene_id"] = os.path.basename(path)
        return data
    # Pointcept archives hold numpy arrays, which weights_only refuses
    data = torch.load(path, map_location="cpu", weights_only=False)
    return {
        k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in data.items()
    }


@DATASETS.register_module()
class DefaultDataset:
    """Reference `DefaultDataset` (`defaults.py:21-181`)."""

    def __init__(
        self,
        split: str = "train",
        data_root: str = "data/dataset",
        transform=None,
        test_mode: bool = False,
        test_cfg: Optional[Dict] = None,
        loop: int = 1,
        ignore_index: int = -1,
        cache: bool = False,
    ):
        self.split = split
        self.data_root = data_root
        self.transform = Compose(transform)
        self.test_mode = test_mode
        self.test_cfg = test_cfg if test_mode else None
        self.loop = loop if not test_mode else 1
        self.ignore_index = ignore_index
        self.cache = cache
        if test_mode:
            tc = dict(test_cfg or {})
            self.test_voxelize = (
                TRANSFORMS.build(dict(tc["voxelize"])) if tc.get("voxelize") else None
            )
            self.test_crop = (
                TRANSFORMS.build(dict(tc["crop"])) if tc.get("crop") else None
            )
            self.post_transform = Compose(tc.get("post_transform"))
            self.aug_transform = [Compose(a) for a in tc.get("aug_transform", [[]])]
        self.data_list = self.get_data_list()

    def get_data_list(self) -> List[str]:
        if isinstance(self.split, str):
            splits = [self.split]
        else:
            splits = list(self.split)
        out = []
        for s in splits:
            out += sorted(glob.glob(os.path.join(self.data_root, s, "*")))
        return out

    def _load(self, path: str) -> Dict:
        """The scene at ``path``, through the shared decode cache when
        ``cache`` is set (reference `DataCacheOperator`, `scannet.py:44-60`)."""
        if not self.cache:
            return _load_scene(path)
        return shared_dict(path, lambda: _load_scene(path))

    def get_data(self, idx: int) -> Dict:
        data = self._load(self.data_list[idx % len(self.data_list)])
        coord = np.asarray(data["coord"], np.float32)
        out = dict(coord=coord)
        for k in ("color", "normal", "strength"):
            if k in data:
                out[k] = np.asarray(data[k], np.float32)
        if "semantic_gt" in data:
            out["segment"] = np.asarray(data["semantic_gt"]).reshape(-1).astype(np.int64)
        elif "segment" in data:
            out["segment"] = np.asarray(data["segment"]).reshape(-1).astype(np.int64)
        else:
            out["segment"] = np.full((coord.shape[0],), self.ignore_index, np.int64)
        for k in ("instance_gt", "instance"):
            if k in data:
                out["instance"] = np.asarray(data[k]).reshape(-1).astype(np.int64)
                break
        return out

    def get_data_name(self, idx: int) -> str:
        return os.path.splitext(
            os.path.basename(self.data_list[idx % len(self.data_list)])
        )[0]

    def prepare_train_data(self, idx: int, rng: np.random.Generator) -> Dict:
        return self.transform(self.get_data(idx), rng)

    def prepare_test_data(self, idx: int, rng: np.random.Generator) -> Dict:
        """Per-TTA-aug fragment expansion (reference `defaults.py:115-155`)."""
        data = self.get_data(idx)
        segment = data.pop("segment")
        result = dict(segment=segment, name=self.get_data_name(idx))
        if "category" in data:
            result["category"] = int(data.pop("category"))
        data = self.transform(data, rng)
        fragment_list = []
        for aug in self.aug_transform:
            aug_data = aug(deepcopy(data), rng)
            if self.test_voxelize is not None:
                parts = self.test_voxelize(aug_data, rng)
            else:
                aug_data["index"] = np.arange(aug_data["coord"].shape[0])
                parts = [aug_data]
            for part in parts:
                fragment_list += (self.test_crop(part, rng) if self.test_crop is not None
                                  else [part])
        result["fragment_list"] = [
            self.post_transform(f, rng) for f in fragment_list
        ]
        return result

    def get(self, idx: int, rng: Optional[np.random.Generator] = None) -> Dict:
        rng = rng or np.random.default_rng()
        if self.test_mode:
            return self.prepare_test_data(idx, rng)
        return self.prepare_train_data(idx, rng)

    def __len__(self):
        return len(self.data_list) * self.loop


# ScanNet v2 semantic-20 valid class ids (reference
# `preprocessing/scannet/meta_data/scannet200_constants.py`).
VALID_CLASS_IDS_20 = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39,
)

SCANNET20_NAMES = [
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refridgerator", "shower curtain", "toilet", "sink", "bathtub",
    "otherfurniture",
]


@DATASETS.register_module()
class ScanNetDataset(DefaultDataset):
    """ScanNet 20-class (reference `scannet.py:26-185`)."""

    segment_key = "semantic_gt20"
    class2id = np.array(VALID_CLASS_IDS_20)

    def __init__(self, lr_file=None, la_file=None, **kwargs):
        self.lr_file = lr_file
        self.la_file = la_file
        super().__init__(**kwargs)
        self.la = None
        if la_file:
            self.la = torch.load(la_file, weights_only=False)

    def get_data_list(self):
        if self.lr_file:
            return [
                os.path.join(self.data_root, "train", name + ".pth")
                for name in np.loadtxt(self.lr_file, dtype=str)
            ]
        return super().get_data_list()

    def get_data(self, idx: int) -> Dict:
        data = self._load(self.data_list[idx % len(self.data_list)])
        coord = np.asarray(data["coord"], np.float32)
        out = dict(
            coord=coord,
            color=np.asarray(data["color"], np.float32),
            normal=np.asarray(data["normal"], np.float32),
        )
        if self.segment_key in data:
            seg = np.asarray(data[self.segment_key]).reshape(-1).astype(np.int64)
        elif "segment20" in data:
            seg = np.asarray(data["segment20"]).reshape(-1).astype(np.int64)
        else:
            seg = np.full((coord.shape[0],), -1, np.int64)
        out["segment"] = seg
        if "instance_gt" in data:
            out["instance"] = (
                np.asarray(data["instance_gt"]).reshape(-1).astype(np.int64)
            )
        elif "instance" in data:
            out["instance"] = (
                np.asarray(data["instance"]).reshape(-1).astype(np.int64)
            )
        if self.la is not None:
            sampled = self.la[self.get_data_name(idx)]
            mask = np.ones_like(seg, bool)
            mask[sampled] = False
            seg[mask] = self.ignore_index
            out["segment"] = seg
            out["sampled_index"] = sampled
        return out


# ScanNet200 benchmark valid class ids (reference
# `preprocessing/scannet/meta_data/scannet200_constants.py:91`).
VALID_CLASS_IDS_200 = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 21, 22,
    23, 24, 26, 27, 28, 29, 31, 32, 33, 34, 35, 36, 38, 39, 40, 41, 42, 44,
    45, 46, 47, 48, 49, 50, 51, 52, 54, 55, 56, 57, 58, 59, 62, 63, 64, 65,
    66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79, 80, 82, 84, 86,
    87, 88, 89, 90, 93, 95, 96, 97, 98, 99, 100, 101, 102, 103, 104, 105,
    106, 107, 110, 112, 115, 116, 118, 120, 121, 122, 125, 128, 130, 131,
    132, 134, 136, 138, 139, 140, 141, 145, 148, 154, 155, 156, 157, 159,
    161, 163, 165, 166, 168, 169, 170, 177, 180, 185, 188, 191, 193, 195,
    202, 208, 213, 214, 221, 229, 230, 232, 233, 242, 250, 261, 264, 276,
    283, 286, 300, 304, 312, 323, 325, 331, 342, 356, 370, 392, 395, 399,
    408, 417, 488, 540, 562, 570, 572, 581, 609, 748, 776, 1156, 1163, 1164,
    1165, 1166, 1167, 1168, 1169, 1170, 1171, 1172, 1173, 1174, 1175, 1176,
    1178, 1179, 1180, 1181, 1182, 1183, 1184, 1185, 1186, 1187, 1188, 1189,
    1190, 1191,
)


@DATASETS.register_module()
class ScanNet200Dataset(ScanNetDataset):
    segment_key = "semantic_gt200"
    class2id = np.array(VALID_CLASS_IDS_200)


@DATASETS.register_module()
class NuScenesDataset(DefaultDataset):
    """nuScenes lidarseg (reference `nuscenes.py:17-137`). The split's sweeps
    are listed in ``<data_root>/info/nuscenes_infos_{sweeps}sweeps_{split}.pkl``
    (a list of dicts with ``lidar_path``, ``lidar_token`` and, for labelled
    splits, ``gt_segment_path``, both paths under ``<data_root>/raw``). A
    sweep is ``(N, 5)`` float32 (x, y, z, intensity 0-255, ring); labels are
    uint8 raw lidarseg ids, mapped to the 16 learning classes."""

    def __init__(self, sweeps: int = 10, **kwargs):
        self.sweeps = sweeps
        self.learning_map = self.get_learning_map(kwargs.get("ignore_index", -1))
        super().__init__(**kwargs)

    def get_info_path(self, split: str) -> str:
        if split not in ("train", "val", "test"):
            raise ValueError(f"split {split!r}: 'train', 'val' or 'test'")
        return os.path.join(self.data_root, "info",
                            f"nuscenes_infos_{self.sweeps}sweeps_{split}.pkl")

    def get_data_list(self):
        splits = [self.split] if isinstance(self.split, str) else list(self.split)
        data_list = []
        for s in splits:
            with open(self.get_info_path(s), "rb") as f:
                data_list.extend(pickle.load(f))
        return data_list

    def get_data(self, idx: int) -> Dict:
        info = self.data_list[idx % len(self.data_list)]
        lidar_path = os.path.join(self.data_root, "raw", info["lidar_path"])
        points = np.fromfile(lidar_path, dtype=np.float32).reshape(-1, 5)
        coord = points[:, :3]
        strength = points[:, 3:4] / 255.0
        if "gt_segment_path" in info:
            seg_path = os.path.join(self.data_root, "raw", info["gt_segment_path"])
            raw = np.fromfile(seg_path, dtype=np.uint8).reshape(-1)
            lut = np.full((max(self.learning_map) + 1,), self.ignore_index, np.int64)
            for k, v in self.learning_map.items():
                lut[k] = v
            segment = lut[raw]
        else:
            segment = np.full((points.shape[0],), self.ignore_index, np.int64)
        return dict(coord=coord, strength=strength, segment=segment)

    def get_data_name(self, idx: int) -> str:
        return self.data_list[idx % len(self.data_list)]["lidar_token"]

    @staticmethod
    def get_learning_map(ignore_index: int) -> Dict[int, int]:
        """The 32 raw lidarseg classes to the 16 learning classes
        (reference `nuscenes.py:102-137`)."""
        ig = ignore_index
        return {
            0: ig, 1: ig, 2: 6, 3: 6, 4: 6, 5: ig, 6: 6, 7: ig, 8: ig, 9: 0,
            10: ig, 11: ig, 12: 7, 13: ig, 14: 1, 15: 2, 16: 2, 17: 3, 18: 4,
            19: ig, 20: ig, 21: 5, 22: 8, 23: 9, 24: 10, 25: 11, 26: 12,
            27: 13, 28: 14, 29: ig, 30: 15, 31: ig,
        }


@DATASETS.register_module()
class SemanticKITTIDataset(DefaultDataset):
    """SemanticKITTI scans (reference `pointcept/datasets/semantic_kitti.py`):
    ``<data_root>/dataset/sequences/<seq>/velodyne/*.bin`` float32 (x, y, z,
    remission) and the ``labels/*.label`` uint32 beside them, whose low 16
    bits (the semantic id) go through the 19-class learning map; a scan
    without labels gets the ignore index. ``learning_map_inv`` maps the
    learning classes back to raw ids for benchmark submissions."""

    SPLIT_SEQUENCES = {
        "train": ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"],
        "val": ["08"],
        "test": ["11", "12", "13", "14", "15", "16", "17", "18", "19", "20", "21"],
    }

    def __init__(self, **kwargs):
        ignore_index = kwargs.get("ignore_index", -1)
        self.learning_map = self.get_learning_map(ignore_index)
        self.learning_map_inv = self.get_learning_map_inv(ignore_index)
        super().__init__(**kwargs)

    def get_data_list(self):
        splits = [self.split] if isinstance(self.split, str) else list(self.split)
        seqs = []
        for s in splits:
            seqs += self.SPLIT_SEQUENCES.get(s, [s])
        out = []
        for seq in seqs:
            out += sorted(glob.glob(os.path.join(
                self.data_root, "dataset", "sequences", seq, "velodyne", "*.bin")))
        return out

    def get_data(self, idx: int) -> Dict:
        bin_path = self.data_list[idx % len(self.data_list)]
        scan = np.fromfile(bin_path, dtype=np.float32).reshape(-1, 4)
        coord = scan[:, :3]
        strength = scan[:, 3:4]
        label_path = bin_path.replace("velodyne", "labels").replace(".bin", ".label")
        if os.path.exists(label_path):
            raw = np.fromfile(label_path, dtype=np.uint32) & 0xFFFF
            lut = np.full((max(self.learning_map) + 1,), self.ignore_index, np.int64)
            for k, v in self.learning_map.items():
                lut[k] = v
            segment = lut[np.clip(raw, 0, len(lut) - 1)]
        else:
            segment = np.full((coord.shape[0],), self.ignore_index, np.int64)
        return dict(coord=coord, strength=strength, segment=segment)

    def get_data_name(self, idx: int) -> str:
        p = self.data_list[idx % len(self.data_list)]
        seq = os.path.basename(os.path.dirname(os.path.dirname(p)))
        return f"{seq}_{os.path.splitext(os.path.basename(p))[0]}"

    @staticmethod
    def get_learning_map(ignore_index: int) -> Dict[int, int]:
        """``semantic-kitti.yaml``'s learning map (19 classes)."""
        ig = ignore_index
        return {
            0: ig, 1: ig, 10: 0, 11: 1, 13: 4, 15: 2, 16: 4, 18: 3, 20: 4, 30: 5,
            31: 6, 32: 7, 40: 8, 44: 9, 48: 10, 49: 11, 50: 12, 51: 13, 52: ig,
            60: 8, 70: 14, 71: 15, 72: 16, 80: 17, 81: 18, 99: ig, 252: 0, 253: 6,
            254: 5, 255: 7, 256: 4, 257: 4, 258: 3, 259: 4,
        }

    @staticmethod
    def get_learning_map_inv(ignore_index: int) -> Dict[int, int]:
        """Learning class to raw SemanticKITTI id (reference
        `semantic_kitti.py:132-155`)."""
        return {
            ignore_index: ignore_index, 0: 10, 1: 11, 2: 15, 3: 18, 4: 20, 5: 30,
            6: 31, 7: 32, 8: 40, 9: 44, 10: 48, 11: 49, 12: 50, 13: 51, 14: 70,
            15: 71, 16: 72, 17: 80, 18: 81,
        }


@DATASETS.register_module()
class ShapeNetPartDataset(DefaultDataset):
    """ShapeNetPart (reference `pointcept/datasets/shapenet_part.py:23-160`):
    per-shape text files (``x y z nx ny nz part``) under their synset's
    directory, listed by ``train_test_split/shuffled_<split>_file_list.json``;
    the category from the synset through ``synsetoffset2category.txt``; 50
    part classes in 16 category-constrained spans (`category2part`)."""

    CATEGORY2PART = {
        "Airplane": [0, 1, 2, 3], "Bag": [4, 5], "Cap": [6, 7],
        "Car": [8, 9, 10, 11], "Chair": [12, 13, 14, 15],
        "Earphone": [16, 17, 18], "Guitar": [19, 20, 21], "Knife": [22, 23],
        "Lamp": [24, 25, 26, 27], "Laptop": [28, 29],
        "Motorbike": [30, 31, 32, 33, 34, 35], "Mug": [36, 37],
        "Pistol": [38, 39, 40], "Rocket": [41, 42, 43],
        "Skateboard": [44, 45, 46], "Table": [47, 48, 49],
    }

    def __init__(self, **kwargs):
        data_root = kwargs.get("data_root", "data/shapenet_part")
        self.categories: List[str] = []
        self.token2category: Dict[str, int] = {}
        cat_file = os.path.join(data_root, "synsetoffset2category.txt")
        if os.path.isfile(cat_file):
            with open(cat_file) as f:
                for line in f:
                    ls = line.strip().split()
                    if len(ls) == 2:
                        self.token2category[ls[1]] = len(self.categories)
                        self.categories.append(ls[0])
        self.category2part = {c: self.CATEGORY2PART.get(c, []) for c in self.categories}
        super().__init__(**kwargs)

    def get_data_list(self) -> List[str]:
        splits = [self.split] if isinstance(self.split, str) else list(self.split)
        out = []
        for s in splits:
            split_file = os.path.join(self.data_root, "train_test_split",
                                      f"shuffled_{s}_file_list.json")
            with open(split_file) as f:
                # entries look like "shape_data/<synset>/<name>"
                out += [os.path.join(self.data_root, *d.split("/")[1:]) + ".txt"
                        for d in json.load(f)]
        return out

    def get_data(self, idx: int) -> Dict:
        path = self.data_list[idx % len(self.data_list)]
        data = np.loadtxt(path).astype(np.float32)
        token = os.path.basename(os.path.dirname(path))
        return dict(coord=data[:, :3], normal=data[:, 3:6],
                    segment=data[:, 6].astype(np.int64),
                    category=np.int64(self.token2category.get(token, -1)))

    def get_data_name(self, idx: int) -> str:
        p = self.data_list[idx % len(self.data_list)]
        return (f"{os.path.basename(os.path.dirname(p))}_"
                f"{os.path.splitext(os.path.basename(p))[0]}")


@DATASETS.register_module()
class ModelNetDataset(DefaultDataset):
    """ModelNet40 classification (reference `pointcept/datasets/modelnet.py`):
    shapes listed by ``modelnet40_<split>.txt`` (``<class>_<id>`` names),
    read from ``<class>/<name>.npy`` or the comma-separated
    ``<class>/<name>.txt``; the label is the class directory's rank among
    the sorted directories of the root, in ``segment`` (every point) and
    ``category``; ``normal`` when the file has six columns."""

    def get_data_list(self) -> List[str]:
        splits = [self.split] if isinstance(self.split, str) else list(self.split)
        out = []
        for s in splits:
            list_file = os.path.join(self.data_root, f"modelnet40_{s}.txt")
            if os.path.exists(list_file):
                with open(list_file) as f:
                    names = [ln.strip() for ln in f]
                out += [os.path.join(self.data_root, "_".join(n.split("_")[:-1]), n)
                        for n in names]
        return out

    def get_data(self, idx: int) -> Dict:
        path = self.data_list[idx % len(self.data_list)]
        if os.path.exists(path + ".npy"):
            pts = np.load(path + ".npy")
        else:
            pts = np.loadtxt(path + ".txt", delimiter=",").astype(np.float32)
        cls_name = os.path.basename(os.path.dirname(path))
        names = sorted(d for d in os.listdir(self.data_root)
                       if os.path.isdir(os.path.join(self.data_root, d)))
        label = names.index(cls_name) if cls_name in names else -1
        data = dict(coord=pts[:, :3].astype(np.float32),
                    segment=np.full((pts.shape[0],), label, np.int64),
                    category=np.int64(label))
        if pts.shape[1] >= 6:
            data["normal"] = pts[:, 3:6].astype(np.float32)
        return data


@DATASETS.register_module()
class ConcatDataset:
    """The datasets of ``datasets`` (config dicts) one after the other,
    ``loop`` times over."""

    def __init__(self, datasets: Sequence[Dict], loop: int = 1):
        self.datasets = [DATASETS.build(dict(d)) for d in datasets]
        self.loop = loop
        self.lengths = [len(d) for d in self.datasets]

    def get(self, idx: int, rng: Optional[np.random.Generator] = None) -> Dict:
        idx = idx % sum(self.lengths)
        for d, n in zip(self.datasets, self.lengths):
            if idx < n:
                return d.get(idx, rng)
            idx -= n
        raise IndexError

    def __len__(self):
        return sum(self.lengths) * self.loop


@DATASETS.register_module()
class S3DISDataset(DefaultDataset):
    """S3DIS rooms (reference `pointcept/datasets/s3dis.py`): Pointcept
    per-room archives under ``<data_root>/<Area_k>/`` with coord, color,
    (normal), ``semantic_gt`` and (``instance_gt``); ``split`` names one
    area or a sequence of them. A room without labels gets the ignore
    index."""

    def get_data(self, idx: int) -> Dict:
        data = self._load(self.data_list[idx % len(self.data_list)])
        coord = np.asarray(data["coord"], np.float32)
        out = dict(coord=coord)
        for k in ("color", "normal"):
            if k in data:
                out[k] = np.asarray(data[k], np.float32)
        seg = data.get("semantic_gt", data.get("segment"))
        out["segment"] = (np.asarray(seg).reshape(-1).astype(np.int64) if seg is not None
                          else np.full((coord.shape[0],), self.ignore_index, np.int64))
        if "instance_gt" in data:
            out["instance"] = np.asarray(data["instance_gt"]).reshape(-1).astype(np.int64)
        return out


@DATASETS.register_module()
class WaymoDataset(DefaultDataset):
    """Waymo Open semantic segmentation (reference
    `pointcept/datasets/waymo.py:16-73`): per-frame
    ``<data_root>/<split>/<sequence>/velodyne/*.bin`` float32 (x, y, z,
    intensity), the intensity squashed by ``tanh``; the ``labels/*.label``
    beside them are (N, 2) int32 with the semantic class in column 1, less
    1, so that the raw 0 (unlabeled) becomes -1."""

    def get_data_list(self) -> List[str]:
        splits = [self.split] if isinstance(self.split, str) else list(self.split)
        out = []
        for s in splits:
            out += sorted(glob.glob(os.path.join(self.data_root, s, "*", "velodyne",
                                                 "*.bin")))
        return out

    def get_data(self, idx: int) -> Dict:
        path = self.data_list[idx % len(self.data_list)]
        scan = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
        coord = scan[:, :3]
        strength = np.tanh(scan[:, 3:4])
        label_path = path.replace("velodyne", "labels").replace(".bin", ".label")
        if os.path.exists(label_path):
            segment = (np.fromfile(label_path, dtype=np.int32).reshape(-1, 2)[:, 1]
                       - 1).astype(np.int64)
        else:
            segment = np.full((coord.shape[0],), self.ignore_index, np.int64)
        return dict(coord=coord, strength=strength, segment=segment)

    def get_data_name(self, idx: int) -> str:
        path = self.data_list[idx % len(self.data_list)]
        seq = os.path.basename(os.path.dirname(os.path.dirname(path)))
        return f"{seq}_{os.path.splitext(os.path.basename(path))[0]}"


@DATASETS.register_module()
class Structured3DDataset(DefaultDataset):
    """Structured3D panoramic rooms (reference
    `pointcept/datasets/structure3d.py`): ``<data_root>/<split>/<scene>/
    <room>.pth``, named ``<scene>_<room>``."""

    def get_data_list(self) -> List[str]:
        splits = [self.split] if isinstance(self.split, str) else list(self.split)
        out = []
        for s in splits:
            out += sorted(glob.glob(os.path.join(self.data_root, s, "*", "*.pth")))
        return out

    def get_data_name(self, idx: int) -> str:
        path = self.data_list[idx % len(self.data_list)]
        scene = os.path.basename(os.path.dirname(path))
        room = os.path.splitext(os.path.basename(path))[0]
        return f"{scene}_{room}"


@DATASETS.register_module()
class ArkitScenesDataset(DefaultDataset):
    """ARKitScenes meshes (reference `pointcept/datasets/arkitscenes.py`):
    unlabeled scans (``segment`` all 0) read through the ScanNet200 label
    space (``class2id``)."""

    class2id = np.array(VALID_CLASS_IDS_200)

    def get_data(self, idx: int) -> Dict:
        data = self._load(self.data_list[idx % len(self.data_list)])
        coord = np.asarray(data["coord"], np.float32)
        return dict(coord=coord, color=np.asarray(data["color"], np.float32),
                    normal=np.asarray(data["normal"], np.float32),
                    segment=np.zeros((coord.shape[0],), np.int64))


@DATASETS.register_module()
class ScanNetPairDataset:
    """Overlapping ScanNet view pairs for contrastive pretraining (reference
    `pointcept/datasets/scannet_pair.py:23-89`): the pairs of every
    ``<data_root>/<scene>/pcd/overlap.txt`` (``view1 view2 overlap`` lines)
    whose overlap exceeds ``overlap_threshold``; each view is read from
    ``data_root + name`` (a plain concatenation, as JAX's and the
    reference's: the names carry their leading separator), transformed by
    its own pipeline, view 1 first, and returned under ``view1_``/``view2_``
    prefixes."""

    def __init__(self, data_root: str = "data/scannet_pair", overlap_threshold: float = 0.3,
                 view1_transform=None, view2_transform=None, loop: int = 1, **kwargs):
        self.data_root = data_root
        self.overlap_threshold = overlap_threshold
        self.view1_transform = Compose(view1_transform)
        self.view2_transform = Compose(view2_transform)
        self.loop = loop
        self.data_list = self.get_data_list()

    def get_data_list(self) -> List:
        out = []
        for overlap_file in sorted(glob.glob(os.path.join(self.data_root, "*", "pcd",
                                                          "overlap.txt"))):
            with open(overlap_file) as f:
                pairs = [line.strip().split() for line in f if line.strip()]
            out += [p[:2] for p in pairs if float(p[2]) > self.overlap_threshold]
        return out

    def get_data(self, idx: int):
        pair = self.data_list[idx % len(self.data_list)]
        return (_load_scene(self.data_root + pair[0]),
                _load_scene(self.data_root + pair[1]))

    def get_data_name(self, idx: int) -> str:
        return os.path.basename(self.data_list[idx % len(self.data_list)][0]).split(".")[0]

    def get(self, idx: int, rng: Optional[np.random.Generator] = None) -> Dict:
        rng = rng or np.random.default_rng()
        v1, v2 = self.get_data(idx)
        v1 = self.view1_transform(v1, rng)
        v2 = self.view2_transform(v2, rng)
        out = {f"view1_{k}": v for k, v in v1.items()}
        out.update({f"view2_{k}": v for k, v in v2.items()})
        return out

    def __len__(self):
        return len(self.data_list) * self.loop


def build_dataset(cfg: Dict):
    return DATASETS.build(dict(cfg))
