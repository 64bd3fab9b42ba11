"""The datasets of Point Prompt Training and MSC pretraining in the port
against the JAX package: S3DIS, Structured3D, Waymo, ARKitScenes, ScanNet
view pairs and their concatenation, each on files written by the port's
synthetic writer, read through JAX's class and the port's: the raw arrays,
the names, the lengths and the shipped PPT training pipeline (MSC's two
view pipelines for the pairs), array for array."""

import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from cdsegnet_tpu.data import datasets as jdatasets  # noqa: E402
from cdsegnet_tpu.engine.config import Config as JConfig  # noqa: E402
from cdsegnet_torch.data import datasets as tdatasets  # noqa: E402
from cdsegnet_torch.utils.synthetic import (lidar_sweep, room_scene,  # noqa: E402
                                            write_arkitscenes, write_s3dis,
                                            write_scannet_pair, write_structured3d,
                                            write_waymo)
from test_torch_data import assert_same, jax_numpy_host_ops, plain  # noqa: E402,F401

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PPT = os.path.join(REPO, "configs", "multidataset", "ppt_spunet.py")
MSC = os.path.join(REPO, "configs", "scannet", "pretrain_msc.py")


def ppt_transform():
    """The shipped PPT pipeline, its SphereCrop shrunk to 300 points."""
    out = plain(JConfig.fromfile(PPT).data.train.datasets[0].transform)
    for t in out:
        if t["type"] == "SphereCrop":
            t["point_max"] = 300
    return out


def view_transform():
    out = plain(JConfig.fromfile(MSC).data.train.transform)[-1]["view_trans_cfg"]
    for t in out:
        if t["type"] == "SphereCrop":
            t["point_max"] = 300
    return out


def rooms(*seeds):
    return [room_scene(s, cell=0.4) for s in seeds]


def _s3dis(root):
    write_s3dis(root, {"Area_1": rooms(1, 2), "Area_5": rooms(3)})
    return dict(type="S3DISDataset", split=("Area_1", "Area_5"), data_root=root), 3


def _structured3d(root):
    write_structured3d(root, {"train": rooms(4, 5)})
    return dict(type="Structured3DDataset", split="train", data_root=root), 2


def _arkitscenes(root):
    write_arkitscenes(root, {"Training": rooms(6, 7)})
    return dict(type="ArkitScenesDataset", split="Training", data_root=root), 2


def _waymo(root):
    write_waymo(root, {"training": [lidar_sweep(1), lidar_sweep(2)]})
    transform = [dict(type="GridSample", grid_size=0.1, hash_type="fnv", mode="train",
                      keys=("coord", "strength", "segment"), return_grid_coord=True),
                 dict(type="SphereCrop", point_max=2000, mode="random"),
                 dict(type="Collect", keys=("coord", "grid_coord", "segment"),
                      feat_keys=("coord", "strength"))]
    return dict(type="WaymoDataset", split="training", data_root=root, transform=transform), 2


def _concat(root):
    write_s3dis(os.path.join(root, "s3dis"), {"Area_2": rooms(8)})
    write_structured3d(os.path.join(root, "s3d"), {"train": rooms(9, 10)})
    return dict(type="ConcatDataset", loop=2, datasets=[
        dict(type="Structured3DDataset", split="train", data_root=os.path.join(root, "s3d"),
             transform=ppt_transform()),
        dict(type="S3DISDataset", split="Area_2", data_root=os.path.join(root, "s3dis"),
             transform=ppt_transform())]), 6


def _scannet_pair(root):
    scans = [rooms(11, 12, 13), rooms(14, 15)]
    write_scannet_pair(root, scans, [[0.5, 0.2], [0.4]])
    return dict(type="ScanNetPairDataset", data_root=root, overlap_threshold=0.3,
                view1_transform=view_transform(), view2_transform=view_transform()), 2


WRITERS = dict(s3dis=_s3dis, structured3d=_structured3d, arkitscenes=_arkitscenes,
               waymo=_waymo, concat=_concat, scannet_pair=_scannet_pair)


@pytest.mark.parametrize("name", list(WRITERS))
def test_dataset_reads_the_writers_files_as_jax(name, tmp_path, jax_numpy_host_ops):
    cfg, n = WRITERS[name](str(tmp_path / name))
    if name in ("s3dis", "structured3d", "arkitscenes"):
        cfg["transform"] = ppt_transform()
    jds, tds = jdatasets.build_dataset(dict(cfg)), tdatasets.build_dataset(dict(cfg))
    assert len(tds) == len(jds) == n
    for i in range(n):
        if name != "concat":
            assert tds.get_data_name(i) == jds.get_data_name(i)
            raw = tds.get_data(i)
            assert_same(raw, jds.get_data(i))
        got = tds.get(i, np.random.default_rng(i))
        assert_same(got, jds.get(i, np.random.default_rng(i)))
    if name in ("s3dis", "structured3d"):
        assert raw["segment"].max() >= 1 and raw["segment"].min() >= -1
    if name == "waymo":
        assert raw["segment"].min() == -1 and 0 < raw["strength"].max() < 1
    if name == "arkitscenes":
        assert not raw["segment"].any()
    if name == "scannet_pair":
        # the pairs above the threshold, read by plain concatenation
        assert [p[0] for p in tds.data_list] == ["/scene0000_00/pcd/000000.pth",
                                                 "/scene0001_00/pcd/000000.pth"]
        assert {k.split("_", 1)[0] for k in got} == {"view1", "view2"}
