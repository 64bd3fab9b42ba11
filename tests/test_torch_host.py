"""Port host surface against the JAX package: the transforms the first
slices left out, `SphereCrop`'s covering crops, the shared decode cache
(with JAX's failing first write, a departure), the voxel fence, the PLY
tools and the visualizer's 1-NN lift, and the offline preprocessing
scripts. All of it is host numpy (the lift runs the port's `knn` on the
CPU here): the same numpy seeds go into both packages and the outputs must
be equal array for array and byte for byte."""

import copy
import glob
import json
import os
import pickle
import runpy
import sys
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cdsegnet_tpu.data import cache as jcache  # noqa: E402
from cdsegnet_tpu.data import collate as jcollate  # noqa: E402
from cdsegnet_tpu.data import datasets as jdatasets  # noqa: E402
from cdsegnet_tpu.data import transforms as jtransforms  # noqa: E402
from cdsegnet_tpu.engine import config as jconfig  # noqa: E402
from cdsegnet_tpu.models import structure as jstructure  # noqa: E402
from cdsegnet_tpu.utils import visualization as jvis  # noqa: E402
from cdsegnet_torch.data import cache as tcache  # noqa: E402
from cdsegnet_torch.data import collate as tcollate  # noqa: E402
from cdsegnet_torch.data import datasets as tdatasets  # noqa: E402
from cdsegnet_torch.data import transforms as ttransforms  # noqa: E402
from cdsegnet_torch.models import structure as tstructure  # noqa: E402
from cdsegnet_torch.tools import fidelity_ablations as tfidelity  # noqa: E402
from cdsegnet_torch.tools import preprocess_arkitscenes as tark  # noqa: E402
from cdsegnet_torch.tools import preprocess_nuscenes as tnus  # noqa: E402
from cdsegnet_torch.tools import preprocess_s3dis as ts3dis  # noqa: E402
from cdsegnet_torch.tools import preprocess_scannet as tscannet  # noqa: E402
from cdsegnet_torch.tools import preprocess_structured3d as ts3d  # noqa: E402
from cdsegnet_torch.tools import preprocess_waymo as twaymo  # noqa: E402
from cdsegnet_torch.tools import visualize as tvisualize  # noqa: E402
from cdsegnet_torch.utils import visualization as tvis  # noqa: E402
from test_preprocessing2 import TOOLS, _png_bytes, _write_ply_mesh  # noqa: E402
from test_torch_data import (SHIPPED, assert_same, jax_numpy_host_ops, plain,  # noqa: E402,F401
                             scene, write_scenes)

import fidelity_ablations as jfidelity  # noqa: E402  (tools/, on the path above)
import preprocess_arkitscenes as jark  # noqa: E402
import preprocess_nuscenes as jnus  # noqa: E402
import preprocess_s3dis as js3dis  # noqa: E402
import preprocess_scannet as jscannet  # noqa: E402
import preprocess_structured3d as js3d  # noqa: E402
import preprocess_waymo as jwaymo  # noqa: E402

torch.set_num_threads(2)

# the 13 transforms ported in this slice, each with settings that take
# every branch
NEW_TRANSFORMS = {
    "add": [dict(type="Add", keys_dict=dict(condition="ScanNet", flag=3))],
    "clip_gaussian_jitter": [dict(type="ClipGaussianJitter", mean=0.1, std=0.02)],
    "crop_boundary": [dict(type="CropBoundary")],
    "hue_saturation": [dict(type="HueSaturationTranslation", hue_max=0.4,
                            saturation_max=0.3)],
    "normalize_coord": [dict(type="NormalizeCoord")],
    "point_clip": [dict(type="PointClip", point_cloud_range=(0.5, 0.5, 0.2, 2, 2.5, 1))],
    "positive_shift": [dict(type="CenterShift"), dict(type="PositiveShift")],
    "color_drop": [dict(type="RandomColorDrop", p=0.5, color_augment=0.3)],
    "color_gray": [dict(type="RandomColorGrayScale", p=0.6)],
    "color_jitter": [dict(type="RandomColorJitter", brightness=0.4, contrast=0.4,
                          saturation=0.4, hue=0.2, p=0.8)],
    "random_shift": [dict(type="RandomShift", shift=((-0.2, 0.2), (-0.1, 0.3), (0, 0.1)))],
    "shuffle": [dict(type="ShufflePoint")],
    "to_tensor": [dict(type="ToTensor")],
}


def test_every_jax_transform_is_registered():
    assert sorted(ttransforms.TRANSFORMS._registry) == sorted(jtransforms.TRANSFORMS._registry)


@pytest.mark.parametrize("case", sorted(NEW_TRANSFORMS))
def test_new_transform_matches_jax(case):
    """Draw for draw: five scenes through one generator, then the next
    draw of each generator."""
    cfgs = NEW_TRANSFORMS[case]
    jt, tt = jtransforms.Compose(cfgs), ttransforms.Compose(cfgs)
    jrng, trng = np.random.default_rng(8), np.random.default_rng(8)
    for seed in range(5):
        want = jt(copy.deepcopy(scene(seed=seed)), jrng)
        got = tt(copy.deepcopy(scene(seed=seed)), trng)
        assert_same(got, want)
    assert trng.random() == jrng.random()


def crop_room(n=500, repeats=150, seed=3):
    """A scene in which ``repeats`` points repeat earlier ones exactly
    (equal distances from every centre)."""
    s = scene(n, seed=seed)
    dup = np.random.RandomState(seed).choice(n, repeats, replace=False)
    return {k: np.concatenate([v, v[dup]]) for k, v in s.items()}


@pytest.mark.parametrize("point_max,with_index", [(120, False), (311, True), (650, False)])
def test_sphere_crop_all_matches_jax(point_max, with_index):
    """Covering crops fragment for fragment, ``weight`` for ``weight``; every
    point lies in a crop; a scene within ``point_max`` is one crop of
    zero weights."""
    data = crop_room()
    if with_index:
        data["index"] = np.arange(len(data["coord"]))[::-1].copy()
    cfg = dict(type="SphereCrop", point_max=point_max, mode="all")
    jrng, trng = np.random.default_rng(4), np.random.default_rng(4)
    want = jtransforms.TRANSFORMS.build(dict(cfg))(copy.deepcopy(data), jrng)
    got = ttransforms.TRANSFORMS.build(dict(cfg))(copy.deepcopy(data), trng)
    assert_same(got, want)
    assert trng.random() == jrng.random()
    covered = np.zeros(len(data["coord"]), bool)
    for part in got:
        covered[part["index"]] = True
        assert len(part["coord"]) == min(point_max, len(data["coord"]))
        assert part["weight"].shape == (len(part["coord"]),)
    assert covered.all()
    assert (len(got) == 1) == (point_max >= len(data["coord"]))


def test_test_crop_splits_every_fragment_as_jax(tmp_path, jax_numpy_host_ops):
    """The test ``crop`` after the test voxelize, on every part, before the
    post transform: the shipped test pipeline with covering crops."""
    write_scenes(str(tmp_path), n_points=400)
    cfg = plain(jconfig.Config.fromfile(SHIPPED).data["test"])
    cfg.update(data_root=str(tmp_path), split="val")
    cfg["test_cfg"]["crop"] = dict(type="SphereCrop", point_max=90, mode="all")
    cfg["test_cfg"]["aug_transform"] = cfg["test_cfg"]["aug_transform"][:2]
    jds, tds = jdatasets.build_dataset(cfg), tdatasets.build_dataset(cfg)
    plain_cfg = copy.deepcopy(cfg)
    plain_cfg["test_cfg"]["crop"] = None
    uncropped = tdatasets.build_dataset(plain_cfg).get(0, np.random.default_rng(9))
    jrng, trng = np.random.default_rng(9), np.random.default_rng(9)
    for idx in range(2):
        want, got = jds.get(idx, jrng), tds.get(idx, trng)
        assert_same(got, want)
    first = tds.get(0, np.random.default_rng(9))
    assert len(first["fragment_list"]) > len(uncropped["fragment_list"])
    assert all("weight" not in f for f in first["fragment_list"])  # Collect drops it


def test_port_cache_files_are_read_by_jax(tmp_path):
    """Key, directory and format are JAX's: a file the port writes is read
    by JAX's `shared_dict`, and one JAX reads back (written by hand, since
    its own first write fails) is read by the port's."""
    arrays = dict(coord=np.arange(12, dtype=np.float32).reshape(4, 3),
                  segment=np.arange(4), scene_id="scene0001_00", scale=2.5)
    got = tcache.shared_dict("/data/scene0001_00.pth", lambda: arrays, str(tmp_path))
    path = tcache.cache_path("/data/scene0001_00.pth", str(tmp_path))
    assert os.listdir(tmp_path) == [os.path.basename(path)]

    def unused():
        raise AssertionError("the cached file is read, not decoded again")

    want = jcache.shared_dict("/data/scene0001_00.pth", unused, str(tmp_path))
    assert_same(got, want)
    assert_same(got, {k: np.asarray(v) for k, v in arrays.items()})
    np.savez(str(tmp_path / "by_hand"), **arrays)
    os.replace(tmp_path / "by_hand.npz", tcache.cache_path("other", str(tmp_path)))
    assert_same(tcache.shared_dict("other", unused, str(tmp_path)),
                jcache.shared_dict("other", unused, str(tmp_path)))
    tcache.clear_cache(str(tmp_path))
    assert os.listdir(tmp_path) == []


def test_jax_cache_first_write_fails_where_the_port_writes(tmp_path):
    """The departure: JAX's ``np.savez(path + ".tmp<pid>")`` writes
    ``<key>.npz.tmp<pid>.npz``, so its rename raises `FileNotFoundError`
    and leaves that file; the port's write lands at ``<key>.npz``."""
    arrays = dict(coord=np.ones((3, 3), np.float32))
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    with pytest.raises(FileNotFoundError):
        jcache.shared_dict("scene", lambda: arrays, str(jdir))
    key = os.path.basename(tcache.cache_path("scene", str(jdir)))
    assert os.listdir(jdir) == [f"{key}.tmp{os.getpid()}.npz"]
    tcache.shared_dict("scene", lambda: arrays, str(tdir))
    assert os.listdir(tdir) == [key]


def test_cache_directory_follows_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("CDSEG_CACHE_DIR", str(tmp_path / "c"))
    assert tcache.default_cache_dir() == str(tmp_path / "c")
    monkeypatch.delenv("CDSEG_CACHE_DIR")
    assert tcache.default_cache_dir() == (
        "/dev/shm/cdsegnet_cache" if os.path.isdir("/dev/shm") else "/tmp/cdsegnet_cache")


@pytest.mark.parametrize("split", ["train", "val"])
def test_cached_dataset_matches_uncached(tmp_path, monkeypatch, split, jax_numpy_host_ops):
    """The shipped train and val pipelines with ``cache=True``: equal to the
    port's and JAX's uncached runs with the same seed, one file per scene
    and no stray file, over two passes (decode, then read)."""
    root, cache_dir = tmp_path / "data", tmp_path / "cache"
    write_scenes(str(root), n_points=300)
    monkeypatch.setenv("CDSEG_CACHE_DIR", str(cache_dir))
    cfg = plain(jconfig.Config.fromfile(SHIPPED).data[split])
    cfg.update(data_root=str(root), split="val")
    cached = tdatasets.build_dataset(dict(cfg, cache=True))
    uncached = tdatasets.build_dataset(dict(cfg, cache=False))
    jds = jdatasets.build_dataset(dict(cfg, cache=False))
    for rep in range(2):
        rngs = [np.random.default_rng(100 + rep) for _ in range(3)]
        for idx in range(2):
            got = cached.get(idx, rngs[0])
            assert_same(got, uncached.get(idx, rngs[1]))
            assert_same(got, jds.get(idx, rngs[2]))
        want = sorted(os.path.basename(tcache.cache_path(p, str(cache_dir)))
                      for p in cached.data_list)
        assert sorted(os.listdir(cache_dir)) == want
    tcache.clear_cache()
    assert os.listdir(cache_dir) == []


def duplicate_scenes():
    rng = np.random.RandomState(2)
    scenes = []
    for n in (60, 40):
        gc = rng.randint(0, 30, (n, 3))
        scenes.append(dict(coord=gc.astype(np.float32) * 0.02, grid_coord=gc,
                           feat=rng.rand(n, 6).astype(np.float32),
                           segment=rng.randint(0, 5, n)))
    scenes[1]["grid_coord"][7] = scenes[1]["grid_coord"][3]
    scenes[1]["grid_coord"][9] = scenes[1]["grid_coord"][3]
    return scenes


def test_voxel_fence_raises_as_jax(monkeypatch):
    """Under ``CDSEG_VALIDATE`` a duplicated voxel raises JAX's `ValueError`
    with JAX's message; without it nothing is checked. The same voxel in
    two scenes is no duplicate."""
    scenes = duplicate_scenes()
    monkeypatch.delenv("CDSEG_VALIDATE", raising=False)
    assert_same(tcollate.collate_scenes(scenes, 128), jcollate.collate_scenes(scenes, 128))
    monkeypatch.setenv("CDSEG_VALIDATE", "1")
    with pytest.raises(ValueError) as want:
        jcollate.collate_scenes(scenes, 128)
    with pytest.raises(ValueError) as got:
        tcollate.collate_scenes(scenes, 128)
    assert str(got.value) == str(want.value)
    assert "scene 1 voxel" in str(got.value) and "x3" in str(got.value)
    scenes[1]["grid_coord"] = scenes[0]["grid_coord"][:40]
    tcollate.collate_scenes(scenes, 128)
    # tensors too, and the message without ``where``
    gc = torch.tensor([[1, 2, 3], [1, 2, 3], [0, 0, 0]])
    bt, mk = torch.tensor([0, 0, 0]), torch.tensor([True, True, True])
    with pytest.raises(ValueError) as got:
        tstructure.assert_unique_voxels(gc, bt, mk)
    with pytest.raises(ValueError) as want:
        jstructure.assert_unique_voxels(gc.numpy(), bt.numpy(), mk.numpy())
    assert str(got.value) == str(want.value)
    tstructure.assert_unique_voxels(gc, bt, torch.tensor([True, False, True]))


def test_ply_files_equal_jax_byte_for_byte(tmp_path):
    rng = np.random.RandomState(1)
    coord = rng.randn(200, 3).astype(np.float64)
    labels = rng.randint(-1, 25, 200)
    cases = [("pc", lambda m, p: m.save_point_cloud(coord, None, p)),
             ("float_color", lambda m, p: m.save_point_cloud(coord, rng_color, p)),
             ("seg", lambda m, p: m.save_segmentation(coord, labels, p, 20)),
             ("seg_auto", lambda m, p: m.save_segmentation(coord, labels, p)),
             ("seg_ignore", lambda m, p: m.save_segmentation(coord, labels, p, 30, 3))]
    rng_color = rng.rand(200, 3) * 300 - 20
    for name, write in cases:
        jp, tp = str(tmp_path / "jax" / f"{name}.ply"), str(tmp_path / "port" / f"{name}.ply")
        write(jvis, jp)
        write(tvis, tp)
        assert open(tp, "rb").read() == open(jp, "rb").read(), name
        for a, b in zip(tvis.read_ply(tp), jvis.read_ply(jp)):
            assert_same(a, b)
    for k in (1, 5, 8, 9, 40):
        assert_same(tvis._palette(k), jvis._palette(k))


def test_remap_to_origin_matches_jax():
    """The 1-NN lift on the port's `knn` (CPU here) against JAX's C search:
    sampled points repeated, so that equal distances take the lowest
    index."""
    rng = np.random.RandomState(4)
    origin = (rng.rand(3000, 3) * 4).astype(np.float32)
    sampled = origin[rng.choice(3000, 700, replace=False)]
    sampled = np.concatenate([sampled, sampled[:100]])
    labels = rng.randint(0, 20, len(sampled))
    labels[700:] = (labels[:100] + 1) % 20  # a repeat with another label
    got = tvis.remap_to_origin(origin, sampled, labels, device="cpu")
    want = jvis.remap_to_origin(origin, sampled, labels)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def run_jax_tool(path, argv, monkeypatch):
    """Run a JAX tool script as ``__main__`` with ``argv``."""
    monkeypatch.setattr(sys, "argv", [path] + list(argv))
    runpy.run_path(path, run_name="__main__")


def tree_files(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "**", "*"),
                                                              recursive=True)
                  if os.path.isfile(p))


def assert_same_archives(got_root, want_root):
    """The same files; `.pth` archives equal array for array, others byte
    for byte."""
    names = tree_files(want_root)
    assert names and tree_files(got_root) == names
    for name in names:
        got, want = os.path.join(got_root, name), os.path.join(want_root, name)
        if name.endswith(".pth"):
            assert_same(plain(torch.load(got, weights_only=False)),
                        plain(torch.load(want, weights_only=False)))
        else:
            assert open(got, "rb").read() == open(want, "rb").read(), name


def test_visualize_cli_matches_jax(tmp_path, monkeypatch):
    """Both CLIs on a scene and a prediction made on a sampled subset."""
    write_scenes(str(tmp_path / "data"), n_scenes=1, n_points=400)
    scene_path = str(tmp_path / "data" / "val" / "scene0000_00.pth")
    data = torch.load(scene_path, weights_only=False)
    pick = np.random.RandomState(0).choice(400, 150, replace=False)
    np.save(tmp_path / "pred.npy", np.arange(150) % 20)
    np.save(tmp_path / "sampled.npy", data["coord"][pick])
    args = ["--scene", scene_path, "--pred", str(tmp_path / "pred.npy"),
            "--sampled-coord", str(tmp_path / "sampled.npy"), "--num-classes", "20"]
    run_jax_tool(os.path.join(TOOLS, "visualize.py"),
                 args + ["--out", str(tmp_path / "jax")], monkeypatch)
    tvisualize.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    assert len(tree_files(str(tmp_path / "jax"))) == 3
    assert_same_archives(str(tmp_path / "port"), str(tmp_path / "jax"))
    with pytest.raises(SystemExit, match="--sampled-coord"):
        tvisualize.main(args[:4] + ["--out", str(tmp_path / "x"), "--device", "cpu"])


def test_preprocess_s3dis_matches_jax(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    for area, room in (("Area_1", "office_1"), ("Area_1", "hallway_2"), ("Area_5", "WC_1")):
        ann = tmp_path / "raw" / area / room / "Annotations"
        ann.mkdir(parents=True)
        for i, cls in enumerate(("chair", "wall", "stairs", "chair")):
            pts = np.column_stack([rng.rand(20, 3) * 3, rng.randint(0, 255, (20, 3))])
            np.savetxt(ann / f"{cls}_{i + 1}.txt", pts, fmt="%.6f")
    (tmp_path / "raw" / "Area_5" / "empty_1").mkdir()
    args = ["--dataset_root", str(tmp_path / "raw")]
    run_jax_tool(os.path.join(TOOLS, "preprocess_s3dis.py"),
                 args + ["--output_root", str(tmp_path / "jax")], monkeypatch)
    ts3dis.main(args + ["--output_root", str(tmp_path / "port")])
    assert_same_archives(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert js3dis.CLASSES == ts3dis.CLASSES
    with pytest.raises(SystemExit):
        ts3dis.main(["--dataset_root", str(tmp_path / "none"), "--output_root",
                     str(tmp_path / "o")])


def test_preprocess_arkitscenes_matches_jax(tmp_path):
    rng = np.random.RandomState(1)
    for split, name, fmt in (("Training", "41069025", "binary_little_endian"),
                             ("Validation", "42445173", "ascii")):
        d = tmp_path / "raw" / "3dod" / split / name
        d.mkdir(parents=True)
        coord = rng.rand(30, 3).astype(np.float32)
        faces = np.stack([rng.choice(30, 3, replace=False) for _ in range(40)])
        _write_ply_mesh(str(d / f"{name}_3dod_mesh.ply"), coord,
                        rng.randint(0, 255, (30, 3)).astype(np.uint8), faces, fmt)
    args = ["--dataset_root", str(tmp_path / "raw"), "--num_workers", "1"]
    jark.main(args + ["--output_root", str(tmp_path / "jax")])
    tark.main(args + ["--output_root", str(tmp_path / "port")])
    assert_same_archives(str(tmp_path / "port"), str(tmp_path / "jax"))
    for fail in (jark.main, tark.main):
        with pytest.raises(SystemExit, match="no"):
            fail(["--dataset_root", str(tmp_path / "none"), "--output_root", "unused"])


def test_preprocess_structured3d_matches_jax(tmp_path):
    rng = np.random.RandomState(2)
    h, w = 6, 12
    with zipfile.ZipFile(tmp_path / "Structured3D_0.zip", "w") as z:
        for scene_name in ("scene_00000", "scene_03100"):
            for room in ("0", "7"):
                base = f"Structured3D/{scene_name}/2D_rendering/{room}"
                depth = rng.randint(500, 3000, (h, w)).astype(np.uint16)
                depth[0, :3] = 0  # no return
                rgb = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
                sem = rng.choice([0, 1, 5, 7, 40], (h, w)).astype(np.uint8)
                z.writestr(f"{base}/panorama/camera_xyz.txt", "10 -20 1500")
                for part, arr in (("depth", depth), ("rgb_rawlight", rgb), ("semantic", sem)):
                    z.writestr(f"{base}/panorama/full/{part}.png", _png_bytes(arr))
                frame = f"{base}/perspective/full/0"
                z.writestr(f"{frame}/camera_pose.txt", "0 0 1600 1 0 0 0 0 1 0.5 0.5")
                for part, arr in (("depth", depth), ("rgb_rawlight", rgb), ("semantic", sem)):
                    z.writestr(f"{frame}/{part}.png", _png_bytes(arr))
    args = ["--dataset_root", str(tmp_path), "--num_workers", "1"]
    js3d.main(args + ["--output_root", str(tmp_path / "jax")])
    ts3d.main(args + ["--output_root", str(tmp_path / "port")])
    assert_same_archives(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert len(tree_files(str(tmp_path / "port"))) == 4


class FakePlyData:
    """What ScanNet's script reads of `plyfile.PlyData`, which is not
    installed here: vertices and faces of a mesh file written as ``.npz``."""

    @staticmethod
    def read(path):
        z = np.load(path + ".npz")
        return dict(vertex={k: z[k] for k in ("x", "y", "z", "red", "green", "blue")},
                    face=dict(vertex_indices=list(z["faces"])))


def test_preprocess_scannet_matches_jax(tmp_path, monkeypatch):
    """Without ``plyfile`` both scripts stop with the same message; with a
    stand-in reader both write the same archives."""
    out = {}
    for name, fn in (("jax", lambda: run_jax_tool(os.path.join(TOOLS, "preprocess_scannet.py"),
                                                  ["--dataset_root", "x", "--output_root", "y"],
                                                  monkeypatch)),
                     ("port", lambda: tscannet.main(["--dataset_root", "x", "--output_root",
                                                     "y"]))):
        with pytest.raises(SystemExit) as e:
            fn()
        out[name] = e.value.code
    assert out == dict(jax=1, port=1)
    rng = np.random.RandomState(3)
    (tmp_path / "raw").mkdir()
    (tmp_path / "raw" / "scannetv2-labels.combined.tsv").write_text(
        "id\traw_category\tnyu40id\n1\twall\t1\n2\tchair\t5\n40\tbox\t39\n7\tbad\tnan\n")
    for scene_name in ("scene0000_00", "scene0001_00"):
        d = tmp_path / "raw" / "scans" / scene_name
        d.mkdir(parents=True)
        coord = rng.rand(50, 3).astype(np.float32)
        np.savez(d / f"{scene_name}_vh_clean_2.ply.npz", x=coord[:, 0], y=coord[:, 1],
                 z=coord[:, 2], red=rng.randint(0, 255, 50), green=rng.randint(0, 255, 50),
                 blue=rng.randint(0, 255, 50),
                 faces=np.stack([rng.choice(50, 3, replace=False) for _ in range(60)]))
        segs = rng.randint(0, 6, 50)
        (d / f"{scene_name}_vh_clean_2.0.010000.segs.json").write_text(
            json.dumps(dict(segIndices=segs.tolist())))
        (d / f"{scene_name}.aggregation.json").write_text(json.dumps(dict(segGroups=[
            dict(id=0, label="wall", segments=[0, 1]), dict(id=1, label="chair", segments=[2]),
            dict(id=2, label="box", segments=[3]), dict(id=3, label="unknown", segments=[4])])))
    label_map = jscannet.load_label_map(str(tmp_path / "raw" / "scannetv2-labels.combined.tsv"))
    assert tscannet.load_label_map(
        str(tmp_path / "raw" / "scannetv2-labels.combined.tsv")) == label_map
    monkeypatch.setattr(jscannet, "PlyData", FakePlyData)
    monkeypatch.setattr(tscannet, "PlyData", FakePlyData)
    for name, mod in (("jax", jscannet), ("port", tscannet)):
        for split in ("train", "test"):
            os.makedirs(tmp_path / name / split)
            for scene_name in ("scene0000_00", "scene0001_00"):
                mod.process_scene(str(tmp_path / "raw" / "scans" / scene_name),
                                  str(tmp_path / name / split), label_map,
                                  with_labels=split != "test")
    assert_same_archives(str(tmp_path / "port"), str(tmp_path / "jax"))


def nuscenes_tables(root):
    meta = root / "raw" / "v1.0-trainval"
    meta.mkdir(parents=True)
    scenes = [dict(token=f"s{i}", name=f"scene-000{i}") for i in range(3)]
    samples = [dict(token=f"t{i}", scene_token=f"s{i % 3}") for i in range(7)]
    sample_data = [dict(token=f"d{i}", sample_token=f"t{i}", is_key_frame=i != 5,
                        filename=f"samples/LIDAR_TOP/{i}.bin" if i != 6 else f"samples/CAM/{i}.jpg",
                        timestamp=1000 + i) for i in range(7)]
    lidarseg = [dict(sample_data_token=f"d{i}", filename=f"lidarseg/{i}.bin") for i in (0, 2, 3)]
    for name, table in (("scene", scenes), ("sample", samples), ("sample_data", sample_data),
                        ("lidarseg", lidarseg)):
        (meta / f"{name}.json").write_text(json.dumps(table))
    (root / "train.txt").write_text("scene-0000\nscene-0002\n")
    (root / "val.txt").write_text("scene-0001\n")


def test_preprocess_nuscenes_matches_jax(tmp_path, monkeypatch, capsys):
    """With scene lists, and without (no devkit here: every sample goes to
    train, with the same message)."""
    nuscenes_tables(tmp_path)
    lists = ["--train_scenes", str(tmp_path / "train.txt"), "--val_scenes",
             str(tmp_path / "val.txt")]
    for tag, extra in (("lists", lists), ("none", [])):
        args = ["--dataset_root", str(tmp_path)] + extra
        run_jax_tool(os.path.join(TOOLS, "preprocess_nuscenes.py"),
                     args + ["--output_root", str(tmp_path / f"jax_{tag}")], monkeypatch)
        want_err = capsys.readouterr().err
        tnus.main(args + ["--output_root", str(tmp_path / f"port_{tag}")])
        assert capsys.readouterr().err == want_err
        for split in ("train", "val"):
            name = f"info/nuscenes_infos_10sweeps_{split}.pkl"
            with open(tmp_path / f"port_{tag}" / name, "rb") as f:
                got = pickle.load(f)
            with open(tmp_path / f"jax_{tag}" / name, "rb") as f:
                assert got == pickle.load(f)
        assert (tag == "none") == bool(want_err)
    assert jnus.official_splits() == tnus.official_splits() == (None, None)


def test_preprocess_waymo_matches_jax(tmp_path):
    """The devkit-free parts equal JAX's; the frame conversion stops with
    JAX's message where the devkit is absent."""
    rng = np.random.default_rng(5)
    path = tmp_path / "seq.tfrecord"
    with open(path, "wb") as f:
        for p in (b"ab", b"", b"y" * 300):
            f.write(len(p).to_bytes(8, "little") + b"\0" * 4 + p + b"\0" * 4)
    assert list(twaymo.iter_tfrecord(str(path))) == list(jwaymo.iter_tfrecord(str(path)))
    ri = rng.random((4, 8)) * 50 + 1
    incl = np.linspace(0.3, -0.3, 4)
    ext = np.eye(4)
    ext[:3, 3] = (1.0, -2.0, 0.5)
    ext[:2, :2] = [[0, -1], [1, 0]]
    pose = rng.random((4, 8, 6)) * 0.1
    frame_pose = np.eye(4)
    frame_pose[:3, 3] = (3.0, 1.0, 0.0)
    for args in ((ri, incl, ext), (ri, incl, ext, pose, frame_pose)):
        np.testing.assert_array_equal(twaymo.range_image_to_cartesian(*args),
                                      jwaymo.range_image_to_cartesian(*args))

    def lasers():
        r = np.random.default_rng(6)
        out = []
        for h, w, labeled in ((4, 8, True), (2, 6, False)):
            ri1, ri2 = r.random((h, w, 2)) * 40, r.random((h, w, 2)) * 40
            ri1[0, 0, 0] = 0.0
            entry = dict(ri=[ri1, ri2], inclinations=np.linspace(0.2, -0.2, h),
                         extrinsic=np.eye(4))
            if labeled:
                entry["labels"] = [r.integers(0, 23, (h, w, 2)).astype(np.int32), None]
            out.append(entry)
        return out

    for testing in (False, True):
        got = twaymo.convert_frame_arrays(lasers(), testing=testing)
        want = jwaymo.convert_frame_arrays(lasers(), testing=testing)
        for name, mod, (velodyne, labels) in (("port", twaymo, got), ("jax", jwaymo, want)):
            mod.write_frame(str(tmp_path / name / f"seq{int(testing)}"), 3, velodyne, labels)
    assert_same_archives(str(tmp_path / "port"), str(tmp_path / "jax"))
    with pytest.raises(SystemExit) as want:
        jwaymo.handle_process(str(path), str(tmp_path / "o"))
    with pytest.raises(SystemExit) as got:
        twaymo.handle_process(str(path), str(tmp_path / "o"))
    assert str(got.value) == str(want.value) and "waymo-open-dataset" in str(got.value)


def test_fidelity_ablations_match_jax():
    """The three measured deviations over the port's own geometry (CPU)
    equal JAX's numbers."""
    assert tfidelity.k5_closure_miss_rate("random", device="cpu") == \
        jfidelity.k5_closure_miss_rate("random")
    assert tfidelity.devox_error() == jfidelity.devox_error()
    assert tfidelity.oacnns_scale_shift() == jfidelity.oacnns_scale_shift()
