"""Port data pipeline against the JAX package: the config system, every
ported transform on a 300-point scene, test-mode grid sampling, the ScanNet
dataset in test and val mode, collation and the metric histograms. The
same numpy seed goes into both packages; outputs must be equal array for
array."""

import copy
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cdsegnet_tpu.data import collate as jcollate  # noqa: E402
from cdsegnet_tpu.data import datasets as jdatasets  # noqa: E402
from cdsegnet_tpu.data import native as jnative  # noqa: E402
from cdsegnet_tpu.data import transforms as jtransforms  # noqa: E402
from cdsegnet_tpu.engine import config as jconfig  # noqa: E402
from cdsegnet_tpu.utils import misc as jmisc  # noqa: E402
from cdsegnet_torch.data import collate as tcollate  # noqa: E402
from cdsegnet_torch.data import datasets as tdatasets  # noqa: E402
from cdsegnet_torch.data import transforms as ttransforms  # noqa: E402
from cdsegnet_torch.engine import config as tconfig  # noqa: E402
from cdsegnet_torch.utils import misc as tmisc  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(REPO, "configs", "scannet", "cdsegnet.py")
TINY = os.path.join(REPO, "configs", "_smoke_", "cdsegnet_tiny.py")


@pytest.fixture
def jax_numpy_host_ops(monkeypatch):
    """The JAX package's numpy fallbacks in place of its C host library
    (whose `std::sort` may order equal keys otherwise)."""
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", True)


def plain(x):
    """Configs and scene dicts as plain containers, for comparison."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    return x


def assert_same(a, b, path="out"):
    """Equal structure, equal arrays (values, dtype and shape)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a.keys(), b.keys())
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


def scene(n=300, seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        coord=(rng.rand(n, 3) * 3).astype(np.float32),
        color=(rng.rand(n, 3) * 255).astype(np.float32),
        normal=rng.randn(n, 3).astype(np.float32),
        segment=rng.randint(0, 5, (n,)).astype(np.int64),
    )


@pytest.mark.parametrize("path", [SHIPPED, TINY])
def test_config_fromfile_matches_jax(path):
    want = jconfig.Config.fromfile(path)
    got = tconfig.Config.fromfile(path)
    assert plain(got) == plain(want)
    assert got.model.backbone.type == want.model.backbone.type  # attribute access
    opts = ["data.test.data_root=/x/y", "seed=7", "test_buckets=[256, 512]",
            "model.backbone.stem_mode=gather", "submission=True", "name=foo"]
    assert tconfig.parse_options(opts) == jconfig.parse_options(opts)
    want.merge_from_dict(jconfig.parse_options(opts))
    got.merge_from_dict(tconfig.parse_options(opts))
    assert plain(got) == plain(want)
    assert plain(got.copy()) == plain(want.copy())


def test_config_base_and_delete_match_jax(tmp_path):
    (tmp_path / "base.py").write_text("a = 1\nd = dict(x=1, y=dict(p=1, q=2))\n")
    (tmp_path / "child.py").write_text(
        "_base_ = 'base.py'\na = 2\nd = dict(y=dict(_delete_=True, r=3), z=4)\n")
    got = tconfig.Config.fromfile(str(tmp_path / "child.py"))
    want = jconfig.Config.fromfile(str(tmp_path / "child.py"))
    assert plain(got) == plain(want) == dict(a=2, d=dict(x=1, y=dict(r=3), z=4))


TRANSFORM_CASES = [
    [dict(type="CenterShift", apply_z=True)],
    [dict(type="CenterShift", apply_z=False)],
    [dict(type="NormalizeColor")],
    [dict(type="RandomRotate", angle=[-1, 1], axis="z", center=[0, 0, 0], p=0.5)],
    [dict(type="RandomRotate", angle=[-1 / 64, 1 / 64], axis="x", p=0.5)],
    [dict(type="RandomRotate", angle=[-1 / 64, 1 / 64], axis="y", p=0.5)],
    [dict(type="RandomRotateTargetAngle", angle=[0, 1 / 2, 1, 3 / 2], axis="z",
          center=[0, 0, 0], p=0.75)],
    [dict(type="RandomScale", scale=[0.9, 1.1])],
    [dict(type="RandomScale", scale=[0.9, 1.1], anisotropic=True)],
    [dict(type="RandomFlip", p=0.5)],
    [dict(type="Collect", keys=("coord", "segment"), feat_keys=("color", "normal"))],
    [dict(type="GridSample", grid_size=0.1, hash_type="fnv", mode="train",
          return_grid_coord=True, return_min_coord=True)],
    [dict(type="GridSample", grid_size=0.1, hash_type="ravel", mode="train",
          return_inverse=True, return_grid_coord=True)],
    [dict(type="GridSample", grid_size=0.1, hash_type="fnv", mode="test",
          keys=("coord", "color", "normal"), return_grid_coord=True)],
    [dict(type="GridSample", grid_size=0.2, hash_type="ravel", mode="test",
          keys=("coord", "segment"))],
]


@pytest.mark.parametrize("case", range(len(TRANSFORM_CASES)))
def test_transform_matches_jax(case, jax_numpy_host_ops):
    cfgs = TRANSFORM_CASES[case]
    jt, tt = jtransforms.Compose(cfgs), ttransforms.Compose(cfgs)
    jrng, trng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(4):  # several draws from one generator
        want = jt(copy.deepcopy(scene()), jrng)
        got = tt(copy.deepcopy(scene()), trng)
        assert_same(got, want)


def test_hashes_and_pick_match_jax():
    grid = np.random.RandomState(1).randint(0, 40, (500, 3))
    np.testing.assert_array_equal(ttransforms.fnv_hash_vec(grid),
                                  jtransforms.fnv_hash_vec(grid))
    np.testing.assert_array_equal(ttransforms.ravel_hash_vec(grid),
                                  jtransforms.ravel_hash_vec(grid))
    # the C library's hash, where it is built, is the same function
    np.testing.assert_array_equal(ttransforms.fnv_hash_vec(grid), jnative.fnv_hash(grid))
    keys = ttransforms.fnv_hash_vec(grid // 8)
    offsets = np.random.default_rng(2).integers(0, np.iinfo(np.int64).max, 500)
    got = ttransforms.grid_sample_pick(keys, offsets)
    # equal to the JAX numpy fallback; the C pick may order ties otherwise,
    # so against it compare the voxels picked
    lib, tried = jnative._LIB, jnative._TRIED
    try:
        jnative._LIB, jnative._TRIED = None, True
        np.testing.assert_array_equal(got, jnative.grid_sample_pick(keys, offsets))
    finally:
        jnative._LIB, jnative._TRIED = lib, tried
    np.testing.assert_array_equal(np.sort(keys[got]),
                                  np.sort(keys[jnative.grid_sample_pick(keys, offsets)]))


def write_scenes(root, n_scenes=2, n_points=300):
    """Pointcept-format ScanNet scenes: ``<root>/val/scene*.pth``."""
    os.makedirs(os.path.join(root, "val"), exist_ok=True)
    for i in range(n_scenes):
        s = scene(n_points, seed=10 + i)
        torch.save(dict(coord=s["coord"], color=s["color"], normal=s["normal"],
                        semantic_gt20=s["segment"]),
                   os.path.join(root, "val", f"scene{i:04d}_00.pth"))


@pytest.mark.parametrize("split", ["test", "val"])
def test_scannet_dataset_matches_jax(tmp_path, split, jax_numpy_host_ops):
    """The shipped config's test pipeline (13 augmentations, 2 cm test-mode
    grid sampling into fragments) and val pipeline (train-mode grid
    sampling), scene for scene."""
    write_scenes(str(tmp_path))
    cfg = plain(jconfig.Config.fromfile(SHIPPED).data[split])
    cfg["data_root"] = str(tmp_path)
    cfg["split"] = "val"
    jds, tds = jdatasets.build_dataset(cfg), tdatasets.build_dataset(cfg)
    assert len(tds) == len(jds) == 2
    jrng, trng = np.random.default_rng(54421566), np.random.default_rng(54421566)
    for idx in range(2):
        want, got = jds.get(idx, jrng), tds.get(idx, trng)
        assert_same(got, want)
    if split == "test":
        assert len(got["fragment_list"]) >= 13
        assert got["name"] == "scene0001_00"
        np.testing.assert_array_equal(tds.class2id, jds.class2id)
    assert tdatasets.VALID_CLASS_IDS_200 == jdatasets.VALID_CLASS_IDS_200
    assert tdatasets.SCANNET20_NAMES == jdatasets.SCANNET20_NAMES


def test_scannet_lr_and_la_files_match_jax(tmp_path, jax_numpy_host_ops):
    """Limited reconstructions (``lr_file``: a list of train scenes) and
    limited annotations (``la_file``: labelled point indices per scene,
    the rest ignored and carried as ``sampled_index`` through the grid
    sampling)."""
    os.makedirs(tmp_path / "train")
    for i in range(3):
        s = scene(200, seed=20 + i)
        torch.save(dict(coord=s["coord"], color=s["color"], normal=s["normal"],
                        semantic_gt20=s["segment"]),
                   tmp_path / "train" / f"scene{i:04d}_00.pth")
    (tmp_path / "lr.txt").write_text("scene0002_00\nscene0000_00\n")
    rng = np.random.RandomState(5)
    torch.save({f"scene{i:04d}_00": np.sort(rng.choice(200, 30, replace=False))
                for i in range(3)}, tmp_path / "la.pth")
    cfg = dict(type="ScanNetDataset", split="train", data_root=str(tmp_path),
               lr_file=str(tmp_path / "lr.txt"), la_file=str(tmp_path / "la.pth"),
               transform=[dict(type="CenterShift", apply_z=True),
                          dict(type="GridSample", grid_size=0.1, hash_type="fnv",
                               mode="train", return_grid_coord=True),
                          dict(type="NormalizeColor")])
    jds, tds = jdatasets.build_dataset(cfg), tdatasets.build_dataset(cfg)
    assert tds.data_list == jds.data_list and len(tds) == 2
    jrng, trng = np.random.default_rng(1), np.random.default_rng(1)
    for idx in range(2):
        got, want = tds.get(idx, trng), jds.get(idx, jrng)
        assert "sampled_index" in got
        assert_same(got, want)


def test_dataset_npy_directories_match_jax(tmp_path):
    d = tmp_path / "train" / "scene0007_00"
    d.mkdir(parents=True)
    for k, v in scene(50).items():
        np.save(d / f"{k}.npy", v)
    cfg = dict(type="DefaultDataset", split="train", data_root=str(tmp_path),
               transform=[dict(type="CenterShift", apply_z=True)])
    got = tdatasets.build_dataset(cfg).get(0, np.random.default_rng(0))
    want = jdatasets.build_dataset(cfg).get(0, np.random.default_rng(0))
    assert_same(got, want)


def test_collate_and_buckets_match_jax():
    rng = np.random.RandomState(3)
    scenes = []
    for n in (120, 200, 90):
        s = dict(coord=rng.rand(n, 3).astype(np.float32),
                 grid_coord=rng.randint(0, 50, (n, 3)),
                 feat=rng.randn(n, 6).astype(np.float32),
                 segment=rng.randint(-1, 5, (n,)),
                 origin_coord=rng.rand(n, 3).astype(np.float32))
        if n != 200:
            s["instance"] = rng.randint(-1, 4, (n,))
            s["instance_centroid"] = rng.rand(n, 3).astype(np.float32)
        scenes.append(s)
    for args in ((scenes, 512, 4), (scenes, 300, None), (scenes[:1], 256, 1)):
        for extra in ((), ("origin_coord",)):
            assert_same(tcollate.collate_scenes(*args, extra_float_keys=extra),
                        jcollate.collate_scenes(*args, extra_float_keys=extra))
    buckets = (256, 512, 16384)
    for n in (1, 256, 257, 512, 9000, 16384, 20000):
        assert tcollate.pick_bucket(n, buckets) == jcollate.pick_bucket(n, buckets)


def test_metrics_match_jax():
    rng = np.random.RandomState(4)
    pred = rng.randint(0, 20, 5000)
    target = rng.randint(-1, 20, 5000)
    for ignore in (-1, 3):
        assert_same(tuple(tmisc.intersection_and_union(pred, target, 20, ignore)),
                    tuple(jmisc.intersection_and_union(pred, target, 20, ignore)))
    tm, jm = tmisc.AverageMeter(), jmisc.AverageMeter()
    for v, n in ((1.5, 2), (0.5, 3)):
        tm.update(v, n)
        jm.update(v, n)
    assert (tm.avg, tm.sum, tm.count, tm.val) == (jm.avg, jm.sum, jm.count, jm.val)


def test_room_scene_is_a_seeded_scannet_scan():
    """The synthetic room of `chip_smoke.py`'s tester phase: ScanNet
    archive fields, colors in 0-255, unit normals, labels of the 20-class
    set and the same classes among ScanNet200's; the same seed gives the
    same scan."""
    from cdsegnet_torch.data.datasets import SCANNET20_NAMES
    from cdsegnet_torch.utils.synthetic import room_scene

    a, b = room_scene(3, cell=0.1), room_scene(3, cell=0.1)
    assert sorted(a) == ["color", "coord", "normal", "semantic_gt20", "semantic_gt200"]
    # each point's ScanNet200 class is its ScanNet-20 class (by name; the
    # first names of the benchmark's CLASS_LABELS_200)
    names200 = {0: "wall", 1: "chair", 2: "floor", 3: "table", 6: "cabinet", 10: "bed"}
    assert [names200[i] for i in a["semantic_gt200"]] == [
        SCANNET20_NAMES[i] for i in a["semantic_gt20"]]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    n = len(a["coord"])
    assert a["coord"].shape == (n, 3) and a["coord"].dtype == np.float32
    assert a["color"].min() >= 0 and a["color"].max() <= 255
    np.testing.assert_allclose(np.linalg.norm(a["normal"], axis=1), 1.0)
    assert set(np.unique(a["semantic_gt20"])) <= set(range(20))
    assert not np.array_equal(room_scene(4, cell=0.1)["coord"], a["coord"])
