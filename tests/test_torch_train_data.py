"""Port training data pipeline against the JAX package: the seven training
augmentations of `configs/scannet/cdsegnet.py`, Mix3D, the ScanNet dataset in train mode with ``loop``, `TrainLoader`
over two epochs and `EvalLoader`. The same numpy seeds go into both
packages; outputs must be equal array for array."""

import copy
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cdsegnet_tpu.data import collate as jcollate  # noqa: E402
from cdsegnet_tpu.data import datasets as jdatasets  # noqa: E402
from cdsegnet_tpu.data import loader as jloader  # noqa: E402
from cdsegnet_tpu.data import transforms as jtransforms  # noqa: E402
from cdsegnet_tpu.engine import config as jconfig  # noqa: E402
from cdsegnet_torch.data import collate as tcollate  # noqa: E402
from cdsegnet_torch.data import datasets as tdatasets  # noqa: E402
from cdsegnet_torch.data import loader as tloader  # noqa: E402
from cdsegnet_torch.data import transforms as ttransforms  # noqa: E402
from test_engine import _write_synthetic_dataset  # noqa: E402
from test_torch_data import SHIPPED, assert_same, jax_numpy_host_ops, plain, scene  # noqa: E402,F401

torch.set_num_threads(2)


def shipped_transform(split: str, point_max: int = 150):
    """The shipped config's train or val transform list, SphereCrop shrunk
    to ``point_max``."""
    out = plain(jconfig.Config.fromfile(SHIPPED).data[split].transform)
    for t in out:
        if t["type"] == "SphereCrop":
            t["point_max"] = point_max
    return out


TRAIN_CASES = {
    "dropout_shipped": dict(type="RandomDropout", dropout_ratio=0.2,
                            dropout_application_ratio=0.2),
    "dropout_always": dict(type="RandomDropout", dropout_ratio=0.5,
                           dropout_application_ratio=1.0),
    "jitter": dict(type="RandomJitter", sigma=0.005, clip=0.02),
    "jitter_clipped": dict(type="RandomJitter", sigma=0.05, clip=0.02),
    "elastic": dict(type="ElasticDistortion", distortion_params=[[0.2, 0.4], [0.8, 1.6]]),
    "autocontrast": dict(type="ChromaticAutoContrast", p=0.2, blend_factor=None),
    "autocontrast_always": dict(type="ChromaticAutoContrast", p=1.0, blend_factor=0.5),
    "translation": dict(type="ChromaticTranslation", p=0.95, ratio=0.05),
    "chromatic_jitter": dict(type="ChromaticJitter", p=0.95, std=0.05),
    "crop_random": dict(type="SphereCrop", point_max=120, mode="random"),
    "crop_center": dict(type="SphereCrop", point_max=120, mode="center"),
    "crop_rate": dict(type="SphereCrop", sample_rate=0.4, mode="random"),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_training_transform_matches_jax(case):
    cfgs = [TRAIN_CASES[case]]
    jt, tt = jtransforms.Compose(cfgs), ttransforms.Compose(cfgs)
    jrng, trng = np.random.default_rng(7), np.random.default_rng(7)
    changed = 0
    for _ in range(16):  # several draws from one generator
        want = jt(copy.deepcopy(scene()), jrng)
        got = tt(copy.deepcopy(scene()), trng)
        assert_same(got, want)
        changed += not all(np.array_equal(got[k], v) for k, v in scene().items())
    assert changed > 0  # the transform did something in some draw
    assert jrng.random() == trng.random()  # the same draws were taken


@pytest.mark.parametrize("scipy_present", [True, False])
def test_elastic_distortion_with_and_without_scipy(scipy_present, monkeypatch):
    """Without scipy both packages leave the points as they are and take no
    draw at all."""
    monkeypatch.setattr(jtransforms, "_HAVE_SCIPY", scipy_present)
    monkeypatch.setattr(ttransforms, "_HAVE_SCIPY", scipy_present)
    cfg = [dict(type="ElasticDistortion")]
    jrng, trng = np.random.default_rng(3), np.random.default_rng(3)
    want = jtransforms.Compose(cfg)(scene(), jrng)
    got = ttransforms.Compose(cfg)(scene(), trng)
    assert_same(got, want)
    moved = not np.array_equal(got["coord"], scene()["coord"])
    assert moved == scipy_present
    after = jrng.random()
    assert after == trng.random()  # the same draws were taken
    if not scipy_present:
        assert after == np.random.default_rng(3).random()  # and none at all


def test_dropout_keeps_the_sampled_index():
    """Limited annotations: `RandomDropout` keeps every labelled point and
    re-indexes ``sampled_index`` as JAX does."""
    cfg = [dict(type="RandomDropout", dropout_ratio=0.5, dropout_application_ratio=1.0)]
    for seed in range(3):
        data = scene()
        data["sampled_index"] = np.sort(np.random.RandomState(seed).choice(300, 40, False))
        want = jtransforms.Compose(cfg)(copy.deepcopy(data), np.random.default_rng(seed))
        got = ttransforms.Compose(cfg)(copy.deepcopy(data), np.random.default_rng(seed))
        assert_same(got, want)
        np.testing.assert_array_equal(got["segment"][got["sampled_index"]],
                                      data["segment"][data["sampled_index"]])


def mix_scenes(n_scenes=3, seed=0):
    """Collated-ready scenes whose voxels overlap across scenes."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_scenes):
        n = rng.randint(60, 90)
        out.append(dict(coord=rng.rand(n, 3).astype(np.float32),
                        grid_coord=rng.randint(0, 5, (n, 3)).astype(np.int32),
                        feat=rng.randn(n, 6).astype(np.float32),
                        segment=rng.randint(-1, 5, (n,)), name="s"))
    return out


@pytest.mark.parametrize("n_scenes,mix_prob", [(2, 0.8), (3, 1.0), (2, 0.0), (1, 1.0)])
def test_mix3d_matches_jax(n_scenes, mix_prob):
    merged_any = False
    for seed in range(4):
        scenes = mix_scenes(n_scenes, seed)
        jrng, trng = np.random.default_rng(seed), np.random.default_rng(seed)
        want = jcollate.mix3d(copy.deepcopy(scenes), jrng, mix_prob)
        got = tcollate.mix3d(copy.deepcopy(scenes), trng, mix_prob)
        assert_same(got, want)
        if len(got) < n_scenes:
            merged_any = True
            m = got[0]
            # first-wins dedup of the coincident voxels of the pair
            assert len(np.unique(m["grid_coord"], axis=0)) == len(m["grid_coord"])
            assert len(m["grid_coord"]) < len(scenes[0]["coord"]) + len(scenes[1]["coord"])
    assert merged_any == (mix_prob > 0 and n_scenes > 1)


@pytest.fixture
def smoke_root(tmp_path):
    root = str(tmp_path / "data")
    _write_synthetic_dataset(root, n_scenes=4, n_points=400)
    return root


def train_dataset_cfg(root, **extra):
    return dict(type="ScanNetDataset", split="train", data_root=root,
                transform=shipped_transform("train"), test_mode=False, **extra)


def test_scannet_train_mode_with_loop_matches_jax(smoke_root, jax_numpy_host_ops):
    cfg = train_dataset_cfg(smoke_root, loop=3)
    jds, tds = jdatasets.build_dataset(cfg), tdatasets.build_dataset(cfg)
    assert len(tds) == len(jds) == 4 * 3 == len(tds.data_list) * 3
    jrng, trng = np.random.default_rng(11), np.random.default_rng(11)
    for idx in (0, 5, 11):  # idx wraps the data list: scene idx % 4
        want, got = jds.get(idx, jrng), tds.get(idx, trng)
        assert_same(got, want)
        assert len(got["coord"]) == 150  # the shrunk SphereCrop
    assert tds.get_data_name(5) == tds.get_data_name(1)


def test_la_file_through_the_training_transforms_matches_jax(tmp_path, jax_numpy_host_ops):
    """``sampled_index`` of limited annotations through RandomDropout and
    the train-mode GridSample of the shipped list (its SphereCrop, which
    does not carry the index, left out)."""
    root = str(tmp_path)
    _write_synthetic_dataset(root, n_scenes=2, n_points=300)
    rng = np.random.RandomState(5)
    torch.save({f"scene{i:04d}": np.sort(rng.choice(300, 40, replace=False))
                for i in range(2)}, tmp_path / "la.pth")
    transform = [t for t in shipped_transform("train") if t["type"] != "SphereCrop"]
    for t in transform:
        if t["type"] == "RandomDropout":
            t["dropout_application_ratio"] = 1.0
    cfg = dict(type="ScanNetDataset", split="train", data_root=root,
               la_file=str(tmp_path / "la.pth"), transform=transform)
    jds, tds = jdatasets.build_dataset(cfg), tdatasets.build_dataset(cfg)
    jrng, trng = np.random.default_rng(2), np.random.default_rng(2)
    for idx in range(2):
        data = tds.get_data(idx)
        assert "sampled_index" in data
        want, got = jds.get(idx, jrng), tds.get(idx, trng)
        assert_same(got, want)
        assert (got["segment"] >= 0).sum() == 40  # every labelled point kept


def test_train_loader_matches_jax_over_two_epochs(smoke_root, jax_numpy_host_ops):
    """The shipped train transforms (SphereCrop shrunk to 150 points), two
    scenes per 300-slot bucket, Mix3D 0.8, prefetch on, two epochs of a
    dataset looped twice."""
    cfg = train_dataset_cfg(smoke_root, loop=2)
    kw = dict(num_devices=1, scenes_per_device=2, num_points=300, mix_prob=0.8,
              seed=54421566, prefetch=2)
    jl = jloader.TrainLoader(jdatasets.build_dataset(cfg), **kw)
    tl = tloader.TrainLoader(tdatasets.build_dataset(cfg), **kw)
    assert len(tl) == len(jl) == 4
    n_batches, mixed = 0, 0
    for epoch in (0, 1):
        want = list(jl.epoch(epoch))
        got = list(tl.epoch(epoch))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert_same(g, {k: v[0] for k, v in w.items()})  # JAX's device axis
            assert g["coord"].shape == (300, 3)
            mixed += int((g["batch"][g["mask"]] == 0).all())
            n_batches += 1
    assert n_batches == 8 and 0 < mixed < 8  # some batches were merged by Mix3D
    # the loader drops the last incomplete batch, as JAX's does
    odd = dict(kw, prefetch=0)
    tds3 = tdatasets.build_dataset(dict(cfg, loop=1))
    tds3.data_list = tds3.data_list[:3]
    assert len(tloader.TrainLoader(tds3, **odd)) == 1
    assert len(tloader.TrainLoader(tds3, drop_last=False, **odd)) == 2


def test_train_loader_raises_what_the_prefetch_thread_raises():
    class Broken:
        def __len__(self):
            return 4

        def get(self, idx, rng):
            raise OSError("unreadable scene")

    loader = tloader.TrainLoader(Broken(), num_points=300, prefetch=2)
    with pytest.raises(OSError, match="unreadable scene"):
        list(loader.epoch(0))


def test_train_loader_thread_stops_with_its_consumer(smoke_root):
    import threading

    before = threading.active_count()
    loader = tloader.TrainLoader(tdatasets.build_dataset(train_dataset_cfg(smoke_root,
                                                                           loop=4)),
                                 num_points=300, prefetch=1)
    batches = loader.epoch(0)
    next(batches)
    batches.close()  # the consumer stops after one of 8 batches
    assert threading.active_count() == before


def test_eval_loader_matches_jax(smoke_root, jax_numpy_host_ops):
    cfg = dict(type="ScanNetDataset", split="val", data_root=smoke_root,
               transform=shipped_transform("val"), test_mode=False)
    jl = jloader.EvalLoader(jdatasets.build_dataset(cfg), num_points=512, seed=3)
    tl = tloader.EvalLoader(tdatasets.build_dataset(cfg), num_points=512, seed=3)
    assert len(tl) == len(jl) == 2
    for (gb, gs), (wb, ws) in zip(tl, jl):
        assert_same(gb, wb)
        assert_same(gs, ws)
        assert gb["coord"].shape == (512, 3)


@pytest.mark.parametrize("kwargs,error,match", [
    # ranks and micro buckets are ported: a rank outside the devices, or a
    # microbatch that does not divide the scenes, is refused
    pytest.param(dict(num_devices=2, rank=2), ValueError, "rank 2", id="kwargs0"),
    pytest.param(dict(microbatch=3), ValueError, "must divide", id="kwargs1")])
def test_unported_loader_options_raise(kwargs, error, match):
    with pytest.raises(error, match=match):
        tloader.TrainLoader([], **kwargs)
