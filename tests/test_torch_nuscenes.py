"""The port's nuScenes lidarseg data against the JAX package: the learning
map, `NuScenesDataset` over synthetic sweeps written in the info-pickle and
`.bin` layout, the train, val and test pipelines of
`configs/nuscenes/cdsegnet.py` array for array (4 input channels from
``coord`` and ``strength``), and the tester's records and lidarseg
submission files with a tiny 4-channel, 16-class model and JAX's noise fed
to the port."""

import copy
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import optax  # noqa: E402

from cdsegnet_tpu.data import datasets as jdatasets  # noqa: E402
from cdsegnet_tpu.engine.config import Config as JConfig  # noqa: E402
from cdsegnet_tpu.engine.state import TrainState  # noqa: E402
from cdsegnet_tpu.engine.test import SemSegTester as JTester  # noqa: E402
from cdsegnet_tpu.models.builder import build_model as jbuild  # noqa: E402
from cdsegnet_torch.data import datasets as tdatasets  # noqa: E402
from cdsegnet_torch.engine.config import Config  # noqa: E402
from cdsegnet_torch.engine.test import SemSegTester  # noqa: E402
from cdsegnet_torch.models.builder import build_model as tbuild  # noqa: E402
from cdsegnet_torch.utils.synthetic import lidar_sweep, write_nuscenes  # noqa: E402
from cdsegnet_torch.utils.weights import load_jax_variables  # noqa: E402
from test_model import TINY_MODEL  # noqa: E402
from test_torch_data import assert_same, jax_numpy_host_ops  # noqa: E402,F401
from test_torch_model import as_numpy, batches, random_variables  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "nuscenes", "cdsegnet.py")


def sweeps(seeds, every=1):
    out = []
    for s in seeds:
        sw = lidar_sweep(s)
        out.append({k: v[::every] for k, v in sw.items()})
    return out


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Two full sweeps per split (the test split without labels)."""
    root = str(tmp_path_factory.mktemp("nuscenes"))
    write_nuscenes(root, dict(train=sweeps((1, 2)), val=sweeps((3, 4)),
                              test=sweeps((5, 6))))
    return root


def test_learning_map_matches_jax():
    for ignore in (-1, 255):
        got = tdatasets.NuScenesDataset.get_learning_map(ignore)
        assert got == jdatasets.NuScenesDataset.get_learning_map(ignore)
        assert sorted(got) == list(range(32))
        assert sorted({v for v in got.values() if v != ignore}) == list(range(16))


def test_lidar_sweep_is_a_seeded_nuscenes_sweep(root):
    """32 rings of about 1,085 returns within 70 m, intensity 0-255, raw
    lidarseg ids the learning map keeps; written as the dataset reads it."""
    a, b = lidar_sweep(0), lidar_sweep(0)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    p = a["points"]
    assert p.dtype == np.float32 and p.shape[1] == 5 and 33000 < len(p) <= 32 * 1085
    assert np.linalg.norm(p[:, :3], axis=1).max() < 70.5
    assert p[:, 3].min() >= 0 and p[:, 3].max() <= 255
    np.testing.assert_array_equal(np.unique(p[:, 4]), np.arange(32))
    learning = tdatasets.NuScenesDataset.get_learning_map(-1)
    assert all(learning[int(v)] >= 0 for v in np.unique(a["labels"]))
    assert not np.array_equal(lidar_sweep(1)["points"], p)
    ds = tdatasets.NuScenesDataset(split="train", data_root=root)
    item = ds.get_data(0)
    sw = lidar_sweep(1)
    np.testing.assert_array_equal(item["coord"], sw["points"][:, :3])
    np.testing.assert_array_equal(item["strength"], sw["points"][:, 3:4] / 255.0)
    assert ds.get_data_name(0) == "train0" and len(ds) == 2


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_nuscenes_pipelines_match_jax(root, split, jax_numpy_host_ops):
    """The shipped config's pipeline of each split, through both datasets
    with the same numpy generator: every array equal. Test mode expands
    each sweep into its 5 cm fragments."""
    cfg, jcfg = Config.fromfile(CONFIG), JConfig.fromfile(CONFIG)
    key = "test" if split == "test" else split
    t = dict(cfg.data[key], data_root=root, split=split)
    j = dict(jcfg.data[key], data_root=root, split=split)
    tds, jds = tdatasets.build_dataset(t), jdatasets.build_dataset(j)
    assert len(tds) == len(jds) == 2
    trng, jrng = np.random.default_rng(54421566), np.random.default_rng(54421566)
    for idx in range(2):
        got, want = tds.get(idx, trng), jds.get(idx, jrng)
        assert_same(got, want)
        if split == "test":
            assert got["name"] == f"test{idx}" and (got["segment"] == -1).all()
            frag = got["fragment_list"][0]
            assert frag["feat"].shape[1] == 4  # coord + strength
        else:
            assert got["feat"].shape[1] == 4
            assert set(np.unique(got["segment"])) <= set(range(16))


def tiny_nuscenes_model():
    cfg = copy.deepcopy(TINY_MODEL)
    cfg["backbone"].update(c_in_channels=4, n_in_channels=4, num_classes=16)
    cfg.update(c_in_channels=4, num_classes=16, noise_schedule="linear",
               beta_start=0.001, beta_end=0.005)
    return cfg


def sweep_test_cfg(root, save):
    cfg = Config.fromfile(CONFIG)
    cfg.merge_from_dict(dict(save_path=save, submission=True, num_devices=1,
                             test_buckets=[1024, 2048, 4096], seed=0))
    cfg["model"] = tiny_nuscenes_model()
    cfg.data.test["data_root"] = root
    return cfg


@pytest.fixture(scope="module")
def jtester(tmp_path_factory):
    """JAX's tester on two sweeps thinned to every 16th return (about 2,200
    points, fragments in the 4,096 bucket): per-fragment noise and
    probabilities, records and the submission files."""
    tmp = tmp_path_factory.mktemp("nuscenes_tester")
    root = str(tmp / "data")
    write_nuscenes(root, dict(val=sweeps((7, 8), every=16)))
    model = jbuild(tiny_nuscenes_model())
    pt = batches()["fit"]
    variables = random_variables(model, pt.replace(feat=pt.feat[:, :4]))
    state = TrainState.create(variables, optax.identity(), jax.random.PRNGKey(0))
    save = str(tmp / "jax")
    jcfg = JConfig(JConfig._wrap(dict(sweep_test_cfg(root, save))))
    tester = JTester(jcfg, state=state, model=model, verbose=False)
    noise, probs = [], []
    prepare, predict = tester._prepare_fragment, tester.predict_fragment

    def record_noise(frag, rng):
        out = prepare(frag, rng)
        noise.append(np.asarray(out[3]))
        return out

    def record_probs(frag, rng):
        p = predict(frag, rng)
        probs.append(np.asarray(p))
        return p

    tester._prepare_fragment = record_noise
    tester.predict_fragment = record_probs
    miou = tester.test()
    sub = os.path.join(save, "submit", "lidarseg", "test")
    files = {f: open(os.path.join(sub, f), "rb").read() for f in sorted(os.listdir(sub))}
    return dict(root=root, variables=as_numpy(variables), noise=noise, probs=probs,
                miou=miou, records=tester.records, files=files)


def test_nuscenes_tester_and_submission_match_jax(jtester, tmp_path):
    save = str(tmp_path / "port")
    model = tbuild(tiny_nuscenes_model(), device="cpu")
    load_jax_variables(model, jtester["variables"])
    tester = SemSegTester(sweep_test_cfg(jtester["root"], save), model=model, device="cpu",
                          verbose=False)
    probs = []
    predict = tester.predict_fragment

    def record_probs(frag, index, noise_fn=None, feat_noise_fn=None):
        p = predict(frag, index, noise_fn, feat_noise_fn)
        probs.append(p.numpy())
        return p

    tester.predict_fragment = record_probs
    miou = tester.test(noise_fn=lambda i, bucket, c_in: np.array(jtester["noise"][i]))
    assert len(probs) == len(jtester["probs"]) >= 2
    for got, want in zip(probs, jtester["probs"]):
        assert got.shape == want.shape and got.shape[1] == 16
        assert np.abs(got - want).max() <= 1e-4
    assert sorted(tester.records) == sorted(jtester["records"]) == ["val0", "val1"]
    for name, rec in jtester["records"].items():
        for k in ("intersection", "union", "target"):
            np.testing.assert_array_equal(tester.records[name][k], rec[k])
    assert miou == pytest.approx(jtester["miou"], abs=0)
    sub = os.path.join(save, "submit", "lidarseg", "test")
    assert sorted(os.listdir(sub)) == sorted(jtester["files"]) == [
        "val0_lidarseg.bin", "val1_lidarseg.bin"]
    for f, want in jtester["files"].items():
        got = open(os.path.join(sub, f), "rb").read()
        assert got == want, f
        labels = np.frombuffer(got, np.uint8)
        assert labels.min() >= 1 and labels.max() <= 16  # pred + 1
