"""Port tester against the JAX package: `SemSegTester` on two synthetic
ScanNet-format scenes with the tiny model in f32, the same weights carried
over and JAX's per-fragment noise fed to the port, with and without the
test-time covering crops; the port's checkpoints;
the testing CLI end to end on the CPU; and the port's device and
not-ported rules for the tester."""

import copy
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from cdsegnet_tpu.engine.state import TrainState  # noqa: E402
from cdsegnet_tpu.engine.test import SemSegTester as JTester  # noqa: E402
from cdsegnet_tpu.models.builder import build_model as jbuild  # noqa: E402
from cdsegnet_tpu.models.structure import make_point_batch as jmake  # noqa: E402
from cdsegnet_torch.data.collate import collate_scenes as tcollate_scenes  # noqa: E402
from cdsegnet_torch.engine.checkpoint import CheckpointManager, snapshot  # noqa: E402
from cdsegnet_torch.engine.config import Config  # noqa: E402
from cdsegnet_torch.engine.optimizer import build_optimizer  # noqa: E402
from cdsegnet_torch.engine.state import make_generators  # noqa: E402
from cdsegnet_torch.engine.test import SemSegTester  # noqa: E402
from cdsegnet_torch.models.builder import build_model as tbuild  # noqa: E402
from cdsegnet_torch.tools import test as ttool  # noqa: E402
from cdsegnet_torch.utils.weights import load_jax_variables  # noqa: E402
from test_engine import _write_synthetic_dataset  # noqa: E402
from test_model import TINY_MODEL  # noqa: E402
from test_torch_model import as_numpy, random_variables  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CONFIG = os.path.join(REPO, "configs", "_smoke_", "cdsegnet_tiny.py")

TEST_DATA = dict(
    type="ScanNetDataset", split="val",
    transform=[dict(type="CenterShift", apply_z=True), dict(type="NormalizeColor")],
    test_mode=True,
    test_cfg=dict(
        voxelize=dict(type="GridSample", grid_size=0.1, hash_type="fnv", mode="test",
                      keys=("coord", "color", "normal"), return_grid_coord=True),
        crop=None,
        post_transform=[
            dict(type="CenterShift", apply_z=False),
            dict(type="Collect", keys=("coord", "grid_coord", "index"),
                 feat_keys=("color", "normal")),
        ],
        aug_transform=[
            [dict(type="RandomRotateTargetAngle", angle=[0], axis="z",
                  center=[0, 0, 0], p=1)],
            [dict(type="RandomFlip", p=1)],
        ],
    ),
)


# the covering crops of the crop tester: every 300-point fragment splits
# into two crops, which stay in the 512-slot bucket
CROP = dict(type="SphereCrop", point_max=260, mode="all")


def scene_cfg(root, save, crop=None, **extra):
    """The JAX engine test's layout (`tests/test_engine.py`), on one device;
    ``crop``: the test-time crop."""
    test = copy.deepcopy(dict(TEST_DATA, data_root=root))
    test["test_cfg"]["crop"] = crop
    cfg = dict(
        save_path=save, seed=0, serialization_depth=7, submission=True,
        test_buckets=[256, 512], ignore_index=-1, num_devices=1,
        model=copy.deepcopy(TINY_MODEL),
        data=dict(num_classes=5, ignore_index=-1, names=[f"c{i}" for i in range(5)],
                  test=test))
    cfg.update(extra)
    return cfg


def outputs(save, names):
    """Preds and submission lines per scene, as written."""
    return {n: (np.load(os.path.join(save, "result", f"{n}_pred.npy")),
                open(os.path.join(save, "submit", f"{n}.txt")).read())
            for n in names}


def port_model(variables):
    m = tbuild(copy.deepcopy(TINY_MODEL), device="cpu")
    load_jax_variables(m, as_numpy(variables))
    return m


def jax_run(tester, save, crop=None):
    """One `test()` of JAX's tester with ``crop``: per-fragment noise and
    probabilities (recorded by wrapping the instance's methods), records,
    preds and submissions."""
    run = dict(noise=[], probs=[])
    prepare, predict = tester._prepare_fragment, tester.predict_fragment

    def record_noise(frag, rng):
        out = prepare(frag, rng)
        run["noise"].append(np.asarray(out[3]))
        return out

    def record_probs(frag, rng):
        p = predict(frag, rng)
        run["probs"].append(np.asarray(p))
        return p

    tester.cfg = Config(Config._wrap(scene_cfg(tester.root, save, crop=crop)))
    tester.save_path = save
    tester._prepare_fragment, tester.predict_fragment = record_noise, record_probs
    try:
        run["miou"] = tester.test()
    finally:
        tester._prepare_fragment, tester.predict_fragment = prepare, predict
    return dict(run, records=tester.records, out=outputs(save, sorted(tester.records)))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """JAX's tester run on the grid fragments, and the tester itself (its
    compiled forward serves `crop_ref`)."""
    tmp = tmp_path_factory.mktemp("tester")
    root = str(tmp / "data")
    _write_synthetic_dataset(root, n_scenes=2, n_points=300)
    model = jbuild(copy.deepcopy(TINY_MODEL))
    n = 512
    point = jmake(coord=jnp.zeros((n, 3)), feat=jnp.zeros((n, 6)),
                  grid_coord=jnp.zeros((n, 3), jnp.int32),
                  batch=jnp.zeros((n,), jnp.int32),
                  mask=jnp.zeros((n,), bool).at[:300].set(True),
                  segment=jnp.zeros((n,), jnp.int32), depth=7, num_scenes=1)
    variables = random_variables(model, point)
    state = TrainState.create(variables, optax.identity(), jax.random.PRNGKey(0))
    tester = JTester(Config(Config._wrap(scene_cfg(root, str(tmp / "unused")))), state=state,
                     model=model, verbose=False)
    tester.root = root
    run = jax_run(tester, str(tmp / "jax"))
    return dict(run, root=root, variables=variables, tester=tester, tmp=tmp)


@pytest.fixture(scope="module")
def crop_ref(ref):
    """JAX's tester run with the covering crops, on the same compiled
    forward."""
    return jax_run(ref["tester"], str(ref["tmp"] / "jax_crop"), crop=CROP)


def run_against_jax(ref, run, save, crop=None):
    """The port's tester with JAX's noise of ``run`` fed in: per-fragment
    probabilities within 1e-4, preds where the top two votes differ by
    more than 1e-4, then records, preds and submissions equal; returns the
    tester and its mIoU."""
    tester = SemSegTester(Config(Config._wrap(scene_cfg(ref["root"], save, crop=crop))),
                          model=port_model(ref["variables"]), device="cpu",
                          verbose=False)
    probs, index_of = [], []
    predict = tester.predict_fragment

    def record_probs(frag, index, noise_fn=None, feat_noise_fn=None):
        p = predict(frag, index, noise_fn, feat_noise_fn)
        probs.append(p.numpy())
        index_of.append(frag["index"])
        return p

    tester.predict_fragment = record_probs
    per_scene = []  # (first fragment, fragment count) of each scene, in order
    finalize = tester._finalize_scene

    def record_scene(ds, name, pred, segment):
        first = sum(count for _, count in per_scene)
        per_scene.append((first, len(probs) - first))
        return finalize(ds, name, pred, segment)

    tester._finalize_scene = record_scene
    calls = []

    def jax_noise(index, bucket, c_in):
        calls.append(index)
        assert run["noise"][index].shape == (bucket, c_in)
        return np.array(run["noise"][index])

    miou = tester.test(noise_fn=jax_noise)
    # 2 scenes x 2 augmentations x the largest voxel occupancy of each
    assert calls == list(range(len(run["noise"]))) and len(calls) >= 4
    assert len(probs) == len(run["probs"])
    for got, want in zip(probs, run["probs"]):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4
    # preds wherever the top two votes differ by more than 1e-4; then the
    # records and the files, which the tolerance leaves equal here
    names = sorted(run["records"])
    assert sorted(tester.records) == names
    got_out = outputs(save, names)
    for (first, count), name in zip(per_scene, names):
        votes = np.zeros((300, 5), np.float32)
        for k in range(first, first + count):
            votes[index_of[k]] += probs[k]
        top2 = np.sort(votes, axis=1)[:, -2:]
        decided = top2[:, 1] - top2[:, 0] > 1e-4
        got_pred, want_pred = got_out[name][0], run["out"][name][0]
        assert got_pred.dtype == want_pred.dtype and got_pred.shape == want_pred.shape
        np.testing.assert_array_equal(got_pred[decided], want_pred[decided])
        for k in ("intersection", "union", "target"):
            np.testing.assert_array_equal(tester.records[name][k], run["records"][name][k])
        np.testing.assert_array_equal(got_pred, want_pred)
        assert got_out[name][1] == run["out"][name][1]
    assert miou == pytest.approx(run["miou"], abs=0)
    assert 0.0 <= tester.result["macc"] <= 1.0 and 0.0 <= tester.result["allacc"] <= 1.0
    return tester, miou


def test_semseg_tester_matches_jax(ref, tmp_path):
    save = str(tmp_path / "port")
    tester, miou = run_against_jax(ref, ref, save)
    assert len(ref["noise"]) >= 4  # 2 scenes x 2 augmentations x voxel occupancy

    # a second run reads every scene's cached prediction: no forward
    rerun = SemSegTester(Config(Config._wrap(scene_cfg(ref["root"], save))),
                         model=tester.model, device="cpu", verbose=False)
    rerun.forward_fragment = lambda *a: pytest.fail("cached scenes take no forward")
    assert rerun.test() == miou
    for name in ref["records"]:
        for k in ("intersection", "union", "target"):
            np.testing.assert_array_equal(rerun.records[name][k], ref["records"][name][k])


def test_crop_tester_matches_jax(ref, crop_ref, tmp_path):
    """The test-time covering crops (`SphereCrop` mode "all" after the grid
    sampling): each crop is one forward; records, preds and submissions
    equal JAX's, every raw point voted."""
    assert len(crop_ref["noise"]) > len(ref["noise"])
    tester, _ = run_against_jax(ref, crop_ref, str(tmp_path / "port"), crop=CROP)
    for name in crop_ref["records"]:
        assert np.load(tmp_path / "port" / "result" / f"{name}_pred.npy").shape == (300,)
        assert tester.records[name]["target"].sum() == 300


def test_noise_is_seeded_per_fragment(ref):
    """Without injected noise, the port draws each fragment's noise (and the
    robustness perturbation) from the generator seeded by cfg.seed: the
    same seed gives the same probabilities."""
    cfg = Config(Config._wrap(scene_cfg(ref["root"], "unused", noise_level=0.1)))
    model = port_model(ref["variables"])
    ds = __import__("cdsegnet_torch.data.datasets", fromlist=["x"]).build_dataset(
        dict(cfg.data.test))
    frag = ds.get(0, np.random.default_rng(0))["fragment_list"][0]
    runs = []
    for noise_level in (0.1, 0.1, None):
        cfg["noise_level"] = noise_level
        t = SemSegTester(cfg, model=model, device="cpu", verbose=False)
        runs.append(t.predict_fragment(frag, 0).numpy())
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    with pytest.raises(ValueError, match="noise_fn gave shape"):
        t.predict_fragment(frag, 0, noise_fn=lambda i, b, c: np.zeros((b, c + 1)))


def test_noise_level_matches_jax(ref):
    """The ``noise_level`` perturbation of the features with JAX's draws fed
    in: JAX's `_prepare_fragment` splits the fragment's key, perturbs with
    the first half and draws the c-branch noise from the second."""
    cfg = Config(Config._wrap(scene_cfg(ref["root"], "unused", noise_level=0.1)))
    ds = __import__("cdsegnet_torch.data.datasets", fromlist=["x"]).build_dataset(
        dict(cfg.data.test))
    jtester = JTester(cfg, model=object())
    tester = SemSegTester(cfg, model=port_model(ref["variables"]), device="cpu")
    frags = ds.get(1, np.random.default_rng(0))["fragment_list"][:3]
    key = jax.random.PRNGKey(7)
    for index, frag in enumerate(frags):
        key, rng = jax.random.split(key)
        bucket, n_frag, batch, noise, _ = jtester._prepare_fragment(frag, rng)
        feat_rng, _ = jax.random.split(rng)
        draw = np.array(jax.random.normal(feat_rng, batch["feat"].shape))
        shapes = []

        def feat_noise_fn(i, shape):
            shapes.append((i, shape))
            return draw

        got_n, point, got_noise = tester._prepare_fragment(
            frag, index, lambda i, b, c: noise, feat_noise_fn)
        assert shapes == [(index, batch["feat"].shape)]
        assert (got_n, point.num_points) == (n_frag, bucket)
        # valid rows: both packages zero the padding rows' features after
        np.testing.assert_allclose(point.feat.numpy()[:n_frag], batch["feat"][:n_frag],
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got_noise.numpy(), noise)
        clean = tcollate_scenes([frag], bucket, 1)["feat"][:n_frag]
        assert np.abs(point.feat.numpy()[:n_frag] - clean).max() > 0.05  # perturbed
    with pytest.raises(ValueError, match="feat_noise_fn gave shape"):
        tester._prepare_fragment(frags[0], 0, None, lambda i, s: np.zeros((1, 6)))


@pytest.mark.parametrize("dataset_type,name", [
    ("ScanNetDataset", "scene0000_00"), ("ScanNet200Dataset", "scene0001_00"),
    ("SemanticKITTIDataset", "08_000123"), ("NuScenesDataset", "tok3")])
def test_write_submission_matches_jax(tmp_path, dataset_type, name):
    class Dataset:
        class2id = np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28,
                             33, 34, 36, 39])
        learning_map_inv = {-1: -1, 0: 10, 1: 11, 2: 15, 3: 18, 4: 20}

    pred = np.random.RandomState(0).randint(0, 5, 777)
    files = {}
    for side in ("jax", "port"):
        cfg = Config(Config._wrap(scene_cfg("unused", str(tmp_path / side))))
        cfg.data.test["type"] = dataset_type
        t = (JTester(cfg, model=object()) if side == "jax" else
             SemSegTester(cfg, model=tbuild(copy.deepcopy(TINY_MODEL), device="cpu"),
                          device="cpu"))
        t.write_submission(Dataset(), name, pred)
        base = tmp_path / side / "submit"
        files[side] = {str(p.relative_to(base)): p.read_bytes()
                       for p in sorted(base.rglob("*")) if p.is_file()}
    assert files["port"] == files["jax"] and len(files["jax"]) == 1


def test_checkpoint_round_trip(tmp_path):
    model = tbuild(copy.deepcopy(TINY_MODEL), device="cpu")
    opt = build_optimizer(dict(type="AdamW", lr=1e-3, weight_decay=0.01), model,
                          device="cpu")
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    gens = make_generators(3, torch.device("cpu"))
    mgr = CheckpointManager(str(tmp_path / "model"), keep_last=2)
    assert mgr.restore_raw() is None and not mgr.has()
    for epoch in range(1, 6):
        mgr.save_epoch(snapshot(model, step=10 * epoch, optimizer=opt, generators=gens),
                       epoch, is_best=epoch == 3, save_snapshot=True)
    assert sorted(os.listdir(mgr.ckpt_dir)) == ["epoch_4", "epoch_5", "model_best",
                                                "model_last"]
    with pytest.raises(FileExistsError):
        mgr.save(snapshot(model), "model_last", overwrite=False)
    want_draw = {k: torch.rand(4, generator=g) for k, g in gens.items()}

    other = tbuild(copy.deepcopy(TINY_MODEL), device="cpu",
                   generator=torch.Generator().manual_seed(9))
    other_opt = build_optimizer(dict(type="AdamW", lr=1e-3, weight_decay=0.01), other,
                                device="cpu")
    other_gens = make_generators(11, torch.device("cpu"))
    state = mgr.restore(other, "model_last", optimizer=other_opt, generators=other_gens)
    assert state["step"] == 50
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    assert other_opt.count == opt.count == 1
    for a, b in zip(opt.opt.state.values(), other_opt.opt.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for k, g in other_gens.items():
        assert torch.equal(torch.rand(4, generator=g), want_draw[k])
    assert mgr.restore_raw("model_best")["step"] == 30
    assert mgr.restore(other, "epoch_1") is None


def cli_args(root, save, *extra):
    return ["--config-file", TINY_CONFIG, "--checkpoint", "model_last", "--options",
            f"save_path={save}", f"data.test={dict(TEST_DATA, data_root=root)!r}",
            "test_buckets=[512]", "submission=True", *extra]


def test_cli_runs_end_to_end_on_the_cpu(ref, tmp_path):
    save = str(tmp_path / "cli")
    cfg = Config.fromfile(TINY_CONFIG)
    model = tbuild(dict(cfg.model), device="cpu")
    CheckpointManager(os.path.join(save, "model")).save(snapshot(model, step=5))
    tester = ttool.main(cli_args(ref["root"], save, "--device", "cpu"))
    names = sorted(tester.records)
    assert names == ["scene0000", "scene0001"]
    for name in names:
        pred = np.load(os.path.join(save, "result", f"{name}_pred.npy"))
        assert pred.shape == (300,) and pred.min() >= 0 and pred.max() < 5
        lines = open(os.path.join(save, "submit", f"{name}.txt")).read().split()
        assert len(lines) == 300
    assert all(0.0 <= v <= 1.0 for v in tester.result.values())
    for k, v in model.state_dict().items():  # the checkpoint's weights
        assert torch.equal(tester.model.state_dict()[k], v), k
    with pytest.raises(FileNotFoundError):
        ttool.main(cli_args(ref["root"], save, "--device", "cpu", "--checkpoint",
                            "model_best"))


def test_tester_and_cli_refuse_the_cpu_unless_asked(ref, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(Config._wrap(scene_cfg(ref["root"], str(tmp_path))))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SemSegTester(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttool.main(cli_args(ref["root"], str(tmp_path)))
    assert SemSegTester(cfg, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("change,error", [
    # the DDIM modes are ported: an unknown mode, or a DDIM mode on a model
    # without the diffusion wrapper, is refused
    pytest.param(dict(inference_mode="DDPM"), ValueError, id="change0"),
    pytest.param(dict(inference_mode="MSFI", model=dict(
        type="DefaultSegmentor", backbone=dict(TINY_MODEL["backbone"], condition=False))),
        ValueError, id="change1"),
    # fragment-parallel testing is ported: num_devices=2 without a process
    # group is refused
    pytest.param(dict(num_devices=2), RuntimeError, id="change2")])
def test_unported_tester_paths_raise(change, error, tmp_path):
    cfg = Config(Config._wrap(scene_cfg("unused", str(tmp_path), **change)))
    with pytest.raises(error):
        SemSegTester(cfg, device="cpu")
