"""The shape tasks in the port against the JAX package: `ModelNetDataset`
and `ShapeNetPartDataset` through the shipped configs' pipelines (array for
array), `ClsTester` and `PartSegTester` (records, probabilities, results
and log lines), `ClsEvaluator` and `SemSegEvaluator`'s ``origin_coord``
remap on stub trainers, and the two shape configs at a test width through
the training and testing CLIs in a subprocess. The trees are
`utils.synthetic`'s, small; weights are made with numpy from a seed and
carried across with `load_jax_variables`."""

import copy
import logging
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from cdsegnet_tpu.data import collate as jcollate  # noqa: E402
from cdsegnet_tpu.data import datasets as jdatasets  # noqa: E402
from cdsegnet_tpu.data import loader as jloader  # noqa: E402
from cdsegnet_tpu.data import native as jnative  # noqa: E402
from cdsegnet_tpu.engine import events as jevents  # noqa: E402
from cdsegnet_tpu.engine import hooks as jhooks  # noqa: E402
from cdsegnet_tpu.engine import test as jtest  # noqa: E402
from cdsegnet_tpu.engine.state import TrainState  # noqa: E402
from cdsegnet_tpu.engine.state import batch_to_point as jbatch_to_point  # noqa: E402
from cdsegnet_tpu.models.builder import build_model as jbuild  # noqa: E402
from cdsegnet_torch.data import collate as tcollate  # noqa: E402
from cdsegnet_torch.data import datasets as tdatasets  # noqa: E402
from cdsegnet_torch.data import loader as tloader  # noqa: E402
from cdsegnet_torch.engine import events as tevents  # noqa: E402
from cdsegnet_torch.engine import hooks as thooks  # noqa: E402
from cdsegnet_torch.engine.config import Config  # noqa: E402
from cdsegnet_torch.engine.state import make_eval_step  # noqa: E402
from cdsegnet_torch.engine.test import TESTERS  # noqa: E402
from cdsegnet_torch.models.builder import build_model as tbuild  # noqa: E402
from cdsegnet_torch.utils.synthetic import write_modelnet, write_shapenet_part  # noqa: E402
from cdsegnet_torch.utils.weights import load_jax_variables  # noqa: E402
from test_torch_model import as_numpy, random_variables  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLS_CONFIG = os.path.join(REPO, "configs", "modelnet40", "cls_ptv2.py")
PART_CONFIG = os.path.join(REPO, "configs", "shapenetpart", "partseg_ptv2.py")
DEPTH = 12  # the runtime's serialization depth
BUCKET = 2048  # the testers' and the evaluators' bucket
CLS_LINES = ("Cls result",)
PART_LINES = ("Test [", "Category ", "PartSeg result")
TINY = dict(patch_embed_channels=8, patch_embed_groups=2, enc_channels=(8, 16, 16, 16),
            enc_depths=(1, 1, 1, 1), enc_groups=(2, 4, 4, 4), dec_channels=(8, 8, 16, 16),
            dec_groups=(2, 2, 4, 4), k_neighbors=8)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("shapes")
    mn, sp = str(root / "modelnet40"), str(root / "shapenet_part")
    write_modelnet(mn, dict(train=8, test=6), num_points=1500, seed=1)
    write_shapenet_part(sp, dict(train=8, val=3, test=4), num_points=600, seed=2)
    return dict(modelnet=mn, shapenet=sp)


def shape_cfg(path, root, **extra):
    """The shipped config on ``root`` with the tiny backbone: a classifier
    over 8 backbone classes (JAX cannot build feature mode) or the part
    segmentor; seeds and buckets for the CPU."""
    cfg = Config.fromfile(path)
    for split in ("train", "val", "test"):
        cfg.data[split]["data_root"] = root
    bb = dict(cfg.model.backbone, **TINY)
    if cfg.model.type == "DefaultClassifier":
        bb["num_classes"] = 8
    cfg.model["backbone"] = bb
    cfg.merge_from_dict(dict(seed=7, test_buckets=(BUCKET,), val_num_points=BUCKET, **extra))
    return cfg


class Log:
    """A logger that keeps its lines."""

    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(("info", msg))

    def warning(self, msg):
        self.lines.append(("warning", msg))


class Capture(logging.Handler):
    """The messages of logger ``name`` that start with one of ``prefixes``
    (the JAX testers share one logger)."""

    def __init__(self, name, prefixes):
        super().__init__()
        self.lines = []
        self.prefixes = prefixes
        self.logger = logging.getLogger(name)

    def emit(self, record):
        if record.getMessage().startswith(self.prefixes):
            self.lines.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


def jax_state(jm, point):
    v = random_variables(jm, point)
    return v, TrainState.create(v, optax.identity(), jax.random.PRNGKey(0))


def empty_point(n, c):
    from cdsegnet_tpu.models.structure import make_point_batch as jmake

    return jmake(coord=jnp.zeros((n, 3)), feat=jnp.zeros((n, c)),
                 grid_coord=jnp.zeros((n, 3), jnp.int32), batch=jnp.zeros((n,), jnp.int32),
                 mask=jnp.zeros((n,), bool).at[:300].set(True),
                 segment=jnp.zeros((n,), jnp.int32), depth=DEPTH, num_scenes=1)


# ---- the datasets ----

PIPELINES = [("modelnet", "train"), ("modelnet", "val"), ("modelnet", "test"),
             ("shapenet", "train"), ("shapenet", "val"), ("shapenet", "test")]


def assert_same(got, want, where=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


@pytest.mark.parametrize("name,split", PIPELINES)
def test_dataset_pipelines_match_jax(trees, name, split, monkeypatch):
    """Every shape of the split through the shipped config's pipeline,
    with one numpy generator per package: the same arrays (the test split
    of ShapeNetPart as fragments with their ``index`` and the shape's
    ``category``)."""
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", True)
    path = CLS_CONFIG if name == "modelnet" else PART_CONFIG
    cfg = dict(shape_cfg(path, trees[name]).data[split])
    jds, tds = jdatasets.build_dataset(copy.deepcopy(cfg)), tdatasets.build_dataset(cfg)
    assert len(tds) == len(jds) > 0
    if name == "shapenet":
        assert tds.categories == jds.categories and len(tds.categories) == 16
        assert tds.category2part == jds.category2part
    jr, tr = np.random.default_rng(3), np.random.default_rng(3)
    for i in range(len(jds)):
        want, got = jds.get(i, jr), tds.get(i, tr)
        assert_same(got, want, f"{name}/{split}/{i}")
        assert tds.get_data_name(i) == jds.get_data_name(i)


# ---- the testers ----

def _jax_cls(cfg):
    jm = jbuild(copy.deepcopy(dict(cfg.model)))
    v, state = jax_state(jm, empty_point(BUCKET, 3))
    tester = jtest.ClsTester(cfg, state=state, model=jm)
    logits = []
    infer = tester._infer_fn
    tester._infer_fn = lambda n: (lambda vv, b: logits.append(np.asarray(infer(n)(vv, b)))
                                  or logits[-1])
    with Capture("cdsegnet_tpu.test", CLS_LINES) as cap:
        acc = tester.test()
    return dict(variables=as_numpy(v), logits=logits, acc=acc, lines=cap.lines)


def _jax_part(cfg):
    jm = jbuild(copy.deepcopy(dict(cfg.model)))
    v, state = jax_state(jm, empty_point(BUCKET, 6))
    tester = jtest.PartSegTester(cfg, state=state, model=jm)
    probs = []
    predict = tester.predict_fragment
    tester.predict_fragment = lambda frag, rng: probs.append(predict(frag, rng)) or probs[-1]
    with Capture("cdsegnet_tpu.test", PART_LINES) as cap:
        miou = tester.test()
    return dict(variables=as_numpy(v), probs=probs, miou=miou, lines=cap.lines)


def _jax_cls_eval(cfg):
    jm = jbuild(copy.deepcopy(dict(cfg.model)))
    v, state = jax_state(jm, empty_point(BUCKET, 3))
    tr = types.SimpleNamespace(
        cfg=cfg, epoch=0, model=jm, state=state, logger=Log(), comm_info={},
        storage=jevents.EventStorage(),
        val_loader=jloader.EvalLoader(jdatasets.build_dataset(dict(cfg.data.val)),
                                      num_points=BUCKET))
    hook = jhooks.ClsEvaluator()
    hook.trainer = tr
    hook.after_epoch()
    return dict(variables=as_numpy(v), lines=tr.logger.lines, comm_info=tr.comm_info,
                acc=tr.storage.histories["val/allAcc"].latest)


def remap_loader(root, collate):
    """Val scenes with ``origin_coord``: each ShapeNetPart val shape's every
    other point collated as the sampled scene, every point as the origin."""
    ds = tdatasets.build_dataset(dict(type="ShapeNetPartDataset", split="val",
                                      data_root=root, transform=[]))
    out = []
    for i in range(len(ds)):
        d = ds.get(i, np.random.default_rng(0))
        s = dict(coord=d["coord"][::2], grid_coord=np.floor(d["coord"][::2] / 0.01)
                 .astype(np.int32) + 200, segment=d["segment"][::2],
                 feat=np.concatenate([d["coord"], d["normal"]], 1)[::2])
        scene = dict(s, origin_coord=d["coord"], origin_segment=d["segment"])
        out.append((collate([s], BUCKET, 1), scene))
    return out


def _jax_remap(cfg):
    jm = jbuild(copy.deepcopy(dict(cfg.model)))
    v, state = jax_state(jm, empty_point(BUCKET, 6))
    infer = jax.jit(lambda vv, b: jm.apply(vv, jbatch_to_point(b, DEPTH, 1),
                                           train=False)["n_pred"])
    tr = types.SimpleNamespace(
        cfg=cfg, epoch=0, logger=Log(), comm_info={}, state=state,
        storage=jevents.EventStorage(),
        eval_step=lambda st, b, rng: dict(seg_logits=infer(
            {"params": st.params, "batch_stats": st.batch_stats}, b)),
        val_loader=remap_loader(cfg.data.val.data_root, jcollate.collate_scenes))
    hook = jhooks.SemSegEvaluator()
    hook.trainer = tr
    hook.after_epoch()
    return dict(variables=as_numpy(v), lines=tr.logger.lines, comm_info=tr.comm_info)


@pytest.fixture(scope="module")
def jref(trees):
    """The JAX testers and evaluators."""
    jobs = dict(cls=(_jax_cls, shape_cfg(CLS_CONFIG, trees["modelnet"])),
                part=(_jax_part, shape_cfg(PART_CONFIG, trees["shapenet"])),
                cls_eval=(_jax_cls_eval, shape_cfg(CLS_CONFIG, trees["modelnet"],
                                                   serialization_depth=DEPTH)),
                remap=(_jax_remap, shape_cfg(PART_CONFIG, trees["shapenet"])))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB", None)
        mp.setattr(jnative, "_TRIED", True)
        return {k: dict(fn(cfg), cfg=cfg) for k, (fn, cfg) in jobs.items()}


def port_model(ref):
    m = tbuild(copy.deepcopy(dict(ref["cfg"].model)), device="cpu")
    load_jax_variables(m, ref["variables"])
    return m


def softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def test_cls_tester_matches_jax(jref, monkeypatch):
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", True)
    r = jref["cls"]
    tester = TESTERS.build(dict(type="ClsTester", verbose=True), cfg=r["cfg"],
                           model=port_model(r), device="cpu")
    with Capture("cdsegnet_torch.test", CLS_LINES) as cap:
        acc = tester.test()
    assert acc == r["acc"] and cap.lines == r["lines"]
    assert len(tester.records) == len(r["logits"]) == 6
    for rec, logits in zip(tester.records.values(), r["logits"]):
        want = softmax(logits[0])
        np.testing.assert_allclose(rec["probs"], want, atol=1e-4)
        assert rec["pred"] == int(logits[0].argmax())
    assert [rec["label"] for rec in tester.records.values()] == [0, 1, 2, 3, 4, 5]
    assert tester.result["allacc"] == acc and 0.0 <= tester.result["macc"] <= 1.0


def test_partseg_tester_matches_jax(jref, monkeypatch):
    """Per-fragment probabilities within 1e-4, the shapes' part IoUs, the
    category lines and the instance mIoU as JAX logs and returns them."""
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", True)
    r = jref["part"]
    tester = TESTERS.build(dict(type="PartSegTester", verbose=True), cfg=r["cfg"],
                           model=port_model(r), device="cpu")
    probs = []
    predict = tester.predict_fragment
    monkeypatch.setattr(tester, "predict_fragment",
                        lambda *a: probs.append(predict(*a)) or probs[-1])
    with Capture("cdsegnet_torch.test", PART_LINES) as cap:
        miou = tester.test()
    assert len(probs) == len(r["probs"]) >= 4
    for got, want in zip(probs, r["probs"]):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    assert cap.lines == r["lines"]
    assert miou == pytest.approx(r["miou"], abs=1e-12)
    assert len(tester.records) == 4
    for rec in tester.records.values():
        assert rec["iou"] == pytest.approx(rec["parts_iou"].mean())
    assert set(tester.result) == {"ins_miou", "cat_miou"}


def test_shape_testers_refuse_several_ranks(jref, monkeypatch):
    from cdsegnet_torch.parallel import dist

    monkeypatch.setattr(dist, "world_size", lambda: 2)
    for kind in ("ClsTester", "PartSegTester"):
        with pytest.raises(NotImplementedError, match="more than one rank"):
            TESTERS.build(dict(type=kind), cfg=jref["cls"]["cfg"], device="cpu")


# ---- the evaluators ----

def port_trainer(ref, val_loader):
    model = port_model(ref)
    return types.SimpleNamespace(
        cfg=ref["cfg"], epoch=0, seed=7, model=model, device=torch.device("cpu"),
        eval_step=make_eval_step(model, DEPTH, 1, "cpu"), logger=Log(), comm_info={},
        storage=tevents.EventStorage(), val_loader=val_loader)


def test_cls_evaluator_matches_jax(jref, monkeypatch):
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", True)
    r = jref["cls_eval"]
    tr = port_trainer(r, tloader.EvalLoader(
        tdatasets.build_dataset(dict(r["cfg"].data.val)), num_points=BUCKET))
    hook = thooks.ClsEvaluator()
    hook.trainer = tr
    hook.after_epoch()
    assert tr.logger.lines == r["lines"]
    assert tr.comm_info == r["comm_info"]
    assert tr.comm_info["current_metric_name"] == "allAcc"
    assert tr.storage.histories["val/allAcc"].latest == r["acc"]
    inter, pred, target = hook.histograms
    assert target.sum() == pred.sum() == 6 and (inter <= target).all()


def test_semseg_evaluator_remaps_origin_coord_as_jax(jref):
    """Val scenes with ``origin_coord``: predictions carried to every
    original point by 1-NN (`knn_remap_labels`), scored against
    ``origin_segment``; the same log lines and mIoU as JAX."""
    r = jref["remap"]
    tr = port_trainer(r, remap_loader(r["cfg"].data.val.data_root,
                                      tcollate.collate_scenes))
    hook = thooks.SemSegEvaluator()
    hook.trainer = tr
    hook.after_epoch()
    assert tr.logger.lines == r["lines"]
    assert tr.comm_info == r["comm_info"]
    n_origin = sum(len(s["origin_segment"]) for _, s in tr.val_loader)
    assert hook.histograms[2].sum() == n_origin  # every original point scored


# ---- the CLIs ----

CLI_SCRIPT = """
import sys
from cdsegnet_torch.tools import test, train
cfg, save = sys.argv[1], sys.argv[2]
train.main(["--config-file", cfg, "--device", "cpu", "--options", "save_path=" + save])
t = test.main(["--config-file", cfg, "--device", "cpu", "--checkpoint", "model_last",
               "--options", "save_path=" + save])
print("RESULT", type(t).__name__, t.result)
"""


@pytest.mark.parametrize("name", ["modelnet", "shapenet"])
def test_shape_configs_train_and_test_through_the_clis(trees, name, tmp_path):
    """The shipped config at a test width (the classifier's backbone in
    feature mode, as shipped), 2 evaluated epochs of 2 steps, each logged,
    evaluated by the config's evaluator and checkpointed, then its tester
    on ``model_last``."""
    base = CLS_CONFIG if name == "modelnet" else PART_CONFIG
    bb = dict(TINY)
    lines = [f"_base_ = [{base!r}]", f"model = dict(backbone={bb!r}"
             + (", backbone_embed_dim=8)" if name == "modelnet" else ")"),
             "epoch = 2", "eval_epoch = 2", "seed = 3", "scenes_per_device = 4",
             f"bucket_num_points = {4 * (1024 if name == 'modelnet' else 2560)}",
             f"val_num_points = {BUCKET}", f"test_buckets = ({BUCKET},)",
             f"data = dict(train=dict(data_root={trees[name]!r}), val=dict(data_root="
             f"{trees[name]!r}), test=dict(data_root={trees[name]!r}))"]
    evaluator = "ClsEvaluator" if name == "modelnet" else "SemSegEvaluator"
    lines.append("hooks = [dict(type='CheckpointLoader'), dict(type='IterationTimer'), "
                 "dict(type='InformationWriter', log_interval=1), "
                 f"dict(type={evaluator!r}), dict(type='CheckpointSaver', save_freq=1)]")
    cfg = tmp_path / "cfg.py"
    cfg.write_text("\n".join(lines) + "\n")
    save = str(tmp_path / "run")
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", CLI_SCRIPT, str(cfg), save], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert sorted(os.listdir(os.path.join(save, "model"))) == [
        "epoch_1", "epoch_2", "model_best", "model_last"]
    log = open(os.path.join(save, "train.log")).read()
    assert "Train [2/2][2/2] loss" in log
    result = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT")][0]
    if name == "modelnet":
        assert "Val result: mIoU" in log and "allAcc" in log
        assert result.startswith("RESULT ClsTester {'allacc'")
    else:
        assert "Val result: mIoU" in log
        assert result.startswith("RESULT PartSegTester {'ins_miou'")
