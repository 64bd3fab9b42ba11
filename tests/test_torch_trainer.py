"""Port trainer against the JAX package: `SemSegEvaluator` with the same
weights and noise, the device histograms, the overflow warning, checkpoint
saving, the schedule of `configs/scannet/cdsegnet.py`, the metric and event
files, `RuntimeProfiler`'s window and its trace summary; then the port
alone: a resumed run equals an uninterrupted one bit for bit, the training
CLI end to end on the CPU, and the device and configuration rules. JAX's
hooks run on stub trainers: no JAX train step is compiled."""

import copy
import glob
import gzip
import json
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

from cdsegnet_tpu.data import datasets as jdatasets  # noqa: E402
from cdsegnet_tpu.data import loader as jloader  # noqa: E402
from cdsegnet_tpu.data import native as jnative  # noqa: E402
from cdsegnet_tpu.engine import events as jevents  # noqa: E402
from cdsegnet_tpu.engine import hooks as jhooks  # noqa: E402
from cdsegnet_tpu.engine import profiling as jprofiling  # noqa: E402
from cdsegnet_tpu.engine.checkpoint import CheckpointManager as JManager  # noqa: E402
from cdsegnet_tpu.engine.optimizer import onecycle_schedule as jonecycle  # noqa: E402
from cdsegnet_tpu.engine.state import TrainState  # noqa: E402
from cdsegnet_tpu.engine.state import batch_to_point as jbatch_to_point  # noqa: E402
from cdsegnet_tpu.engine.train import Trainer as JTrainer  # noqa: E402
from cdsegnet_tpu.models.builder import build_model as jbuild  # noqa: E402
from cdsegnet_tpu.models.segmentor import CNFSegmentor as JCNF  # noqa: E402
from cdsegnet_tpu.models.structure import make_point_batch as jmake  # noqa: E402
from cdsegnet_tpu.utils import misc as jmisc  # noqa: E402
from cdsegnet_tpu.utils import tbwriter as jtb  # noqa: E402
from cdsegnet_torch.data import datasets as tdatasets  # noqa: E402
from cdsegnet_torch.data import loader as tloader  # noqa: E402
from cdsegnet_torch.engine import events as tevents  # noqa: E402
from cdsegnet_torch.engine import hooks as thooks  # noqa: E402
from cdsegnet_torch.engine import profiling as tprofiling  # noqa: E402
from cdsegnet_torch.engine.checkpoint import CheckpointManager  # noqa: E402
from cdsegnet_torch.engine.config import Config  # noqa: E402
from cdsegnet_torch.engine.state import make_eval_step  # noqa: E402
from cdsegnet_torch.engine.train import DEFAULT_HOOKS, TRAINERS, Trainer  # noqa: E402
from cdsegnet_torch.models.builder import build_model as tbuild  # noqa: E402
from cdsegnet_torch.tools import train as ttrain  # noqa: E402
from cdsegnet_torch.utils import misc as tmisc  # noqa: E402
from cdsegnet_torch.utils import tbwriter as ttb  # noqa: E402
from cdsegnet_torch.utils.weights import load_jax_variables  # noqa: E402
from test_engine import _write_synthetic_dataset  # noqa: E402
from test_model import TINY_MODEL  # noqa: E402
from test_torch_model import as_numpy, random_variables  # noqa: E402
from test_torch_tester import TEST_DATA  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(REPO, "configs", "scannet", "cdsegnet.py")
TINY_CONFIG = os.path.join(REPO, "configs", "_smoke_", "cdsegnet_tiny.py")
DEPTH = 7
VAL_POINTS = 512
TRANSFORM = [
    dict(type="GridSample", grid_size=0.05, hash_type="fnv", mode="train",
         return_grid_coord=True),
    dict(type="NormalizeColor"),
    dict(type="Collect", keys=("coord", "grid_coord", "segment"),
         feat_keys=("color", "normal")),
]


class Log:
    """A logger that keeps its lines."""

    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(("info", msg))

    def warning(self, msg):
        self.lines.append(("warning", msg))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Four train and two val scenes of 400 points (`tests/test_engine.py`)."""
    r = str(tmp_path_factory.mktemp("trainer") / "data")
    _write_synthetic_dataset(r)
    return r


def trainer_cfg(root, save, **extra):
    """The JAX engine test's trainer config (`tests/test_engine.py`)."""
    cfg = dict(
        save_path=save, seed=0, num_devices=1, scenes_per_device=2,
        bucket_num_points=1024, val_num_points=VAL_POINTS,
        serialization_depth=DEPTH, mix_prob=0.5, epoch=2, resume=False,
        model=dict(copy.deepcopy(TINY_MODEL), T=20, criteria=[
            dict(type="MSELoss", loss_weight=1.0),
            dict(type="CrossEntropyLoss", loss_weight=1.0),
            dict(type="LovaszLoss", loss_weight=1.0)], loss_type="GLS", task_num=2),
        optimizer=dict(type="AdamW", lr=1e-3, weight_decay=0.01),
        scheduler=dict(type="OneCycleLR", pct_start=0.3),
        param_dicts=[dict(keyword="block", lr=1e-4)],
        data=dict(num_classes=5, ignore_index=-1, names=[f"c{i}" for i in range(5)],
                  train=dict(type="ScanNetDataset", split="train", data_root=root,
                             transform=TRANSFORM, test_mode=False),
                  val=dict(type="ScanNetDataset", split="val", data_root=root,
                           transform=TRANSFORM, test_mode=False)))
    cfg.update(extra)
    return Config(Config._wrap(cfg))


# ---- the evaluator against JAX's ----

@pytest.fixture(scope="module")
def jeval(root):
    """JAX's `SemSegEvaluator` on a stub trainer over the two val scenes:
    its eval step takes numpy noise; the histograms of every scene, the log
    lines, `comm_info` and the stored mIoU."""
    model = jbuild(copy.deepcopy(TINY_MODEL))
    point = jmake(coord=jnp.zeros((VAL_POINTS, 3)), feat=jnp.zeros((VAL_POINTS, 6)),
                  grid_coord=jnp.zeros((VAL_POINTS, 3), jnp.int32),
                  batch=jnp.zeros((VAL_POINTS,), jnp.int32),
                  mask=jnp.zeros((VAL_POINTS,), bool).at[:300].set(True),
                  segment=jnp.zeros((VAL_POINTS,), jnp.int32), depth=DEPTH, num_scenes=1)
    variables = random_variables(model, point)
    noise = [np.random.RandomState(20 + i).randn(VAL_POINTS, 6).astype(np.float32)
             for i in range(2)]
    infer = jax.jit(lambda v, b, nz: model.apply(
        v, jbatch_to_point(b, DEPTH, 1), nz, method=JCNF.inference)["seg_logits"])
    calls = iter(noise)

    def eval_step(state, batch, rng):
        v = {"params": state.params, "batch_stats": state.batch_stats}
        return dict(seg_logits=infer(v, batch, jnp.asarray(next(calls))))

    hists = []

    def recorded(*args):
        out = jmisc.intersection_and_union_jnp(*args)
        hists.append([np.asarray(x) for x in out])
        return out

    cfg = trainer_cfg(root, "unused")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB", None)
        mp.setattr(jnative, "_TRIED", True)
        mp.setattr(jhooks, "intersection_and_union_jnp", recorded)
        tr = types.SimpleNamespace(
            cfg=cfg, epoch=0, eval_step=eval_step, logger=Log(), comm_info={},
            state=TrainState.create(variables, optax.identity(), jax.random.PRNGKey(0)),
            storage=jevents.EventStorage(),
            val_loader=jloader.EvalLoader(jdatasets.build_dataset(dict(cfg.data.val)),
                                          num_points=VAL_POINTS))
        hook = jhooks.SemSegEvaluator()
        hook.trainer = tr
        hook.after_epoch()
    return dict(variables=variables, noise=noise, hists=hists, lines=tr.logger.lines,
                comm_info=tr.comm_info, miou=tr.storage.histories["val/mIoU"].latest)


def port_eval_trainer(cfg, model, epoch=0):
    """A stub trainer with what the port's evaluator reads."""
    return types.SimpleNamespace(
        cfg=cfg, epoch=epoch, seed=0, model=model, device=torch.device("cpu"),
        eval_step=make_eval_step(model, DEPTH, 1, "cpu"), logger=Log(), comm_info={},
        storage=tevents.EventStorage(),
        val_loader=tloader.EvalLoader(tdatasets.build_dataset(dict(cfg.data.val)),
                                      num_points=VAL_POINTS))


def test_semseg_evaluator_matches_jax(jeval, root, monkeypatch):
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", True)
    hists = []

    def recorded(*args):
        out = tmisc.intersection_and_union_torch(*args)
        hists.append([x.numpy() for x in out])
        return out

    monkeypatch.setattr(thooks, "intersection_and_union_torch", recorded)
    model = tbuild(copy.deepcopy(TINY_MODEL), device="cpu")
    load_jax_variables(model, as_numpy(jeval["variables"]))
    calls = []

    def noise_fn(index, bucket, c_in):
        calls.append((index, bucket, c_in))
        return jeval["noise"][index]

    tr = port_eval_trainer(trainer_cfg(root, "unused"), model)
    hook = thooks.SemSegEvaluator(noise_fn=noise_fn)
    hook.trainer = tr
    hook.after_epoch()
    assert calls == [(0, VAL_POINTS, 6), (1, VAL_POINTS, 6)]
    assert len(hists) == len(jeval["hists"]) == 2
    for got, want in zip(hists, jeval["hists"]):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[2].sum() > 200  # the scene's labelled points were counted
    assert tr.logger.lines == jeval["lines"]
    assert tr.comm_info == jeval["comm_info"]
    assert tr.storage.histories["val/mIoU"].latest == jeval["miou"]
    assert 0.0 <= jeval["miou"] <= 1.0

    # without noise_fn: drawn from a generator seeded with seed + epoch
    runs = []
    for epoch in (3, 3, 4):
        tr = port_eval_trainer(trainer_cfg(root, "unused"), model, epoch)
        hook = thooks.SemSegEvaluator()
        hook.trainer = tr
        hook.after_epoch()
        runs.append(tr.logger.lines)
    assert runs[0] == runs[1] and len(runs[0]) == 6


def test_histograms_match_jax():
    rng = np.random.RandomState(6)
    k = 7
    pred = rng.randint(0, k, 3000)
    target = rng.randint(-1, k, 3000)
    target[:50] = -100  # other ignore values
    valid = rng.rand(3000) < 0.8
    got = tmisc.intersection_and_union_torch(torch.as_tensor(pred),
                                             torch.as_tensor(target), k,
                                             torch.as_tensor(valid))
    want = jmisc.intersection_and_union_jnp(jnp.asarray(pred), jnp.asarray(target), k,
                                            jnp.asarray(valid))
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the numpy histogram of the same valid, labelled points
    keep = valid & (target >= 0)
    i, u, t = tmisc.intersection_and_union(pred[keep], target[keep], k)
    for g, w in zip(got, (i, u, t)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_overflow_warning_matches_jax():
    seq = [dict(loss=1.0, valid_points=1000.0, dropped_l1=0, dropped_l2=1)]
    seq += [dict(loss=1.0, valid_points=1000.0, dropped_l1=d, dropped_l2=2 * d)
            for d in (0, 1, 2, 5, 40)]
    seq += [dict(loss=1.0, valid_points=5000.0, dropped_l1=6, dropped_l3=9)] * 6
    logs = {}
    for name, cls in (("jax", JTrainer), ("port", Trainer)):
        stub = types.SimpleNamespace(logger=Log())
        for m in seq:
            cls._warn_on_overflow(stub, m)
        logs[name] = stub.logger.lines
    assert logs["port"] == logs["jax"]
    assert len(logs["port"]) == 5  # throttled, though more steps overflowed


def test_checkpoint_saver_matches_jax(tmp_path):
    metrics = [0.1, 0.3, 0.2, None, 0.5, 0.5, 0.4, 0.6]
    cfg = Config(save_freq_threshold=3)
    trs = {
        "jax": types.SimpleNamespace(
            cfg=cfg, logger=Log(), comm_info={}, state={"w": np.zeros(2, np.float32)},
            ckpt_manager=JManager(str(tmp_path / "jax"))),
        "port": types.SimpleNamespace(
            cfg=cfg, logger=Log(), comm_info={}, model=torch.nn.Linear(2, 1), step=0,
            optimizer=None, generators=None,
            ckpt_manager=CheckpointManager(str(tmp_path / "port"))),
    }
    hooks = {"jax": jhooks.CheckpointSaver(save_freq=2),
             "port": thooks.CheckpointSaver(save_freq=2)}
    for name, hook in hooks.items():
        hook.trainer = trs[name]
        hook.before_train()
    listing = []
    for epoch, metric in enumerate(metrics):
        for name, tr in trs.items():
            tr.epoch = epoch
            tr.comm_info.clear()
            if metric is not None:
                tr.comm_info.update(current_metric_value=metric,
                                    current_metric_name="mIoU")
            hooks[name].after_epoch()
        files = {n: sorted(os.listdir(tmp_path / n)) for n in trs}
        assert files["port"] == files["jax"], epoch
        listing.append(files["port"])
    assert listing[-1] == ["epoch_4", "epoch_6", "epoch_8", "model_best", "model_last"]
    assert trs["port"].logger.lines == trs["jax"].logger.lines
    assert CheckpointManager(str(tmp_path / "port")).restore_raw("model_best")["step"] == 0


def test_event_files_match_jax(tmp_path):
    data = bytes(range(256)) * 3
    assert ttb.crc32c(data) == jtb.crc32c(data)
    raw = {}
    for name, tb in (("jax", jtb), ("port", ttb)):
        w = tb.TBWriter(str(tmp_path / name))
        for step in range(3):
            w.add_scalar("loss", 1.5 / (step + 1), step, wall_time=1000.0 + step)
        w.close()
        (path,) = (tmp_path / name).iterdir()
        b = path.read_bytes()
        header = 8 + 4 + int.from_bytes(b[:8], "little") + 4  # wall time inside
        raw[name] = b[header:]
    assert raw["port"] == raw["jax"] and len(raw["port"]) > 0
    lines = {}
    for name, ev in (("jax", jevents), ("port", tevents)):
        s = ev.EventStorage(str(tmp_path / f"{name}_run"))
        for step in (10, 20):
            s.put_scalars(loss=0.5 + step, valid_points=798.0)
            s.write(step)
        s.close()
        recs = [json.loads(x) for x in open(tmp_path / f"{name}_run" / "metrics.jsonl")]
        lines[name] = [{k: v for k, v in r.items() if k != "time"} for r in recs]
    assert lines["port"] == lines["jax"] == [
        dict(step=10, loss=10.5, valid_points=798.0),
        dict(step=20, loss=20.5, valid_points=798.0)]


# ---- the schedule of the shipped config ----

def test_schedule_matches_jax_formulas(root):
    """``loop``, ``steps_per_epoch`` and ``total_steps`` of
    `configs/scannet/cdsegnet.py` (800 epochs as 100 evaluated x loop 8, two
    scenes per 204,800-slot bucket) on four train scenes, with the tiny model
    in place of the full one; each group's learning rate follows OneCycle
    over ``total_steps``."""
    cfg = Config.fromfile(SHIPPED)
    cfg.merge_from_dict({"model": trainer_cfg(root, "x").model, "save_path": "unused",
                         "data.train.data_root": root, "data.val.data_root": root,
                         "data.train.transform": TRANSFORM})
    cfg.save_path = str(root) + "_schedule"
    tr = Trainer(cfg, device="cpu")
    stub = types.SimpleNamespace(cfg=cfg, max_epoch=cfg.eval_epoch, mesh=None,
                                 microbatch=1)
    jl = JTrainer.build_train_loader(stub, 1, cfg.bucket_num_points)
    assert (tr.max_epoch, tr.train_ds.loop) == (100, 8) == (stub.max_epoch,
                                                            stub.train_ds.loop)
    assert tr.steps_per_epoch == len(jl) == 4 * 8 // 2
    assert tr.total_steps == len(jl) * stub.max_epoch == 1600
    assert tr.train_loader.num_points == jl.num_points == 204800
    assert tr.train_loader.mix_prob == jl.mix_prob == 0.8
    opt = tr.optimizer
    for count in list(range(0, 1600, 37)) + [799, 800, 1599, 1600]:
        opt.count = count
        lrs = opt.lrs()
        for group, lr in (("default", 0.002), ("group0", 0.0002)):
            want = float(jonecycle(lr, 1600, 0.5, 10.0, 1000.0)(count))
            np.testing.assert_allclose(lrs[group], want, rtol=1e-6, atol=1e-12)


# ---- resume, the CLI, the rules ----

class Stopped(Exception):
    pass


@thooks.HOOKS.register_module()
class StopAfterEpoch(thooks.HookBase):
    """Raises after the epoch's other hooks (an interrupted run)."""

    def __init__(self, epoch: int = 1):
        self.epoch = epoch

    def after_epoch(self):
        if self.trainer.epoch + 1 == self.epoch:
            raise Stopped(f"stopped after epoch {self.epoch}")


@thooks.HOOKS.register_module()
class RecordState(thooks.HookBase):
    """Keeps the learning rates each step used and where each epoch began."""

    def before_train(self):
        self.trainer.lrs, self.trainer.began = [], []

    def before_epoch(self):
        tr = self.trainer
        tr.began.append((tr.epoch, tr.step, tr.optimizer.count,
                         {k: g.get_state().clone() for k, g in tr.generators.items()}))

    def after_step(self):
        tr = self.trainer
        tr.lrs.append([g["lr"] for g in tr.optimizer.opt.param_groups])


def default_hooks(log_interval=10):
    """The default stack, InformationWriter writing every ``log_interval``
    steps."""
    out = copy.deepcopy(DEFAULT_HOOKS)
    out[2]["log_interval"] = log_interval
    return out


def hooks_with(*extra):
    return default_hooks() + [dict(type="RecordState"), *extra]


def test_resumed_run_equals_an_uninterrupted_one(root, tmp_path):
    """Two epochs in one run against one epoch, a stop, and a resume from
    `model_last`: parameters, running statistics, the optimizer's moments
    and count and the step's generators equal bit for bit."""
    whole = Trainer(trainer_cfg(root, str(tmp_path / "whole"), hooks=hooks_with()),
                    device="cpu")
    whole.train()
    save = str(tmp_path / "resumed")
    first = Trainer(trainer_cfg(root, save, hooks=hooks_with(dict(type="StopAfterEpoch"))),
                    device="cpu")
    with pytest.raises(Stopped):
        first.train()
    assert first.step == 2 and sorted(os.listdir(os.path.join(save, "model"))) == [
        "epoch_1", "model_best", "model_last"]
    second = Trainer(trainer_cfg(root, save, resume=True, hooks=hooks_with()),
                     device="cpu")
    second.train()
    # the resumed run began at epoch 1 with the state the whole run had there
    epoch, step, count, gens = second.began[0]
    assert (epoch, step, count, second.start_epoch) == (1, 2, 2, 1)
    w_epoch, w_step, _, w_gens = whole.began[1]
    assert (w_epoch, w_step) == (1, 2)
    for k in gens:
        assert torch.equal(gens[k], w_gens[k]), k
    assert second.lrs == whole.lrs[2:]
    # the final states, bit for bit
    assert whole.step == second.step == 4
    for (name, a), (name_b, b) in zip(whole.model.state_dict().items(),
                                      second.model.state_dict().items()):
        assert name == name_b and torch.equal(a, b), name
    ow, os_ = whole.optimizer.state_dict(), second.optimizer.state_dict()
    assert ow["count"] == os_["count"] == 4
    assert ow["opt"]["state"].keys() == os_["opt"]["state"].keys()
    for i, st in ow["opt"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, os_["opt"]["state"][i][k]), (i, k)
    for k, g in whole.generators.items():
        assert torch.equal(g.get_state(), second.generators[k].get_state()), k
    # the per-group learning rates followed OneCycle over total_steps
    assert whole.total_steps == 4
    for count, lrs in enumerate(whole.lrs):
        want = [float(jonecycle(lr, 4, 0.3)(count)) for lr in (1e-3, 1e-4)]
        np.testing.assert_allclose(lrs, want, rtol=1e-6)


def cli_options(root_test, save):
    hooks = default_hooks(1) + [dict(type="PreciseEvaluator")]
    return ["--options", f"save_path={save}", "epoch=2", f"hooks={hooks!r}",
            "test={'type': 'SemSegTester', 'verbose': True}", "test_buckets=[512]",
            f"data.test={dict(TEST_DATA, data_root=root_test)!r}"]


def test_cli_trains_the_tiny_config_on_the_cpu(tmp_path):
    data_root = Config.fromfile(TINY_CONFIG).data_root
    save = str(tmp_path / "run")
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "cdsegnet_torch.tools.train", "--config-file",
         TINY_CONFIG, *cli_options(data_root, save), "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert sorted(os.listdir(save)) == ["config.py", "metrics.jsonl", "model", "result",
                                        "tb", "train.log"]
    assert sorted(os.listdir(os.path.join(save, "model"))) == [
        "epoch_1", "epoch_2", "model_best", "model_last"]
    dumped = open(os.path.join(save, "config.py")).read()
    assert "'PreciseEvaluator'" in dumped and "'epoch': 2" in dumped
    log = open(os.path.join(save, "train.log")).read()
    assert "Train [2/2][2/2] loss" in log and "Val result: mIoU" in log
    recs = [json.loads(x) for x in open(os.path.join(save, "metrics.jsonl"))]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) for r in recs) and "val/mIoU" in recs[2]
    (tb,) = os.listdir(os.path.join(save, "tb"))
    assert os.path.getsize(os.path.join(save, "tb", tb)) > 200
    # PreciseEvaluator: the tester on model_best, a record per val scene
    assert sorted(os.listdir(os.path.join(save, "result"))) == [
        "scene0000_pred.npy", "scene0001_pred.npy"]
    assert "Test result: mIoU" in proc.stdout


def test_precise_evaluator_tests_model_best(root, tmp_path):
    save = str(tmp_path / "run")
    cfg = trainer_cfg(root, save, epoch=1, hooks=default_hooks(10) + [
        dict(type="PreciseEvaluator")], test=dict(type="SemSegTester"),
        test_buckets=[512], data=dict(trainer_cfg(root, save).data,
                                      test=dict(TEST_DATA, data_root=root)))
    tr = Trainer(cfg, device="cpu")
    tr.train()
    tester = tr.hooks[-1].tester
    assert sorted(tester.records) == ["scene0000", "scene0001"]
    best = CheckpointManager(os.path.join(save, "model")).restore_raw("model_best")
    for k, v in best["model"].items():
        assert torch.equal(tester.model.state_dict()[k], v), k


def test_trainer_and_cli_refuse_the_cpu_unless_asked(root, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = trainer_cfg(root, str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg)
    save = str(tmp_path / "cli")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--config-file", TINY_CONFIG, "--options", f"save_path={save}"])
    assert not os.path.exists(save)
    assert Trainer(cfg, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("change,match", [
    # more than one GPU and gradient accumulation are ported: num_devices=2
    # without a process group, or a microbatch that does not divide the
    # scenes, is refused
    pytest.param(dict(num_devices=2), "more than one GPU",
                 id="change0-more than one GPU"),
    pytest.param(dict(microbatch=3), "gradient accumulation",
                 id="change1-gradient accumulation")])
def test_unported_trainer_options_raise(root, tmp_path, change, match):
    cfg = trainer_cfg(root, str(tmp_path))
    cfg.merge_from_dict(change)
    error = {"more than one GPU": RuntimeError, "gradient accumulation": ValueError}[match]
    with pytest.raises(error, match=match):
        TRAINERS.build(dict(cfg.get("train", dict(type="DefaultTrainer"))), cfg=cfg,
                       device="cpu")


def test_val_condition_is_ignored_without_model_conditions(root, tmp_path):
    """A val dataset's ``condition`` names a PPT condition; JAX's trainer
    ignores it when the model has no ``conditions``
    (`cdsegnet_tpu/engine/train.py:135-142`), and so does the port: the
    trainer builds, and its evaluation step equals one without it."""
    cfg = trainer_cfg(root, str(tmp_path / "a"))
    cfg.data.val["condition"] = "ScanNet"
    tr = Trainer(cfg, device="cpu")
    plain = Trainer(trainer_cfg(root, str(tmp_path / "b")), device="cpu")
    batch, _ = next(iter(tr.val_loader))
    noise = torch.randn((batch["feat"].shape[0], 6), generator=torch.Generator().manual_seed(0))
    got = tr.eval_step(batch, noise=noise)["seg_logits"]
    want = plain.eval_step(batch, noise=noise)["seg_logits"]
    assert torch.equal(got, want)


class Window(thooks.HookBase):
    """Records, before and after each step, the update count and whether
    the profiler it follows is tracing."""

    def __init__(self, profiler):
        self.profiler, self.seen = profiler, []

    def before_step(self):
        self.seen.append(("before", self.trainer.step, self.profiler._prof is not None))

    def after_step(self):
        self.seen.append(("after", self.trainer.step, self.profiler._prof is not None))


def jax_window(wait, active, steps, monkeypatch):
    """JAX's `RuntimeProfiler` on a stub trainer: the update counts at
    which it starts and stops its trace, and those after each step it
    traced."""
    calls, traced = [], []
    monkeypatch.setattr(jprofiling.jax.profiler, "start_trace",
                        lambda d: calls.append(("start", int(tr.state.step))))
    monkeypatch.setattr(jprofiling.jax.profiler, "stop_trace",
                        lambda: calls.append(("stop", int(tr.state.step))))
    tr = types.SimpleNamespace(save_path="unused", state=types.SimpleNamespace(step=0),
                               logger=Log())
    hook = jprofiling.RuntimeProfiler(wait=wait, active=active, log_summary=False)
    hook.trainer = tr
    for _ in range(steps):
        hook.before_step()
        tr.state.step += 1
        hook.after_step()
        if hook._running:
            traced.append(int(tr.state.step))
    hook.after_train()
    return calls, traced


@pytest.mark.parametrize("wait,active", [(1, 2), (3, 5)])
def test_runtime_profiler_window_and_summary_match_jax(root, tmp_path, monkeypatch,
                                                       wait, active):
    """On the tiny CPU trainer (4 steps): the trace starts and stops at
    JAX's update counts (at the end of training when the window outlasts
    it), lands where JAX's profiler writes, and JAX's `summarize_trace`
    gives the port's list for it; the logged summary is that list."""
    save = str(tmp_path / "run")
    cfg = trainer_cfg(root, save, hooks=[
        dict(type="RuntimeProfiler", wait=wait, active=active)])
    tr = Trainer(cfg, device="cpu")
    prof = tr.hooks[0]
    window = Window(prof)
    window.trainer = tr
    tr.hooks.append(window)
    lines = []
    monkeypatch.setattr(tr.logger, "info", lambda msg: lines.append(msg))
    tr.train()
    assert tr.step == 4
    traced = [step for when, step, on in window.seen if when == "after" and on]
    started = [step for when, step, on in window.seen if when == "before" and on]
    calls, want = jax_window(wait, active, 4, monkeypatch)
    start, stop = calls[0][1], calls[1][1]
    assert [c[0] for c in calls] == ["start", "stop"]
    assert traced == want and started[0] == start, (window.seen, calls)
    assert prof._prof is None  # stopped: after the window, or by after_train
    files = glob.glob(os.path.join(save, "trace", "plugins", "profile", "*",
                                   "*.trace.json.gz"))
    assert len(files) == 1
    with gzip.open(files[0]) as f:
        spans = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "span"]
    # the port's spans of the same window, merged on the trace's clock
    assert {"trainer.data_wait", "train.step"} <= {e["name"] for e in spans if e["ph"] == "X"}
    got = tprofiling.summarize_trace(prof.trace_dir)
    assert got and got == jprofiling.summarize_trace(prof.trace_dir)
    summary = [ln for ln in lines if ln.startswith("[profile]")]
    if stop < wait + active:  # stopped by after_train: no summary, as in JAX
        assert summary == []
    else:
        assert summary == [f"[profile] {dur / 1e3:9.2f} ms {name[:90]}" for name, dur in got]
