"""Point Prompt Training in the port against the JAX package: PPT-v1m1
over a PDNorm SpUNet (the shipped recipe's shape) for each of the three
conditions, with the learned class table and with a `.npy` table; its
training forward's loss and gradients (``embedding_table``,
``class_embedding``, ``logit_scale`` among them); PPT-v1m2's heads; the
dual-branch CNF path with ``dm`` over `tests/test_model.py`'s tiny PTv3
(the eval output and a step's gradients, timesteps and noise injected);
`MultiDatasetLoader`'s tags, restarts and batches; one `MultiDatasetTrainer`
epoch on two datasets; the val ``condition`` through the evaluator's step;
and the tester with ``model_kwargs``. Weights are made with numpy from a
seed and carried across with `load_jax_variables`. JAX draws the dual
branch's timesteps and noise from its ``jax.random``; the test replaces the
`jax` name of its PPT module with one that returns the injected draws,
and changes nothing of the JAX package."""

import copy
import os
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from cdsegnet_tpu.data import loader as jloader  # noqa: E402
from cdsegnet_tpu.engine.config import Config as JConfig  # noqa: E402
from cdsegnet_tpu.engine.state import TrainState, make_eval_step as jeval_step  # noqa: E402
from cdsegnet_tpu.engine.test import SemSegTester as JTester  # noqa: E402
from cdsegnet_tpu.models import losses as jl  # noqa: E402
from cdsegnet_tpu.models import ppt as jppt  # noqa: E402
from cdsegnet_tpu.models.builder import build_model as jbuild  # noqa: E402
from cdsegnet_tpu.models.structure import make_point_batch as jmake  # noqa: E402
from cdsegnet_torch.data import loader as tloader  # noqa: E402
from cdsegnet_torch.engine.config import Config  # noqa: E402
from cdsegnet_torch.engine.test import SemSegTester  # noqa: E402
from cdsegnet_torch.engine.train import TRAINERS  # noqa: E402
from cdsegnet_torch.models.builder import build_model as tbuild  # noqa: E402
from cdsegnet_torch.models.builder import build_model_criteria  # noqa: E402
from cdsegnet_torch.utils.synthetic import synthetic_arrays  # noqa: E402
from cdsegnet_torch.utils.weights import load_jax_variables  # noqa: E402
from test_engine import _write_synthetic_dataset  # noqa: E402
from test_model import TINY_BACKBONE  # noqa: E402
from test_torch_data import assert_same  # noqa: E402
from test_torch_model import as_numpy, random_variables, to_port  # noqa: E402
from test_torch_tester import TEST_DATA, outputs  # noqa: E402

torch.set_num_threads(2)
T = lambda x: torch.from_numpy(np.array(x))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(REPO, "configs", "multidataset", "ppt_spunet.py")
N = 2048
CONDITIONS = ("Structured3D", "ScanNet", "S3DIS")
# two stages: the JAX references compile in seconds
SPUNET_PD = dict(type="SpUNet-v1m3", in_channels=6, num_classes=0, base_channels=8,
                 channels=(8, 16, 16, 8), layers=(1, 1, 1, 1), capacity_div=(1, 2, 4),
                 num_conditions=3, pdnorm_adaptive=True)
V1M1 = dict(type="PPT-v1m1", backbone=SPUNET_PD, backbone_out_channels=8,
            context_channels=32, conditions=CONDITIONS, clip_embed_dim=16)
V1M2 = dict(type="PPT-v1m2", backbone=SPUNET_PD, backbone_out_channels=8,
            context_channels=32, conditions=CONDITIONS, num_classes=(25, 20, 13))
# the dual-branch CNF extension over the tiny PTv3: no curve shuffle and no
# stochastic depth (their draws are not injected), 256 slots
DUAL = dict(type="PPT-v1m1", backbone=dict(TINY_BACKBONE, shuffle_orders=False,
                                           drop_path=0.0),
            backbone_out_channels=5, context_channels=16, conditions=CONDITIONS,
            clip_embed_dim=16, condition=True, dm=True, T=50, T_dim=16,
            noise_schedule="cosine", beta_start=0, beta_end=1000, dm_min_snr=5.0)
DUAL_N = 256
CRITERIA = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1),
            dict(type="LovaszLoss", mode="multiclass", loss_weight=1.0, ignore_index=-1)]
DUAL_CRITERIA = [dict(type="MSELoss", loss_weight=1.0)] + CRITERIA


def point(n=N, seed=3, depth=9):
    a = synthetic_arrays(n, 2, depth=depth, seed=seed)
    a["coord"] = a["coord"] * 2.0
    a["segment"] = a["segment"] % 13
    return jmake(**{k: jnp.asarray(v) for k, v in a.items()}, depth=depth, num_scenes=2)


def injected_jax(ts, noise):
    """A stand-in for the JAX PPT module's ``jax``: ``random.randint`` gives
    ``ts`` and ``random.normal`` gives ``noise``."""
    rnd = types.SimpleNamespace(
        split=jax.random.split,
        randint=lambda *a, **k: jnp.asarray(ts, jnp.int32),
        normal=lambda *a, **k: jnp.asarray(noise, jnp.float32))
    return types.SimpleNamespace(random=rnd)


def dual_draws():
    rng = np.random.RandomState(4)
    return rng.randint(0, 50, 2).astype(np.int32), rng.randn(DUAL_N, 6).astype(np.float32)


def _eval_ref(cfg, pt, conds, v=None):
    jm = jbuild(copy.deepcopy(cfg))
    if v is None:
        v = as_numpy(random_variables(jm, pt, train=False, condition=0))
    fn = jax.jit(lambda v, p, c: jm.apply(v, p, train=False, condition=c)["n_pred"],
                 static_argnums=2)
    return dict(variables=v, out={c: np.asarray(fn(v, pt, c)) for c in conds})


def _heads_ref(pt):
    """PPT-v1m2 at condition 1, each head's logits: JAX computes every
    head and returns the condition's."""
    jm = jbuild(copy.deepcopy(V1M2))
    v = as_numpy(random_variables(jm, pt, train=False, condition=0))

    def fn(v, p):
        out, state = jm.apply(v, p, train=False, condition=1, capture_intermediates=(
            lambda mdl, _: (mdl.name or "").startswith("seg_head")))
        heads = state["intermediates"]
        return out["n_pred"], [heads[f"seg_head{i}"]["__call__"][0] for i in range(3)]

    n_pred, heads = jax.jit(fn)(v, pt)
    return dict(variables=v, n_pred=np.asarray(n_pred), heads=[np.asarray(h) for h in heads])


def _dual_eval_ref(v, pt, rngs):
    jm = jbuild(copy.deepcopy(DUAL))
    return np.asarray(jax.jit(lambda v, p: jm.apply(
        v, p, train=False, condition=1, rngs=rngs)["n_pred"])(v, pt))


def _train_ref(cfg, pt, cond, criteria, rngs=None, v=None):
    jm = jbuild(copy.deepcopy(cfg))
    if v is None:
        v = as_numpy(random_variables(jm, pt, train=False, condition=cond))
    crit = jl.Criteria(criteria)

    def loss_fn(params, stats, p):
        out, mut = jm.apply({"params": params, "batch_stats": stats}, p, train=True,
                            condition=cond, rngs=rngs or {}, mutable=["batch_stats"])
        return crit(out, mode="train"), mut["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], v["batch_stats"], pt)
    return dict(variables=v, loss=float(loss), grads=as_numpy(grads), stats=as_numpy(stats))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every JAX model reference (inputs as jit arguments); the dual
    branch's draws injected."""
    npy = str(tmp_path_factory.mktemp("ppt") / "clip.npy")
    np.save(npy, np.random.RandomState(5).randn(36, 16).astype(np.float32))
    pt, dual_pt = point(), point(DUAL_N, seed=6, depth=6)
    ts, noise = dual_draws()
    mp = pytest.MonkeyPatch()
    mp.setattr(jppt, "jax", injected_jax(ts, noise))
    rngs = dict(diffusion=jax.random.PRNGKey(0))
    dual_v = as_numpy(random_variables(jbuild(copy.deepcopy(DUAL)), dual_pt, train=False,
                                       condition=1))
    # one parameter tree for every PPT-v1m1 reference (the .npy model's has
    # no class table)
    v1m1_v = as_numpy(random_variables(jbuild(copy.deepcopy(V1M1)), pt, train=False,
                                       condition=0))
    npy_v = dict(v1m1_v, params={k: v for k, v in v1m1_v["params"].items()
                                 if k != "class_embedding"})
    jobs = dict(
        dual_train=lambda: _train_ref(DUAL, dual_pt, 1, DUAL_CRITERIA, rngs, dual_v),
        dual_eval=lambda: _dual_eval_ref(dual_v, dual_pt, rngs),
        v1m1=lambda: _eval_ref(V1M1, pt, (0, 1, 2), v1m1_v),
        train=lambda: _train_ref(V1M1, pt, 2, CRITERIA, v=v1m1_v),
        v1m2=lambda: _heads_ref(pt),
        npy=lambda: _eval_ref(dict(V1M1, class_embedding_path=npy), pt, (1,), npy_v),
    )
    try:
        res = {k: f() for k, f in jobs.items()}
    finally:
        mp.undo()
    res.update(npy_path=npy, point=pt, dual_point=dual_pt, ts=ts, noise=noise)
    return res


def port_model(cfg, variables):
    m = tbuild(copy.deepcopy(cfg), device="cpu")
    load_jax_variables(m, copy.deepcopy(variables))
    return m


def _close(got, want, rel=1e-5):
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("condition", [0, 1, 2])
def test_v1m1_logits_match_jax(ref, condition):
    """PPT-v1m1 over the PDNorm SpUNet, learned class table: each
    condition's ``n_pred`` (its ``valid_index`` rows) within 1e-5 of max
    |x| on the valid slots."""
    r = ref["v1m1"]
    m = port_model(V1M1, r["variables"])
    pt = ref["point"]
    got = m(to_port(pt), condition=condition)["n_pred"].detach().numpy()
    want = r["out"][condition]
    valid = np.asarray(pt.mask)
    assert got.shape == want.shape == (N, len(jppt.DEFAULT_VALID_INDEX[condition]))
    _close(got[valid], want[valid])


def test_v1m1_class_embedding_file_matches_jax(ref):
    """``class_embedding_path``: the frozen `.npy` table, in neither
    package's parameters."""
    r = ref["npy"]
    m = port_model(dict(V1M1, class_embedding_path=ref["npy_path"]), r["variables"])
    assert m.class_embedding is None and "class_embedding" not in dict(m.named_parameters())
    pt = ref["point"]
    got = m(to_port(pt), condition=1)["n_pred"].detach().numpy()
    valid = np.asarray(pt.mask)
    _close(got[valid], r["out"][1][valid])


@pytest.mark.parametrize("head", [0, 1, 2])
def test_v1m2_heads_match_jax(ref, head):
    """PPT-v1m2: every ``seg_head{i}`` exists and gives JAX's logits on the
    backbone's condition-1 features; the forward of condition 1 gives its
    head's as ``n_pred``."""
    r = ref["v1m2"]
    m = port_model(V1M2, r["variables"])
    assert [n for n, _ in m.named_children() if n.startswith("seg_head")] == [
        "seg_head0", "seg_head1", "seg_head2"]
    pt = to_port(ref["point"])
    valid = pt.mask.numpy()
    with torch.no_grad():
        feat = m._backbone(pt, m._geometry(pt, {}, None), {}, 1)
        got = getattr(m, f"seg_head{head}")(feat.float()).numpy()
        n_pred = m(pt, condition=1)["n_pred"].numpy()
    assert got.shape == (N, (25, 20, 13)[head])
    _close(got[valid], r["heads"][head][valid])
    _close(n_pred[valid], r["n_pred"][valid])


def assert_grads(m, cfg, r):
    want = dict(port_model(cfg, dict(params=r["grads"], batch_stats=r["variables"][
        "batch_stats"])).named_parameters())
    floor = 1e-6 * max(w.abs().max().item() for w in want.values())
    for name, p in m.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        w = want[name].detach()
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() + floor, name
    return want


def test_v1m1_training_gradients_match_jax(ref):
    """Training mode, condition 2: CE + Lovasz on ``n_pred``, every
    gradient (the bound of `test_torch_spunet.py`), the context reaching
    the adaptive PDNorm, and only condition 2's running statistics."""
    r = ref["train"]
    m = port_model(V1M1, r["variables"]).train()
    p = to_port(ref["point"])
    loss = build_model_criteria(dict(criteria=CRITERIA))(m(p, condition=2))
    loss.backward()
    np.testing.assert_allclose(loss.item(), r["loss"], rtol=1e-5)
    want = assert_grads(m, V1M1, r)
    for name in ("embedding_table", "class_embedding", "logit_scale"):
        assert want[name].abs().max() > 0, name
    assert m.embedding_table.grad[[0, 1]].abs().max() == 0
    stats = dict(port_model(V1M1, dict(params=r["variables"]["params"],
                                       batch_stats=r["stats"])).named_buffers())
    for name, b in m.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[name].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_dual_branch_eval_and_gradients_match_jax(ref):
    """The dual-branch CNF path with ``dm``: the eval forward (N(0, 1) at t
    = T - 1, JAX's noise fed in) and a training forward's loss (MSE with
    the min-SNR weight, CE, Lovasz) and gradients (q-sampled per scene,
    timesteps and noise fed in). ``embedding_table`` feeds no PDNorm here:
    its gradient is zero in both packages."""
    r = ref["dual_train"]
    pt = to_port(ref["dual_point"])
    m = port_model(DUAL, r["variables"])
    with torch.no_grad():
        got = m(pt, condition=1, noise=T(ref["noise"]))["n_pred"].numpy()
    valid = pt.mask.numpy()
    assert got.shape == (DUAL_N, 20)
    _close(got[valid], ref["dual_eval"][valid])
    m.train()
    out = m(pt, condition=1, ts_scene=T(ref["ts"]), noise=T(ref["noise"]))
    assert out["c_pred"].shape == out["c_target"].shape == (DUAL_N, 6)
    loss = build_model_criteria(dict(criteria=DUAL_CRITERIA))(out)
    loss.backward()
    np.testing.assert_allclose(loss.item(), r["loss"], rtol=1e-5)
    want = assert_grads(m, DUAL, r)
    assert want["embedding_table"].abs().max() == 0 and m.embedding_table.grad is None
    for name in ("class_embedding", "logit_scale", "proj_head.weight"):
        assert want[name].abs().max() > 0, name


class SeededScenes:
    """A dataset whose scene i is fixed by i and draws one value from the
    loader's generator (so the generator streams are compared too)."""

    def __init__(self, n, tag):
        self.n, self.tag = n, tag

    def __len__(self):
        return self.n

    def get(self, i, rng):
        r = np.random.default_rng((self.tag, i))
        m = 20 + 4 * i
        return dict(coord=r.random((m, 3)).astype(np.float32),
                    feat=np.full((m, 6), rng.random(), np.float32),
                    grid_coord=r.integers(0, 16, (m, 3)).astype(np.int32),
                    segment=np.full(m, self.tag, np.int32))


def test_multi_dataset_loader_matches_jax():
    """Tags in round-robin order by the ratios, the main dataset ending the
    epoch, a short dataset restarting with JAX's epoch seeds, and every
    batch array for array, over two epochs."""
    sizes, ratios = (4, 1, 3), (2, 1, 1)

    def loaders(mod):
        return [mod.TrainLoader(SeededScenes(n, t), scenes_per_device=1, num_points=64,
                                prefetch=1 if mod is tloader else 0, seed=7)
                for t, n in enumerate(sizes)]

    jl_ = jloader.MultiDatasetLoader(loaders(jloader), ratios)
    tl_ = tloader.MultiDatasetLoader(loaders(tloader), ratios)
    assert len(tl_) == len(jl_) == 8
    for epoch in (0, 1):
        want = list(jl_.epoch(epoch))
        got = list(tl_.epoch(epoch))
        assert [b["_dataset_idx"] for b in got] == [b["_dataset_idx"] for b in want] == [
            0, 0, 1, 2] * 2
        for g, w in zip(got, want):
            assert_same({k: v for k, v in g.items() if k != "_dataset_idx"},
                        {k: v[0] for k, v in w.items() if k != "_dataset_idx"})


def trainer_cfg(roots, save, val=None):
    transform = [dict(type="GridSample", grid_size=0.05, hash_type="fnv", mode="train",
                      return_grid_coord=True),
                 dict(type="NormalizeColor"),
                 dict(type="Collect", keys=("coord", "grid_coord", "segment"),
                      feat_keys=("color", "normal"))]
    data = dict(num_classes=5, ignore_index=-1, train=dict(type="ConcatDataset", datasets=[
        dict(type="ScanNetDataset", split="train", data_root=roots[0], transform=transform,
             test_mode=False, condition="A", loop=1),
        dict(type="ScanNetDataset", split="train", data_root=roots[1], transform=transform,
             test_mode=False, condition="B", loop=1)]))
    if val is not None:
        data["val"] = dict(type="ScanNetDataset", split="val", data_root=roots[1],
                           transform=transform, test_mode=False, condition=val)
    backbone = dict(SPUNET_PD, num_conditions=2, channels=(8, 8, 16, 16, 16, 16, 8, 8),
                    layers=(1,) * 8, capacity_div=(1, 2, 4, 8, 8))
    return Config(Config._wrap(dict(
        save_path=save, seed=0, num_devices=1, scenes_per_device=2, bucket_num_points=1024,
        val_num_points=512, serialization_depth=7, epoch=1, resume=False,
        model=dict(type="PPT-v1m2", backbone=backbone, backbone_out_channels=8,
                   context_channels=32, conditions=("A", "B"), num_classes=(5, 4),
                   criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0)]),
        optimizer=dict(type="AdamW", lr=1e-3, weight_decay=0.01),
        scheduler=dict(type="OneCycleLR", pct_start=0.3),
        hooks=[dict(type="IterationTimer"), dict(type="InformationWriter", log_interval=1)],
        data=data)))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multi")
    out = [str(tmp / "ds0"), str(tmp / "ds1")]
    _write_synthetic_dataset(out[0], n_scenes=4, num_classes=5, seed=0)
    _write_synthetic_dataset(out[1], n_scenes=2, num_classes=4, seed=1)
    return out


def test_multi_dataset_trainer_epoch(roots, tmp_path):
    """One epoch of `MultiDatasetTrainer` over two synthetic datasets with
    different label spaces (JAX's `tests/test_ppt.py:185`, which is
    ``slow`` there): a step per batch, each through its condition's step,
    both heads updated, the inactive head's decayed as AdamW decays a zero
    gradient; an unknown condition name is refused."""
    tr = TRAINERS.build(dict(type="MultiDatasetTrainer"), cfg=trainer_cfg(roots, str(tmp_path)),
                        device="cpu")
    heads = {h: getattr(tr.model, h).weight.detach().clone() for h in ("seg_head0", "seg_head1")}
    tr.train()
    assert tr.step == tr.steps_per_epoch == 4
    assert set(tr.cond_steps) == {0, 1}
    assert all(s.generators is tr.generators for s in tr.cond_steps.values())
    for h, w in heads.items():
        assert (tr.model.get_submodule(h).weight - w).abs().max() > 0, h
    assert np.isfinite(tr.comm_info["metrics"]["loss"])
    tr.ds_conditions[1] = "C"
    with pytest.raises(ValueError, match="'C' not in model conditions"):
        tr._select_train_step(1)


def test_val_condition_reaches_the_evaluation_step(roots, tmp_path):
    """A val dataset's ``condition`` ("B") selects the model's condition 1
    in the evaluation step: its logits equal JAX's eval step with
    ``model_kwargs=dict(condition=1)`` on the same weights; a name not in
    the model's conditions is refused."""
    tr = TRAINERS.build(dict(type="MultiDatasetTrainer"),
                        cfg=trainer_cfg(roots, str(tmp_path / "a"), val="B"), device="cpu")
    batch, _ = next(iter(tr.val_loader))
    jm = jbuild(copy.deepcopy(plain_model(tr.cfg)))
    n = batch["coord"].shape[0]
    jp = jmake(**{k: jnp.asarray(batch[k]) for k in ("coord", "feat", "grid_coord", "batch",
                                                     "mask", "segment")},
               depth=7, num_scenes=1)
    variables = random_variables(jm, jp, train=False, condition=0)
    load_jax_variables(tr.model, as_numpy(variables))
    state = TrainState.create(variables, optax.identity(), jax.random.PRNGKey(0))
    want = np.asarray(jeval_step(jm, None, 7, 1, model_kwargs=dict(condition=1))(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))[
        "seg_logits"])
    got = tr.eval_step(batch)["seg_logits"].numpy()
    valid = batch["mask"]
    assert got.shape == want.shape == (n, 4)
    _close(got[valid], want[valid])
    with pytest.raises(ValueError, match="val condition 'C'"):
        TRAINERS.build(dict(type="MultiDatasetTrainer"),
                       cfg=trainer_cfg(roots, str(tmp_path / "b"), val="C"), device="cpu")


def plain_model(cfg):
    out = {k: v for k, v in cfg.model.items()}
    out["backbone"] = dict(cfg.model.backbone)
    return out


def test_tester_model_kwargs_match_jax(roots, tmp_path):
    """The tester with ``model_kwargs=dict(condition=1)`` on a tiny
    PPT-v1m2: every fragment through the plain forward of condition 1;
    records, preds and submissions equal JAX's `SemSegTester`."""
    model_cfg = plain_model(trainer_cfg(roots, "unused"))

    def cfg(save):
        return dict(save_path=save, seed=0, serialization_depth=7, submission=True,
                    test_buckets=[256, 512], ignore_index=-1, num_devices=1,
                    model=copy.deepcopy(model_cfg), model_kwargs=dict(condition=1),
                    data=dict(num_classes=4, ignore_index=-1, names=[f"c{i}" for i in range(4)],
                              test=dict(TEST_DATA, data_root=roots[1])))

    jm = jbuild(copy.deepcopy(model_cfg))
    n = 512
    jp = jmake(coord=jnp.zeros((n, 3)), feat=jnp.zeros((n, 6)),
               grid_coord=jnp.zeros((n, 3), jnp.int32), batch=jnp.zeros((n,), jnp.int32),
               mask=jnp.zeros((n,), bool).at[:300].set(True), segment=jnp.zeros((n,), jnp.int32),
               depth=7, num_scenes=1)
    variables = random_variables(jm, jp, train=False, condition=0)
    state = TrainState.create(variables, optax.identity(), jax.random.PRNGKey(0))
    jsave, tsave = str(tmp_path / "jax"), str(tmp_path / "port")
    jt = JTester(JConfig(JConfig._wrap(cfg(jsave))), state=state, model=jm, verbose=False)
    jmiou = jt.test()
    m = tbuild(copy.deepcopy(model_cfg), device="cpu")
    load_jax_variables(m, as_numpy(variables))
    tt = SemSegTester(Config(Config._wrap(cfg(tsave))), model=m, device="cpu", verbose=False)
    calls = []
    forward = m.forward

    def record(*a, **k):
        calls.append(k.get("condition"))
        return forward(*a, **k)

    m.forward = record
    miou = tt.test()
    assert calls and set(calls) == {1}
    names = sorted(jt.records)
    assert sorted(tt.records) == names == ["scene0000", "scene0001"]
    for name in names:
        for k in ("intersection", "union", "target"):
            np.testing.assert_array_equal(tt.records[name][k], jt.records[name][k])
    got, want = outputs(tsave, names), outputs(jsave, names)
    for name in names:
        np.testing.assert_array_equal(got[name][0], want[name][0])
        assert got[name][1] == want[name][1]
    assert miou == pytest.approx(jmiou, abs=0)


def test_shipped_ppt_config_matches_jax_parameters():
    """`configs/multidataset/ppt_spunet.py`'s model builds in the port with
    JAX's parameter tree (``proj_head`` 96 -> 512, the learned class
    table, the adaptive PDNorm's per-condition tensors): every JAX variable
    fills one port tensor of its shape, strictly."""
    cfg = JConfig.fromfile(SHIPPED)
    model_cfg = plain_model(cfg)
    jm = jbuild(copy.deepcopy(model_cfg))
    pt = point(256, depth=12)
    shapes = jax.eval_shape(lambda p: jm.init(dict(params=jax.random.PRNGKey(0)), p,
                                              train=False, condition=0), pt)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    m = tbuild(copy.deepcopy(model_cfg), device="cpu")
    load_jax_variables(m, zeros)
    assert m.proj_head.weight.shape == (512, 96)
    assert m.embedding_table.shape == (3, 256) and m.class_embedding.shape == (36, 512)
