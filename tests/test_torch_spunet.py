"""The sparse-conv family in the port against the JAX package: SpUNet-v1m1,
MinkUNet, SpUNet-v1m3 (adaptive PDNorm, condition 1), OA-CNNs and SPVCNN
at a narrow width, each in f32: the eval forward, and one training forward
and backward (loss, every gradient, the running statistics; SPVCNN with
JAX's dropout masks fed in); `grid_clusters` ids exactly, at power-of-two
and other sizes; one whole `make_train_step` step of `DefaultSegmentor`
with SGD (Nesterov) + OneCycle against JAX's step and optax; feature mode;
a JAX SpUNet checkpoint through `convert_jax_checkpoint.py`; and
`SemanticKITTIDataset` on synthetic sweeps through the shipped SPVCNN
config's pipelines against JAX's, array for array. Inputs and
weights are made with numpy from a seed; weights are carried across with
`load_jax_variables`.

The batch is 4,096 slots of two synthetic scenes at 4 cm spacing. Its five
levels hold 3,686 / 1,430 / 419 / 123 / 33 valid points (capacities 4,096
/ 2,048 / 1,024 / 256 / 64; no drop): train-mode BatchNorm on a level of a
few points amplifies f32 rounding (ROADMAP Queue 3), so the coarsest level
holds dozens here."""

import copy
import os

import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

import convert_jax_checkpoint as converter  # noqa: E402
from cdsegnet_tpu.data import datasets as jdatasets  # noqa: E402
from cdsegnet_tpu.engine.checkpoint import CheckpointManager as JManager  # noqa: E402
from cdsegnet_tpu.engine.config import Config as JConfig  # noqa: E402
from cdsegnet_tpu.engine.optimizer import build_optimizer as jbuild_optimizer  # noqa: E402
from cdsegnet_tpu.engine.state import TrainState  # noqa: E402
from cdsegnet_tpu.models import losses as jl  # noqa: E402
from cdsegnet_tpu.models import pyramid as jpyr  # noqa: E402
from cdsegnet_tpu.models.builder import build_model as jbuild  # noqa: E402
from cdsegnet_tpu.models.oacnns import grid_clusters as jgrid_clusters  # noqa: E402
from cdsegnet_tpu.models.structure import make_point_batch as jmake  # noqa: E402
from cdsegnet_torch.data import datasets as tdatasets  # noqa: E402
from cdsegnet_torch.engine.checkpoint import CheckpointManager  # noqa: E402
from cdsegnet_torch.engine.config import Config  # noqa: E402
from cdsegnet_torch.engine.optimizer import build_optimizer  # noqa: E402
from cdsegnet_torch.engine.state import make_train_step  # noqa: E402
from cdsegnet_torch.models import pyramid as tpyr  # noqa: E402
from cdsegnet_torch.models.builder import build_model as tbuild  # noqa: E402
from cdsegnet_torch.models.builder import build_model_criteria  # noqa: E402
from cdsegnet_torch.models.modules import DropoutDraws  # noqa: E402
from cdsegnet_torch.models.oacnns import grid_clusters  # noqa: E402
from cdsegnet_torch.utils.synthetic import (lidar_sweep, synthetic_arrays,  # noqa: E402
                                            write_semantic_kitti)
from cdsegnet_torch.utils.weights import load_jax_variables  # noqa: E402
from test_torch_model import as_numpy, random_variables, to_port  # noqa: E402
from test_torch_data import assert_same, jax_numpy_host_ops  # noqa: E402,F401
from test_torch_options import mask_capture, sown_masks  # noqa: E402

torch.set_num_threads(2)
T = lambda x: torch.from_numpy(np.array(x))
N = 4096
CTX = 16  # the adaptive PDNorm's context width in these tests
WIDTH = dict(base_channels=8, channels=(8, 16, 16, 16, 16, 16, 8, 8),
             layers=(1, 1, 2, 1, 1, 1, 1, 1))
MODELS = {
    "spunet": dict(type="SpUNet-v1m1", in_channels=6, num_classes=5, **WIDTH),
    "minkunet": dict(type="MinkUNet", in_channels=6, num_classes=5, **WIDTH),
    "v1m3": dict(type="SpUNet-v1m3", in_channels=6, num_classes=5, num_conditions=2,
                 pdnorm_adaptive=True, context_channels=CTX, **WIDTH),
    "oacnns": dict(type="OACNNs", in_channels=6, num_classes=5, embed_channels=8,
                   enc_channels=(8, 8, 16, 16), enc_depth=(1, 1, 2, 1),
                   dec_channels=(8, 8, 16, 16)),
    "spvcnn": dict(type="SPVCNN", in_channels=6, num_classes=5, **WIDTH),
}
TRAINED = ("spunet", "v1m3", "oacnns", "spvcnn")
CRITERIA = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1),
            dict(type="LovaszLoss", mode="multiclass", loss_weight=1.0, ignore_index=-1)]
SGD = dict(type="SGD", lr=0.05, momentum=0.9, nesterov=True)
ONECYCLE = dict(type="OneCycleLR", pct_start=0.05, div_factor=10.0, final_div_factor=1e4)
CLUSTER_SIZES = (2, 4, 6, 8, 12, 16, 24, 64)


def jax_cfg(cfg):
    """The JAX module's fields: the port's ``context_channels`` (flax infers
    the modulation's input width) dropped."""
    return {k: v for k, v in cfg.items() if k != "context_channels"}


def point():
    """N slots of two synthetic scenes at 4 cm spacing (see the module
    docstring for the level sizes)."""
    a = synthetic_arrays(N, 2, depth=9, seed=3)
    a["coord"] = a["coord"] * 2.0
    a["segment"] = a["segment"] % 5
    return jmake(**{k: jnp.asarray(v) for k, v in a.items()}, depth=9, num_scenes=2)


def context():
    return np.random.RandomState(9).randn(1, CTX).astype(np.float32)


def call_kw(name, port=False):
    if name != "v1m3":
        return {}
    ctx = context()
    return dict(condition=1, context=T(ctx) if port else jnp.asarray(ctx))


def _eval_ref(name):
    pt = point()
    jm = jbuild(jax_cfg(MODELS[name]))
    kw = call_kw(name)
    v = random_variables(jm, pt, train=False, **kw)
    out = jax.jit(lambda v, p: jm.apply(v, p, train=False, **kw).feat)(v, pt)
    return dict(variables=as_numpy(v), out=np.asarray(out))


def _train_ref(name):
    """The backbone's training forward, the config's losses on its logits,
    their gradients and the new running statistics; SPVCNN's dropout masks
    as JAX draws them."""
    pt = point()
    jm = jbuild(jax_cfg(MODELS[name]))
    kw = call_kw(name)
    v = as_numpy(random_variables(jm, pt, train=False, **kw))
    crit = jl.Criteria(CRITERIA, loss_type="EW", task_num=2)

    def loss_fn(params, stats, p):
        with fnn.intercept_methods(mask_capture()):
            out, mut = jm.apply({"params": params, "batch_stats": stats}, p, train=True,
                                rngs=dict(dropout=jax.random.PRNGKey(7)),
                                mutable=["batch_stats", "intermediates"], **kw)
        o = dict(n_pred=out.feat, n_target=p.segment, seg_valid=p.mask & (p.segment >= 0))
        return crit(o, mode="train"), (mut["batch_stats"], mut.get("intermediates", {}))

    (loss, (stats, inter)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], v["batch_stats"], pt)
    return dict(variables=v, loss=float(loss), grads=as_numpy(grads), stats=as_numpy(stats),
                masks=sown_masks(inter))


def _step_ref(_):
    """One step of `DefaultSegmentor(SpUNet-v1m1)`: JAX's loss, gradients
    and SGD (Nesterov) + OneCycle update, weight decay 0."""
    pt = point()
    cfg = dict(type="DefaultSegmentor", backbone=dict(MODELS["spunet"]))
    jm = jbuild(copy.deepcopy(cfg))
    v = as_numpy(random_variables(jm, pt))
    crit = jl.Criteria(CRITERIA, loss_type="EW", task_num=2)

    def loss_fn(params, stats, p):
        out, mut = jm.apply({"params": params, "batch_stats": stats}, p, train=True,
                            mutable=["batch_stats"])
        return crit(out, mode="train"), mut["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], v["batch_stats"], pt)
    tx = jbuild_optimizer(dict(SGD), v["params"], dict(ONECYCLE), total_steps=10)
    updates, _ = jax.jit(tx.update)(grads, jax.jit(tx.init)(v["params"]), v["params"])
    params = jax.jit(optax.apply_updates)(v["params"], updates)
    return dict(cfg=cfg, variables=v, loss=float(loss), params=as_numpy(params),
                stats=as_numpy(stats))


def _clusters_ref(_):
    """JAX's pyramid of the OA-CNNs tiny batch and `grid_clusters` ids at
    every pooled level and size."""
    pt = point()
    caps = [jpyr.round_up(max(N // d, 8), 8) for d in (2, 4, 16, 64)]

    def fn(p):
        levels, _ = jpyr.build_pyramid(p, strides=(2,) * 4, capacities=caps, orders=("z",),
                                       shuffle_key=None, stem_kernel=3)
        return [[jgrid_clusters(lv, s) for s in CLUSTER_SIZES] for lv in levels[1:]]

    return [[np.asarray(x) for x in row] for row in jax.jit(fn)(pt)]


JOBS = ([("eval", n) for n in MODELS] + [("train", n) for n in TRAINED]
        + [("step", "spunet"), ("clusters", "oacnns")])


@pytest.fixture(scope="module")
def ref():
    """Every JAX reference; inputs are jit arguments, never constants."""
    fns = dict(eval=_eval_ref, train=_train_ref, step=_step_ref, clusters=_clusters_ref)
    return {job: fns[job[0]](job[1]) for job in JOBS}


def _close(got, want, rel=1e-5):
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def port_model(cfg, variables):
    m = tbuild(copy.deepcopy(cfg), device="cpu")
    load_jax_variables(m, variables)
    return m


def test_level_sizes_are_the_documented_ones():
    """The batch's pyramid: dozens of valid points at the coarsest level."""
    m = tbuild(copy.deepcopy(MODELS["spunet"]), device="cpu")
    levels, _ = m.precompute_geometry(to_port(point()))
    assert [lv.size for lv in levels] == [4096, 2048, 1024, 256, 64]
    assert [int(lv.point.mask.sum()) for lv in levels] == [3686, 1430, 419, 123, 33]
    assert [lv.dropped for lv in levels[1:]] == [0, 0, 0, 0]


@pytest.mark.parametrize("name", list(MODELS))
def test_eval_logits_match_jax(ref, name):
    """f32 eval logits within 1e-5 of max |logits| on the valid slots."""
    r = ref[("eval", name)]
    m = port_model(MODELS[name], r["variables"])
    pt = point()
    got = m(to_port(pt), **call_kw(name, port=True)).detach().numpy()
    valid = np.asarray(pt.mask)
    assert got.shape == (N, 5) and got.dtype == np.float32
    _close(got[valid], r["out"][valid])


@pytest.mark.parametrize("name", TRAINED)
def test_train_forward_and_backward_match_jax(ref, name):
    """Training mode: the loss (CE + Lovasz on the logits), every
    parameter's gradient (1e-4 of the tensor's max |g| plus 1e-6 of the
    largest, the bound of `test_torch_train.py`) and the running statistics
    (PDNorm: only condition 1's advance)."""
    r = ref[("train", name)]
    m = port_model(MODELS[name], r["variables"]).train()
    pt = point()
    kw = call_kw(name, port=True)
    if name == "spvcnn":
        assert [x.shape for x in r["masks"]] == [(64, 16), (1024, 16)]
        kw["generator"] = DropoutDraws(None, [T(x) for x in r["masks"]])
    p = to_port(pt)
    logits = m(p, **kw)
    if name == "spvcnn":
        assert not kw["generator"].masks  # every mask used
    crit = build_model_criteria(dict(criteria=CRITERIA))
    loss = crit(dict(n_pred=logits, n_target=p.segment, seg_valid=p.mask & (p.segment >= 0)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), r["loss"], rtol=1e-5)
    want = dict(port_model(MODELS[name], dict(params=r["grads"],
                                             batch_stats=r["variables"]["batch_stats"]))
                .named_parameters())
    floor = 1e-6 * max(w.abs().max().item() for w in want.values())
    for pname, prm in m.named_parameters():
        g, w = prm.grad, want[pname].detach()
        assert g is not None, pname
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() + floor, pname
    stats = dict(port_model(MODELS[name], dict(params=r["variables"]["params"],
                                              batch_stats=r["stats"])).named_buffers())
    for bname, b in m.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[bname].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=bname)
    if name == "v1m3":
        assert torch.equal(m.stem_bn.mean[0], T(r["variables"]["batch_stats"]["stem_bn"]
                                               ["mean"][0]))


@pytest.mark.parametrize("size", CLUSTER_SIZES)
def test_grid_clusters_ids_are_jax_ids(ref, size):
    """Dense ids at every pooled level, exactly: power-of-two sizes from the
    z-codes, the others (6, 12, 24) from one packed sort of the voxel key;
    invalid points take ids above every valid point's while the size is
    below the level's grid extent (past it, a power-of-two shift drops the
    scene bits of the code, and all points share one id in both
    packages)."""
    want = ref[("clusters", "oacnns")]
    levels, _ = tpyr.build_pyramid(to_port(point()), strides=(2,) * 4,
                                   capacities=[2048, 1024, 256, 64], orders=("z",),
                                   stem_kernel=3)
    i = CLUSTER_SIZES.index(size)
    for lv, row in zip(levels[1:], want):
        got = grid_clusters(lv, size).numpy()
        np.testing.assert_array_equal(got, row[i])
        valid = lv.point.mask.numpy()
        if size < 2 ** lv.point.depth:
            assert got[~valid].min() > got[valid].max()


def test_sgd_step_of_the_segmentor_matches_jax(ref):
    """`make_train_step` over `DefaultSegmentor(SpUNet-v1m1)` with SGD
    (Nesterov) + OneCycle: the loss, the updated parameters (within 1e-5 of
    each tensor's largest value: one update of lr 5e-3 on the bridged
    gradients) and the running statistics equal JAX's step and optax's
    update."""
    r = ref[("step", "spunet")]
    m = port_model(r["cfg"], r["variables"])
    crit = build_model_criteria(dict(criteria=CRITERIA))
    opt = build_optimizer(dict(SGD), m, dict(ONECYCLE), total_steps=10, device="cpu")
    step = make_train_step(m, crit, opt, device="cpu")
    metrics = step(to_port(point()))
    np.testing.assert_allclose(metrics["loss"].item(), r["loss"], rtol=1e-5)
    assert [int(metrics[f"dropped_l{i}"]) for i in range(1, 5)] == [0, 0, 0, 0]
    want = port_model(r["cfg"], dict(params=r["params"], batch_stats=r["stats"]))
    for (name, a), (_, b) in zip(m.named_parameters(), want.named_parameters()):
        err = (a - b).abs().max().item()
        assert err <= 1e-5 * b.abs().max().item(), (name, err)
    for (name, a), (_, b) in zip(m.named_buffers(), want.named_buffers()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)


def test_feature_mode_has_no_head(ref):
    """``num_classes=0``: no ``final`` and the last decoder block's output
    (the logits before JAX's head, recovered by inverting it is not
    possible, so: the port's own head applied to the features gives JAX's
    logits)."""
    r = ref[("eval", "spunet")]
    params = {k: v for k, v in r["variables"]["params"].items() if k != "final"}
    m = port_model(dict(MODELS["spunet"], num_classes=0),
                   dict(params=params, batch_stats=r["variables"]["batch_stats"]))
    assert m.final is None
    pt = point()
    feat = m(to_port(pt))
    assert feat.shape == (N, WIDTH["channels"][-1])
    head = r["variables"]["params"]["final"]
    got = (feat @ T(head["kernel"]) + T(head["bias"])).detach().numpy()
    valid = np.asarray(pt.mask)
    _close(got[valid], r["out"][valid])


def test_jax_spunet_checkpoint_converts(ref, tmp_path):
    """A `TrainState` of `DefaultSegmentor(SpUNet-v1m1)` with SGD momentum,
    saved by JAX's `CheckpointManager`, converts: every weight and running
    statistic carried, the momentum not (weights only)."""
    r = ref[("step", "spunet")]
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, r["variables"]),
                              optax.sgd(0.05, momentum=0.9, nesterov=True),
                              jax.random.PRNGKey(0))
    JManager(str(tmp_path / "jax")).save(state.replace(step=jnp.int32(4)), "model_last")
    config = tmp_path / "spunet.py"
    config.write_text(f"model = {r['cfg']!r}\n")
    out = str(tmp_path / "port" / "model_last")
    got = converter.main(["--config-file", str(config), "--jax-checkpoint",
                          str(tmp_path / "jax" / "model_last"), "--output", out])
    assert got["step"] == 4 and got["kept"] == []
    state = CheckpointManager(os.path.dirname(out)).restore_raw("model_last")
    assert sorted(state) == ["model", "step"]
    want = port_model(r["cfg"], r["variables"]).state_dict()
    assert sorted(state["model"]) == sorted(want)
    for k, v in want.items():
        assert torch.equal(state["model"][k], v), k


KITTI_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "configs", "semantic_kitti", "spvcnn.py")


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """Sweeps thinned to every 4th return: two in sequence 00 (train), one
    in 08 (val)."""
    root = str(tmp_path_factory.mktemp("kitti"))
    thin = lambda s: {k: v[::4] for k, v in lidar_sweep(s).items()}
    write_semantic_kitti(root, {"00": [thin(1), thin(2)], "08": [thin(3)]})
    return root


def test_semantic_kitti_writer_covers_every_class(kitti_root):
    """The raw ids the writer gives map to all 19 learning classes (and the
    ignored unlabeled id); the dataset reads the scans and names them
    ``<seq>_<frame>``."""
    ds = tdatasets.SemanticKITTIDataset(split="train", data_root=kitti_root)
    assert len(ds) == 2 and ds.get_data_name(1) == "00_000001"
    item = ds.get_data(0)
    sw = lidar_sweep(1)
    np.testing.assert_array_equal(item["coord"], sw["points"][::4, :3])
    np.testing.assert_array_equal(item["strength"],
                                  (sw["points"][::4, 3:4] / 255.0).astype(np.float32))
    seen = set()
    for split in ("train", "val"):
        d = tdatasets.SemanticKITTIDataset(split=split, data_root=kitti_root)
        for i in range(len(d)):
            seen |= set(np.unique(d.get_data(i)["segment"]).tolist())
    assert seen == set(range(-1, 19))
    for ignore in (-1, 255):
        for name in ("get_learning_map", "get_learning_map_inv"):
            assert (getattr(tdatasets.SemanticKITTIDataset, name)(ignore)
                    == getattr(jdatasets.SemanticKITTIDataset, name)(ignore))


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_semantic_kitti_pipelines_match_jax(kitti_root, split, jax_numpy_host_ops):
    """The shipped SPVCNN config's pipeline of each split through both
    datasets with the same numpy generator: every array equal (test mode:
    the 5 cm fragments)."""
    cfg, jcfg = Config.fromfile(KITTI_CONFIG), JConfig.fromfile(KITTI_CONFIG)
    t = dict(cfg.data[split], data_root=kitti_root)
    j = dict(jcfg.data[split], data_root=kitti_root)
    tds, jds = tdatasets.build_dataset(t), jdatasets.build_dataset(j)
    assert len(tds) == len(jds) == (2 if split == "train" else 1)
    trng, jrng = np.random.default_rng(54421566), np.random.default_rng(54421566)
    for idx in range(len(tds)):
        got, want = tds.get(idx, trng), jds.get(idx, jrng)
        assert_same(got, want)
        feat = got["fragment_list"][0]["feat"] if split == "test" else got["feat"]
        assert feat.shape[1] == 4  # coord + strength
