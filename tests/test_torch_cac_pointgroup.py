"""CAC and PointGroup in the port against the JAX package: CAC's training
and eval outputs, its four losses and their gradients; the three losses
(`CACDistillLoss`, `OffsetL1Loss`, `OffsetCosineLoss`) alone and through
`Criteria`; `connected_components` and `PointGroup.cluster` ids exactly;
`InstanceParser` with the reference's quirk; `insseg_eval`'s records and AP
exactly; `InsSegEvaluator` against JAX's hook on the same weights and
scenes; `room_scene`'s instance ids (its other arrays bit-equal to what
it returned before they existed) through the PointGroup pipeline of both
packages; and the training CLI on a narrowed PointGroup config, whose
evaluated epoch logs finite mAP, AP50 and AP25. Inputs and weights are made
with numpy from a seed; the models' backbone is a narrow SpUNet in feature
mode on the 4,096-slot batch of `test_torch_spunet.py`."""

import copy
import hashlib
import os
import re
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from cdsegnet_tpu.data import datasets as jdatasets  # noqa: E402
from cdsegnet_tpu.data.transforms import InstanceParser as JInstanceParser  # noqa: E402
from cdsegnet_tpu.engine import hooks as jhooks  # noqa: E402
from cdsegnet_tpu.engine import insseg_eval as jie  # noqa: E402
from cdsegnet_tpu.engine.events import EventStorage as JStorage  # noqa: E402
from cdsegnet_tpu.engine.state import TrainState  # noqa: E402
from cdsegnet_tpu.models import losses as jl  # noqa: E402
from cdsegnet_tpu.models.builder import build_model as jbuild  # noqa: E402
from cdsegnet_tpu.models.pointgroup import connected_components as jcc  # noqa: E402
from cdsegnet_torch.data import datasets as tdatasets  # noqa: E402
from cdsegnet_torch.data.collate import collate_scenes  # noqa: E402
from cdsegnet_torch.data.transforms import InstanceParser  # noqa: E402
from cdsegnet_torch.engine import hooks as thooks  # noqa: E402
from cdsegnet_torch.engine import insseg_eval as tie  # noqa: E402
from cdsegnet_torch.engine.config import Config  # noqa: E402
from cdsegnet_torch.engine.events import EventStorage  # noqa: E402
from cdsegnet_torch.models import losses as tl  # noqa: E402
from cdsegnet_torch.models.builder import build_model as tbuild  # noqa: E402
from cdsegnet_torch.models.builder import build_model_criteria  # noqa: E402
from cdsegnet_torch.models.pointgroup import connected_components  # noqa: E402
from cdsegnet_torch.tools import train as train_tool  # noqa: E402
from cdsegnet_torch.utils.synthetic import room_scene  # noqa: E402
from cdsegnet_torch.utils.weights import load_jax_variables  # noqa: E402
from test_torch_data import assert_same, jax_numpy_host_ops  # noqa: E402,F401
from test_torch_model import as_numpy, random_variables, to_port  # noqa: E402
from test_torch_spunet import WIDTH, point  # noqa: E402

torch.set_num_threads(2)
T = lambda x: torch.from_numpy(np.array(x))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKBONE = dict(type="SpUNet-v1m1", in_channels=6, num_classes=0, **WIDTH)
C = WIDTH["channels"][-1]
CAC = dict(type="CAC-v1m1", backbone=BACKBONE, num_classes=5, backbone_out_channels=C,
           cos_temp=15.0)
CAC_CRITERIA = [
    dict(type="CrossEntropyLoss", pred="n_pred", loss_weight=1.0, ignore_index=-1),
    dict(type="CrossEntropyLoss", pred="cac_pred", loss_weight=1.0, ignore_index=-1),
    dict(type="CrossEntropyLoss", pred="pre_pred", loss_weight=1.0, ignore_index=-1),
    dict(type="CACDistillLoss", pred="n_pred", soft="cac_pred", loss_weight=1.0)]
# wide clusters, so that the narrow random model's proposals meet the boxes
PG = dict(type="PointGroup", backbone=BACKBONE, num_classes=5, backbone_out_channels=C,
          cluster_radius=0.12, cluster_nsample=8)
PG_CRITERIA = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1),
               dict(type="OffsetL1Loss", loss_weight=1.0),
               dict(type="OffsetCosineLoss", loss_weight=1.0)]
SEGMENT_IGNORE = (-1, 0, 1)


def instance_point():
    """The 4,096-slot batch with instance ids (clusters of 40 slots per
    scene, -1 on a third) and their centroids."""
    pt = point()
    rng = np.random.RandomState(4)
    inst = np.arange(pt.num_points) // 40
    inst = np.where(rng.rand(pt.num_points) < 0.33, -1, inst).astype(np.int32)
    cent = rng.randn(pt.num_points, 3).astype(np.float32)
    return pt.replace(instance=jnp.where(pt.mask, jnp.asarray(inst), -1),
                      instance_centroid=jnp.where(pt.mask[:, None], jnp.asarray(cent), 0.0))


def port_point(pt):
    p = to_port(pt)
    return p.replace(instance=T(pt.instance), instance_centroid=T(pt.instance_centroid))


def port_model(cfg, variables):
    m = tbuild(copy.deepcopy(cfg), device="cpu")
    load_jax_variables(m, variables)
    return m


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def cac_ref():
    pt = point()
    jm = jbuild(copy.deepcopy(CAC))
    v = as_numpy(random_variables(jm, pt))
    crit = jl.Criteria(CAC_CRITERIA)

    def loss_fn(params, stats, p):
        out, mut = jm.apply({"params": params, "batch_stats": stats}, p, train=True,
                            mutable=["batch_stats"])
        return crit(out, mode="train"), (out, mut["batch_stats"])

    (loss, (out, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], v["batch_stats"], pt)
    ev = jax.jit(lambda v, p: jm.apply(v, p, train=False))(v, pt)
    terms = [float(t) for t in jax.jit(lambda o: crit._terms(o))(out)]
    return dict(variables=v, loss=float(loss), grads=as_numpy(grads), stats=as_numpy(stats),
                train={k: np.asarray(x) for k, x in out.items()}, terms=terms,
                eval={k: np.asarray(x) for k, x in ev.items()})


def test_cac_outputs_losses_and_gradients_match_jax(cac_ref):
    """Training: ``n_pred``, ``pre_pred``, ``cac_pred`` (1e-5 of max
    |logits|), the four loss terms, every gradient (`test_torch_train.py`'s
    bound) and the running statistics; eval: no ``cac_pred``."""
    r = cac_ref
    pt = point()
    valid = np.asarray(pt.mask)
    m = port_model(CAC, r["variables"]).train()
    out = m(to_port(pt))
    for k in ("n_pred", "pre_pred", "cac_pred"):
        _close(out[k].detach().numpy()[valid], r["train"][k][valid])
    crit = build_model_criteria(dict(criteria=CAC_CRITERIA))
    np.testing.assert_allclose([t.item() for t in crit._terms(out)], r["terms"], rtol=1e-5)
    loss = crit(out)
    loss.backward()
    np.testing.assert_allclose(loss.item(), r["loss"], rtol=1e-5)
    want = dict(port_model(CAC, dict(params=r["grads"],
                                     batch_stats=r["variables"]["batch_stats"]))
                .named_parameters())
    floor = 1e-6 * max(w.abs().max().item() for w in want.values())
    for name, p in m.named_parameters():
        g, w = p.grad, want[name].detach()
        assert g is not None, name
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() + floor, name
    stats = dict(port_model(CAC, dict(params=r["variables"]["params"],
                                      batch_stats=r["stats"])).named_buffers())
    for bname, b in m.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[bname].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=bname)
    ev = port_model(CAC, r["variables"])(to_port(pt))
    assert "cac_pred" not in ev and "cac_pred" not in r["eval"]
    for k in ("n_pred", "pre_pred"):
        _close(ev[k].detach().numpy()[valid], r["eval"][k][valid])


def test_cac_head_kernel_is_not_transposed(cac_ref):
    """``seg_head_kernel`` is JAX's raw (c, cls) parameter, loaded as is."""
    m = port_model(CAC, cac_ref["variables"])
    np.testing.assert_array_equal(m.seg_head_kernel.detach().numpy(),
                                  cac_ref["variables"]["params"]["seg_head_kernel"])
    assert m.seg_head_kernel.shape == (C, 5)


def loss_inputs(seed=0, n=500, k=5):
    rng = np.random.RandomState(seed)
    return dict(pred=rng.randn(n, k).astype(np.float32) * 3,
                soft=rng.randn(n, k).astype(np.float32) * 3,
                target=rng.randint(-1, k, n).astype(np.int32),
                valid=rng.rand(n) < 0.8,
                off=rng.randn(n, 3).astype(np.float32),
                off_t=rng.randn(n, 3).astype(np.float32))


@pytest.mark.parametrize("kind", ["cac", "cac_eps", "l1", "cosine"])
def test_losses_match_jax(kind):
    d = loss_inputs()
    J = {k: jnp.asarray(v) for k, v in d.items()}
    P = {k: T(v) for k, v in d.items()}
    if kind.startswith("cac"):
        kw = dict(smoothness=0.3, eps=0.1) if kind == "cac_eps" else {}
        got = tl.cac_distill_loss(P["pred"], P["soft"], P["target"], P["valid"], **kw)
        want = jl.cac_distill_loss(J["pred"], J["soft"], J["target"], J["valid"], **kw)
    else:
        tf, jf = ((tl.offset_l1_loss, jl.offset_l1_loss) if kind == "l1"
                  else (tl.offset_cosine_loss, jl.offset_cosine_loss))
        got, want = tf(P["off"], P["off_t"], P["valid"]), jf(J["off"], J["off_t"], J["valid"])
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_pointgroup_criteria_match_jax():
    """PointGroup's three losses through `Criteria`; the offset terms only
    when the output has targets, as in JAX."""
    d = loss_inputs(1)
    out = dict(n_pred=d["pred"], n_target=d["target"], seg_valid=d["valid"],
               offset_pred=d["off"], offset_target=d["off_t"], instance_valid=d["valid"])
    got = tl.Criteria(PG_CRITERIA)({k: T(v) for k, v in out.items()})
    want = jl.Criteria(PG_CRITERIA)({k: jnp.asarray(v) for k, v in out.items()})
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    bare = {k: v for k, v in out.items() if k not in ("offset_target", "instance_valid")}
    assert len(tl.Criteria(PG_CRITERIA)._terms({k: T(v) for k, v in bare.items()})) == 1


def clustered_coords(seed=0, n=600):
    """Points in a few blobs and a scattered tail, some invalid."""
    rng = np.random.RandomState(seed)
    centers = rng.rand(6, 3).astype(np.float32) * 3
    coord = centers[rng.randint(0, 6, n)] + rng.randn(n, 3).astype(np.float32) * 0.05
    coord[: n // 10] = rng.rand(n // 10, 3) * 3
    return coord.astype(np.float32), rng.rand(n) < 0.9


@pytest.mark.parametrize("radius,nsample", [(0.03, 16), (0.08, 8), (0.2, 32)])
def test_connected_components_match_jax(radius, nsample):
    coord, valid = clustered_coords()
    want = np.asarray(jax.jit(lambda c, v: jcc(c, v, radius, nsample))(
        jnp.asarray(coord), jnp.asarray(valid)))
    got = connected_components(T(coord), T(valid), radius, nsample).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[~valid] == len(coord)).all() and len(np.unique(got[valid])) > 1


@pytest.fixture(scope="module")
def pg_ref():
    """JAX's PointGroup on the instance batch: eval outputs with targets,
    its proposals (`cluster` on the argmax and offsets)."""
    pt = instance_point()
    jm = jbuild(copy.deepcopy(PG))
    v = as_numpy(random_variables(jm, pt))
    # offsets of some centimetres, so that proposals form
    v["params"]["offset_head"]["kernel"] *= 0.05

    def run(v, p):
        out = jm.apply(v, p, train=False)
        sem = out["n_pred"].argmax(-1)
        return out, jm.apply(v, p, sem, out["offset_pred"], method=type(jm).cluster)

    out, clusters = jax.jit(run)(v, pt)
    return dict(variables=v, out={k: np.asarray(x) for k, x in out.items()},
                clusters=np.asarray(clusters))


def test_pointgroup_outputs_and_cluster_match_jax(pg_ref):
    pt = instance_point()
    m = port_model(PG, pg_ref["variables"])
    p = port_point(pt)
    out = m(p)
    valid = np.asarray(pt.mask)
    for k in ("n_pred", "offset_pred", "offset_target"):
        _close(out[k].detach().numpy()[valid], pg_ref["out"][k][valid])
    np.testing.assert_array_equal(out["instance_valid"].numpy(), pg_ref["out"]["instance_valid"])
    got = m.cluster(p, out["n_pred"].argmax(-1), out["offset_pred"]).numpy()
    np.testing.assert_array_equal(got, pg_ref["clusters"])
    assert 1 < len(np.unique(got[got < pt.num_points]))
    assert "offset_target" not in m(to_port(pt))  # no instances, no targets


def parser_scene(seed=0, n=400):
    rng = np.random.RandomState(seed)
    segment = rng.randint(-1, 6, n)
    instance = rng.randint(0, 9, n) * 7
    # the quirk: -1 instances on points of valid classes
    instance[rng.rand(n) < 0.1] = -1
    return dict(coord=rng.randn(n, 3).astype(np.float32), segment=segment,
                instance=instance)


@pytest.mark.parametrize("ignore", [(-1, 0, 1), (-1,)])
def test_instance_parser_matches_jax(ignore):
    """Dense renumbering, centroids and boxes array for array, including a
    -1 instance on a valid-class point, renumbered like a real instance."""
    scene = parser_scene()
    got = InstanceParser(segment_ignore_index=ignore)(copy.deepcopy(scene))
    want = JInstanceParser(segment_ignore_index=ignore)(copy.deepcopy(scene))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    keep = ~np.isin(scene["segment"], ignore)
    quirk = keep & (scene["instance"] == -1)
    assert quirk.any() and (got["instance"][quirk] == 0).all()
    assert (got["instance"][~keep] == -1).all()


def records_key(scenes):
    """Association records in a comparable form (they hold references):
    the confidences apart, as a flat list."""
    out, conf = [], []
    for s in scenes:
        gt = {c: [(g["instance_id"], g["vert_count"],
                   sorted((p["vert_count"], i) for p, i in g["matched"])) for g in gs]
              for c, gs in s["gt"].items()}
        pred = {c: [(p["vert_count"], p["void_intersection"],
                     sorted((g["instance_id"], i) for g, i in p["matched"])) for p in ps]
                for c, ps in s["pred"].items()}
        conf += [p["confidence"] for ps in s["pred"].values() for p in ps]
        out.append((gt, pred))
    return out, np.array(conf)


def insseg_inputs(seed):
    rng = np.random.RandomState(seed)
    n, k = 3000, 6
    segment = rng.randint(-1, k, n)
    instance = np.where(rng.rand(n) < 0.2, -1, rng.randint(0, 12, n))
    # proposals: mostly the instances, some points moved or dropped
    clusters = np.where(rng.rand(n) < 0.15, rng.randint(0, 14, n), instance)
    clusters = np.where((rng.rand(n) < 0.1) | (clusters < 0), n, clusters)
    sem = rng.randint(0, k, n)
    logits = rng.randn(n, k)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return dict(segment=segment, instance=instance, clusters=clusters, sem=sem,
                probs=probs.astype(np.float32), valid=rng.rand(n) < 0.95, k=k)


def test_insseg_eval_records_and_ap_match_jax():
    """Proposals, association records, AP per (class, threshold) and the
    summary exactly, over three scenes."""
    scenes = {"jax": [], "port": []}
    for seed in range(3):
        d = insseg_inputs(seed)
        for name, ie in (("jax", jie), ("port", tie)):
            props = ie.proposals_from_clusters(d["clusters"], d["sem"], d["probs"],
                                               d["valid"], min_points=20)
            scenes[name].append(ie.associate_instances(
                *props, d["segment"], d["instance"], d["k"], (-1, 0), min_region_size=20))
    (got, conf), (want, want_conf) = records_key(scenes["port"]), records_key(scenes["jax"])
    assert got == want
    np.testing.assert_array_equal(conf, want_conf)
    classes = [1, 2, 3, 4, 5]
    ap = tie.evaluate_matches(scenes["port"], classes, min_region_size=20)
    want = jie.evaluate_matches(scenes["jax"], classes, min_region_size=20)
    np.testing.assert_array_equal(ap, want)
    got, ref = tie.summarize_ap(ap), jie.summarize_ap(want)
    for k in ("all_ap", "all_ap_50", "all_ap_25"):
        assert got[k] == ref[k] and 0.0 < got[k] <= 1.0, (k, got[k])
    np.testing.assert_array_equal(got["per_class_ap"], ref["per_class_ap"])


class Log:
    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)

    warning = info


def val_batches():
    """Two synthetic rooms at 8 cm, one voxel per point, with instance ids
    through `InstanceParser`, each collated alone as the val loader does."""
    out = []
    for seed in (1, 2):
        room = room_scene(seed, cell=0.08, instances=True)
        grid = np.floor(room["coord"] / 0.08).astype(np.int64)
        grid -= grid.min(0)
        _, first = np.unique(grid, axis=0, return_index=True)
        first = np.sort(first)
        scene = dict(coord=room["coord"][first], grid_coord=grid[first],
                     segment=room["semantic_gt20"][first] % 5,
                     instance=room["instance_gt"][first],
                     feat=np.concatenate([room["color"][first] / 255.0,
                                          room["normal"][first]], 1).astype(np.float32))
        scene = InstanceParser(segment_ignore_index=SEGMENT_IGNORE)(scene)
        out.append((collate_scenes([scene], 8192, 1), scene))
    return out


def test_insseg_evaluator_matches_jax(pg_ref):
    """The port's hook and JAX's on stub trainers, the same weights and val
    scenes: the proposals' masks, classes and matches, and so AP and the
    logged result, equal JAX's exactly; the confidences (mean probabilities
    from logits that differ in the last bits) within 1e-6."""
    batches = val_batches()
    assert all(b["mask"].sum() > 1000 for b, _ in batches)
    cfg = Config(Config._wrap(dict(data=dict(num_classes=5,
                                             names=[f"c{i}" for i in range(5)]),
                                   serialization_depth=16)))
    hook_kw = dict(segment_ignore_index=SEGMENT_IGNORE, min_region_size=10,
                   cluster_min_points=10)
    captured = {}
    real = jie.evaluate_matches

    def capture(scenes, classes, **kw):
        captured["scenes"] = scenes
        captured["ap"] = real(scenes, classes, **kw)
        return captured["ap"]

    v = pg_ref["variables"]
    jtr = types.SimpleNamespace(
        cfg=cfg, epoch=0, logger=Log(), comm_info={}, storage=JStorage(),
        model=jbuild(copy.deepcopy(PG)), val_loader=batches,
        state=TrainState.create(v, optax.identity(), jax.random.PRNGKey(0)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jie, "evaluate_matches", capture)
        hook = jhooks.InsSegEvaluator(**hook_kw)
        hook.trainer = jtr
        hook.after_epoch()

    m = port_model(PG, v)
    ttr = types.SimpleNamespace(
        cfg=cfg, epoch=0, logger=Log(), comm_info={}, storage=EventStorage(), model=m,
        val_loader=batches, device=torch.device("cpu"), depth=16)
    hook = thooks.InsSegEvaluator(**hook_kw)
    hook.trainer = ttr
    hook.after_epoch()
    (got, conf), (want_rec, want_conf) = (records_key(hook.records),
                                          records_key(captured["scenes"]))
    assert got == want_rec
    np.testing.assert_allclose(conf, want_conf, rtol=1e-6)
    assert sum(len(p) for r in hook.records for p in r["pred"].values()) > 0
    want = jie.summarize_ap(captured["ap"])
    for k in ("all_ap", "all_ap_50", "all_ap_25"):
        assert hook.summary[k] == want[k] or (np.isnan(want[k]) and np.isnan(hook.summary[k]))
    assert ttr.logger.lines == jtr.logger.lines
    assert ttr.comm_info == jtr.comm_info


def test_pointgroup_training_cli_logs_instance_metrics(tmp_path):
    """`tools/train.py` on a config that `_base_`s the shipped PointGroup one
    (a narrow backbone, 8 cm rooms, a 16,384-slot bucket, GridSample keeping
    the instance ids): one evaluated epoch of two steps logs finite mAP,
    AP50 and AP25 in [0, 1]."""
    for split, seeds in (("train", (1, 2)), ("val", (3,))):
        os.makedirs(tmp_path / "data" / split)
        for i, s in enumerate(seeds):
            torch.save(room_scene(s, cell=0.08, instances=True),
                       tmp_path / "data" / split / f"scene{i:04d}_00.pth")
    base = Config.fromfile(os.path.join(REPO, "configs", "scannet", "insseg_pointgroup.py"))
    pipeline = copy.deepcopy(list(base.data.train.transform))
    for t in pipeline:
        if t["type"] == "GridSample":
            t.update(grid_size=0.08, keys=("coord", "color", "normal", "segment", "instance"))
        if t["type"] == "SphereCrop":
            t["point_max"] = 8192
    hooks = [dict(type="InformationWriter", log_interval=1),
             dict(type="InsSegEvaluator", segment_ignore_index=SEGMENT_IGNORE,
                  min_region_size=10, cluster_min_points=10),
             dict(type="CheckpointSaver")]
    data = dict(train=dict(data_root=str(tmp_path / "data"), transform=pipeline),
                val=dict(data_root=str(tmp_path / "data"), transform=pipeline))
    cfg_file = tmp_path / "pg.py"
    cfg_file.write_text(
        f"_base_ = [{os.path.join(REPO, 'configs', 'scannet', 'insseg_pointgroup.py')!r}]\n"
        f"model = dict(backbone=dict({', '.join(f'{k}={v!r}' for k, v in WIDTH.items())}), "
        f"backbone_out_channels={C}, cluster_radius=0.12)\nepoch = 2\neval_epoch = 1\n"
        f"bucket_num_points = 16384\nval_num_points = 16384\nhooks = {hooks!r}\n"
        f"data = {data!r}\n")
    trainer = train_tool.main(["--config-file", str(cfg_file), "--options",
                               f"save_path={tmp_path / 'run'}", "--device", "cpu"])
    assert trainer.step == 2
    log = open(tmp_path / "run" / "train.log").read()
    (line,) = re.findall(r"Val result: mAP (\S+) AP50 (\S+) AP25 (\S+)", log)
    assert all(0.0 <= float(x) <= 1.0 for x in line), line
    assert trainer.comm_info["current_metric_name"] == "AP50"


# sha256 prefixes of every array `room_scene` returned before `instances`
# existed (seed, cell): its draws must not move
ROOM_HASHES = {
    (0, 0.02): dict(color="60be88cab1e814c5", coord="9e725a9d0bb4e084",
                    normal="329c42c28fdec2ae", semantic_gt20="9a536cb471dd0ba9",
                    semantic_gt200="8b4d63568f6aa023"),
    (3, 0.08): dict(color="bfdcbd8e16066e50", coord="f56cd423c967007f",
                    normal="850bf9daf045d1d1", semantic_gt20="85547d992193a6f9",
                    semantic_gt200="de0c79235dd71163"),
}


@pytest.mark.parametrize("seed,cell", list(ROOM_HASHES))
def test_room_scene_arrays_are_unchanged(seed, cell):
    """Every earlier array bit-equal with and without ``instances``;
    ``instance_gt`` is each box's index on its points and -1 on the walls
    and the floor."""
    for instances in (False, True):
        room = room_scene(seed, cell=cell, instances=instances)
        assert ("instance_gt" in room) == instances
        got = {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()[:16]
               for k, v in room.items() if k != "instance_gt"}
        assert got == ROOM_HASHES[(seed, cell)]
    inst, seg = room["instance_gt"], room["semantic_gt20"]
    np.testing.assert_array_equal(np.unique(inst), [-1, 0, 1, 2, 3])
    assert (inst[np.isin(seg, (0, 1))] == -1).all() and (inst[~np.isin(seg, (0, 1))] >= 0).all()
    for box in range(4):  # one class per box
        assert len(np.unique(seg[inst == box])) == 1


def test_pointgroup_pipeline_matches_jax(tmp_path, jax_numpy_host_ops):
    """Two rooms with instance ids through the shipped PointGroup train
    pipeline (with ``instance`` among GridSample's keys; the shipped keys
    omit it in both packages) of both datasets with the same generator:
    every array equal, instances renumbered, centroids per instance."""
    os.makedirs(tmp_path / "train")
    for i, s in enumerate((1, 2)):
        torch.save(room_scene(s, cell=0.05, instances=True),
                   tmp_path / "train" / f"scene{i:04d}_00.pth")
    cfg = Config.fromfile(os.path.join(REPO, "configs", "scannet", "insseg_pointgroup.py"))
    pipeline = copy.deepcopy(list(cfg.data.train.transform))
    for t in pipeline:
        if t["type"] == "GridSample":
            t["keys"] = ("coord", "color", "normal", "segment", "instance")
    ds_cfg = dict(cfg.data.train, data_root=str(tmp_path), transform=pipeline)
    tds, jds = tdatasets.build_dataset(ds_cfg), jdatasets.build_dataset(copy.deepcopy(ds_cfg))
    trng, jrng = np.random.default_rng(1), np.random.default_rng(1)
    for idx in range(2):
        got, want = tds.get(idx, trng), jds.get(idx, jrng)
        assert_same(got, want)
        inst = got["instance"]
        assert sorted(np.unique(inst)) == [-1, 0, 1, 2, 3]
        for i in range(4):
            np.testing.assert_allclose(got["instance_centroid"][inst == i],
                                       np.broadcast_to(got["coord"][inst == i].mean(0),
                                                       (int((inst == i).sum()), 3)),
                                       rtol=1e-6)


def test_shipped_pointgroup_pipeline_fails_as_jax(tmp_path):
    """As shipped, the PointGroup config's GridSample keeps the default keys,
    which omit ``instance``: a room the sphere crop leaves whole reaches
    `InstanceParser` with ids of the raw length, and both packages raise."""
    os.makedirs(tmp_path / "train")
    torch.save(room_scene(1, cell=0.08, instances=True),
               tmp_path / "train" / "scene0000_00.pth")
    cfg = Config.fromfile(os.path.join(REPO, "configs", "scannet", "insseg_pointgroup.py"))
    ds_cfg = dict(cfg.data.train, data_root=str(tmp_path))
    for ds in (tdatasets.build_dataset(ds_cfg), jdatasets.build_dataset(copy.deepcopy(ds_cfg))):
        with pytest.raises(IndexError, match="boolean index did not match"):
            ds.get(0, np.random.default_rng(0))
