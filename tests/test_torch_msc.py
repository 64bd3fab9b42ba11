"""MSC pretraining in the port against the JAX package: the cell hash bit
for bit (negative cells, cells on grid boundaries), the cross masks, the
pair matching with injected scores, InfoNCE, the loss and every gradient of
a tiny MSC (a two-stage SpUNet of base 8, 1,024 slots), the two-view
pipeline (`Copy`, `ContrastiveViewsGenerator`, `collate_pair_scenes`) and
the pair loader array for array, and one `MSCTrainer` step against JAX's
`make_msc_train_step` (the shipped config's parameter tree is
`tests/test_torch_variants.py`'s). The step's draws (the hash seed and the
pair scores) are fed to JAX by replacing the `jax` name of its MSC module
with one whose ``random.randint`` and ``random.uniform`` return them;
nothing of the JAX package changes."""

import copy
import os
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cdsegnet_tpu.data import collate as jcollate  # noqa: E402
from cdsegnet_tpu.data import datasets as jdatasets  # noqa: E402
from cdsegnet_tpu.data import loader as jloader  # noqa: E402
from cdsegnet_tpu.data import native as jnative  # noqa: E402
from cdsegnet_tpu.engine.config import Config as JConfig  # noqa: E402
from cdsegnet_tpu.engine.optimizer import build_optimizer as jbuild_optimizer  # noqa: E402
from cdsegnet_tpu.engine.state import TrainState, make_msc_train_step as jmsc_step  # noqa: E402
from cdsegnet_tpu.models import losses as jl  # noqa: E402
from cdsegnet_tpu.models import msc as jmsc  # noqa: E402
from cdsegnet_tpu.models.builder import build_model as jbuild  # noqa: E402
from cdsegnet_tpu.models.structure import make_point_batch as jmake  # noqa: E402
from cdsegnet_torch.data import collate as tcollate  # noqa: E402
from cdsegnet_torch.data import datasets as tdatasets  # noqa: E402
from cdsegnet_torch.data import loader as tloader  # noqa: E402
from cdsegnet_torch.engine.config import Config  # noqa: E402
from cdsegnet_torch.engine.state import msc_inputs  # noqa: E402
from cdsegnet_torch.engine.train import TRAINERS  # noqa: E402
from cdsegnet_torch.models.builder import build_model as tbuild  # noqa: E402
from cdsegnet_torch.models.msc import cell_uniform  # noqa: E402
from cdsegnet_torch.models.structure import make_point_batch as tmake  # noqa: E402
from cdsegnet_torch.utils.synthetic import room_scene  # noqa: E402
from cdsegnet_torch.utils.weights import load_jax_variables  # noqa: E402
from test_torch_data import assert_same, jax_numpy_host_ops, plain  # noqa: E402,F401
from test_torch_model import as_numpy, random_variables  # noqa: E402

torch.set_num_threads(2)
T = lambda x: torch.from_numpy(np.array(x))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(REPO, "configs", "scannet", "pretrain_msc.py")
N = 1024  # two scenes of at most 480 points per view
DEPTH = 8
FEAT_KEYS = ("color", "normal")
BACKBONE = dict(type="SpUNet-v1m1", in_channels=6, num_classes=0, base_channels=8,
                channels=(8, 16, 16, 8), layers=(1, 1, 1, 1), capacity_div=(1, 2, 4))
MODEL = dict(type="MSC", backbone=BACKBONE, backbone_in_channels=6,
             backbone_out_channels=8, mask_grid_size=0.1, mask_rate=0.4,
             matching_max_radius=0.03, matching_max_pair=256, nce_t=0.4)
# the shipped optimizer without weight decay (JAX's SGD decay is not the
# port's, `tests/test_torch_optim.py`): Adam would turn the rounding noise of
# a bias that only BatchNorm reads into an lr-sized step
OPTIMIZER = dict(type="SGD", lr=0.1, momentum=0.8, nesterov=True)
SCHEDULER = dict(type="OneCycleLR", pct_start=0.05, div_factor=10.0,
                 final_div_factor=10000.0)
SEED = 123457  # the injected hash seed


def msc_transform(point_max=480):
    """The shipped pretraining pipeline, each view's SphereCrop shrunk."""
    out = plain(JConfig.fromfile(SHIPPED).data.train.transform)
    for t in out:
        for v in t.get("view_trans_cfg", ()):
            if v["type"] == "SphereCrop":
                v["point_max"] = point_max
    return out


def dataset_cfg(root):
    return dict(type="ScanNetDataset", split="train", data_root=root,
                transform=msc_transform(), test_mode=False)


def injected_jax(seed, score):
    """A stand-in for the JAX MSC module's ``jax``: its ``random.randint``
    gives ``seed`` and ``random.uniform`` gives ``score``."""
    rnd = types.SimpleNamespace(
        split=jax.random.split, PRNGKey=jax.random.PRNGKey,
        randint=lambda *a, **k: jnp.asarray(seed, jnp.int32),
        uniform=lambda key, shape, *a, **k: jnp.asarray(score, jnp.float32))
    return types.SimpleNamespace(random=rnd, nn=jax.nn, lax=jax.lax)


def views(batch, lib="jax"):
    """A collated pair's two `PointBatch`es, origins and targets."""
    out = []
    for v in ("view1", "view2"):
        sub = {k[len(v) + 1:]: a for k, a in batch.items() if k.startswith(v + "_")}
        arrs = {k: sub[k] for k in ("coord", "feat", "grid_coord", "batch", "mask")}
        if lib == "jax":
            pt = jmake(**{k: jnp.asarray(a) for k, a in arrs.items()}, depth=DEPTH,
                       num_scenes=2)
            tgt = {k: jnp.asarray(sub["target_" + k]) for k in FEAT_KEYS}
            out.append((pt, jnp.asarray(sub["origin_coord"]), tgt))
        else:
            out.append((tmake(**arrs, depth=DEPTH, num_scenes=2, device="cpu"),
                        T(sub["origin_coord"]), {k: T(sub["target_" + k]) for k in FEAT_KEYS}))
    return out


@pytest.fixture(scope="module")
def rooms(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("msc") / "data")
    os.makedirs(os.path.join(root, "train"))
    for i in range(4):
        torch.save(room_scene(10 + i, cell=0.4),
                   os.path.join(root, "train", f"scene{i:04d}_00.pth"))
    return root


@pytest.fixture(scope="module")
def ref(rooms):
    """JAX's pair loader batches (its numpy host ops), then on the first
    batch the tiny MSC's outputs, loss, gradients and running statistics,
    and one `make_msc_train_step` step, with the draws injected."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "_LIB", None)
    mp.setattr(jnative, "_TRIED", True)
    loader = jloader.TrainLoader(jdatasets.build_dataset(dataset_cfg(rooms)),
                                 scenes_per_device=2, num_points=N, seed=0, prefetch=0,
                                 pair_feat_keys=FEAT_KEYS)
    batches = [{k: v[0] for k, v in b.items()} for b in loader.epoch(0)]
    scene = jdatasets.build_dataset(dataset_cfg(rooms)).get(1, np.random.default_rng(5))
    score = np.random.RandomState(7).rand(N).astype(np.float32)
    mp.setattr(jmsc, "jax", injected_jax(SEED, score))
    try:
        (p1, o1, t1), (p2, o2, t2) = views(batches[0])
        jm = jbuild(copy.deepcopy(MODEL))
        variables = as_numpy(random_variables(jm, p1, p2, o1, o2, t1, t2, train=False))
        rngs = dict(diffusion=jax.random.PRNGKey(0))
        crit = jl.Criteria(None)

        def loss_fn(params, stats, a, b, oa, ob, ta, tb):
            out, mut = jm.apply({"params": params, "batch_stats": stats}, a, b, oa, ob,
                                ta, tb, train=True, rngs=rngs, mutable=["batch_stats"])
            return crit(out, mode="train"), (out, mut["batch_stats"])

        def grads():
            return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                variables["params"], variables["batch_stats"], p1, p2, o1, o2, t1, t2)

        def step():
            tx = jbuild_optimizer(OPTIMIZER, variables["params"], SCHEDULER, total_steps=2)
            state = TrainState.create(copy.deepcopy(variables), tx, jax.random.PRNGKey(0))
            fn = jmsc_step(jm, crit, tx, DEPTH, 2, None, feat_keys=FEAT_KEYS)
            return fn(state, {k: jnp.asarray(v) for k, v in batches[0].items()})

        (loss, (out, stats)), grads = grads()
        state, metrics = step()
        return dict(batches=batches, scene=scene, score=score, variables=variables,
                    loss=float(loss), out={k: np.asarray(v) for k, v in out.items()},
                    grads=as_numpy(grads), stats=as_numpy(stats),
                    step_params=as_numpy(state.params),
                    step_metrics={k: float(v) for k, v in metrics.items()})
    finally:
        mp.undo()


def port_model(variables):
    m = tbuild(copy.deepcopy(MODEL), device="cpu")
    load_jax_variables(m, copy.deepcopy(variables))
    return m


def test_cell_hash_bits_match_jax():
    """Every bit of the uniform, on negative, zero and large cells, scene
    ids with padding, and seeds across the int32 range."""
    rng = np.random.RandomState(0)
    cells = np.concatenate([rng.randint(-2 ** 31, 2 ** 31 - 1, (500, 3)),
                            rng.randint(-40, 40, (500, 3)),
                            [[0, 0, 0], [-1, -1, -1], [2 ** 31 - 1, -2 ** 31, 1]]]
                           ).astype(np.int32)
    batch = rng.randint(0, 3, len(cells)).astype(np.int32)
    fn = jax.jit(jmsc._cell_uniform)
    for seed in (0, 1, 2 ** 31 - 2, SEED):
        want = np.asarray(fn(jnp.asarray(cells), jnp.asarray(batch), jnp.int32(seed)))
        got = cell_uniform(T(cells), T(batch), torch.tensor(seed)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert want.min() >= 0 and want.max() < 1


def test_cross_masks_match_jax_on_cell_boundaries():
    """Origins at float32 multiples of the 0.1 m grid, and one ulp either
    side (subnormals aside), negative ones too: the cells (and so the
    masks) are JAX's, which divides by the constant as a product with its
    float32 reciprocal."""
    k = np.arange(-60, 60, dtype=np.float32)
    base = (k * np.float32(0.1)).astype(np.float32)
    vals = np.concatenate([base, np.nextafter(base, np.float32(-1e9)),
                           np.nextafter(base, np.float32(1e9)),
                           (k / np.float32(10)).astype(np.float32)])
    # XLA's CPU flushes subnormals (0's neighbours) to zero; no scan has them
    vals = vals[(vals == 0) | (np.abs(vals) >= np.finfo(np.float32).tiny)]
    rng = np.random.RandomState(1)
    n = 1440
    origin = np.stack([rng.choice(vals, n) for _ in range(3)], 1).astype(np.float32)
    batch = (np.arange(n) * 3 // n).astype(np.int32)
    mask = rng.rand(n) < 0.9
    arrs = dict(coord=origin, feat=np.zeros((n, 6), np.float32),
                grid_coord=np.zeros((n, 3), np.int32), batch=batch, mask=mask)
    jm = jbuild(copy.deepcopy(MODEL))
    jp = jmake(**{k2: jnp.asarray(v) for k2, v in arrs.items()}, depth=DEPTH, num_scenes=3)
    fn = jax.jit(lambda a, oa, ob, s: jm.apply({}, a, a, oa, ob, s,
                                                method=jmsc.MaskedSceneContrast.cross_masks))
    tm = tbuild(copy.deepcopy(MODEL), device="cpu")
    tp = tmake(**arrs, depth=DEPTH, num_scenes=3, device="cpu")
    for seed in (0, SEED):
        w1, w2 = fn(jp, jnp.asarray(origin), jnp.asarray(origin[::-1].copy()),
                    jnp.int32(seed))
        g1, g2 = tm.cross_masks(tp, tp, T(origin), T(origin[::-1].copy()), torch.tensor(seed))
        np.testing.assert_array_equal(g1.numpy(), np.asarray(w1))
        np.testing.assert_array_equal(g2.numpy(), np.asarray(w2))
        assert 0 < g1.sum() < mask.sum() and not (g1 & ~T(mask)).any()


def test_match_pairs_match_jax(ref):
    """The 1-NN over the whole bucket, the radius and same-scene guards and
    the top scores: pairs and validity equal, the many invalid rows (tied
    at -1) in JAX's order, given JAX's own uniforms as the scores."""
    (p1, o1, _), (p2, o2, _) = views(ref["batches"][0])
    cfg = dict(copy.deepcopy(MODEL), matching_max_pair=N)  # every row, ties included
    jm = jbuild(copy.deepcopy(cfg))
    key = jax.random.PRNGKey(3)
    pairs, valid = jax.jit(lambda a, b, oa, ob, k: jm.apply(
        {}, a, b, oa, ob, k, method=jmsc.MaskedSceneContrast.match_pairs))(p1, p2, o1, o2, key)
    score = np.asarray(jax.random.uniform(key, (N,)))
    (q1, r1, _), (q2, r2, _) = views(ref["batches"][0], "torch")
    tm = tbuild(cfg, device="cpu")
    got_pairs, got_valid = tm.match_pairs(q1, q2, r1, r2, T(score))
    np.testing.assert_array_equal(got_pairs.numpy(), np.asarray(pairs))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(valid))
    assert 256 < int(got_valid.sum()) < N  # more than the tiny model's pairs, and ties


def test_info_nce_matches_jax():
    rng = np.random.RandomState(2)
    f1, f2 = (rng.randn(300, 8).astype(np.float32) for _ in range(2))
    pairs = np.stack([rng.permutation(300)[:64], rng.randint(0, 300, 64)], 1).astype(np.int32)
    valid = rng.rand(64) < 0.8
    jm = jbuild(copy.deepcopy(MODEL))
    want = jax.jit(lambda *a: jm.apply({}, *a, method=jmsc.MaskedSceneContrast.info_nce))(
        jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(pairs), jnp.asarray(valid))
    got = tbuild(copy.deepcopy(MODEL), device="cpu").info_nce(
        T(f1), T(f2), T(pairs).long(), T(valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)


def test_loss_and_gradients_match_jax(ref):
    """The tiny MSC in training mode on the first loader batch: every term
    of the loss (rtol 1e-5), the masks, every gradient (1e-4 of the
    tensor's max |g| plus 1e-6 of the largest, as `test_torch_spunet.py`)
    and the running statistics."""
    m = port_model(ref["variables"]).train()
    inputs = msc_inputs(ref["batches"][0], DEPTH, 2, "cpu", FEAT_KEYS)
    out = m(**inputs, seed=torch.tensor(SEED), score=T(ref["score"]))
    out["loss"].backward()
    for k in ("loss", "nce_loss", "pos_sim", "neg_sim", "color_loss", "normal_loss"):
        np.testing.assert_allclose(out[k].item(), ref["out"][k], rtol=1e-5, err_msg=k)
    for k in ("view1_mask", "view2_mask"):
        np.testing.assert_array_equal(out[k].numpy(), ref["out"][k])
    assert 0 < out["view1_mask"].sum() and 0 < out["view2_mask"].sum()
    want = dict(port_model(dict(params=ref["grads"], batch_stats=ref["variables"][
        "batch_stats"])).named_parameters())
    floor = 1e-6 * max(w.abs().max().item() for w in want.values())
    for name, p in m.named_parameters():
        g, w = p.grad, want[name].detach()
        assert g is not None, name
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() + floor, name
    assert want["mask_token"].abs().max() > 0
    stats = dict(port_model(dict(params=ref["variables"]["params"],
                                 batch_stats=ref["stats"])).named_buffers())
    for name, b in m.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[name].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_pair_pipeline_and_loader_match_jax(rooms, ref, jax_numpy_host_ops):
    """`Copy` and `ContrastiveViewsGenerator` through the shipped view
    pipeline (one scene), then `collate_pair_scenes` inside the pair
    loader over an epoch: array for array."""
    ds = tdatasets.build_dataset(dataset_cfg(rooms))
    assert_same(ds.get(1, np.random.default_rng(5)), ref["scene"])
    loader = tloader.TrainLoader(ds, scenes_per_device=2, num_points=N, seed=0, prefetch=1,
                                 pair_feat_keys=FEAT_KEYS)
    got = list(loader.epoch(0))
    assert len(got) == len(ref["batches"]) == 2
    for g, w in zip(got, ref["batches"]):
        assert_same(g, w)
    assert {k.split("_", 1)[1] for k in got[0]} == {
        "coord", "grid_coord", "feat", "batch", "mask", "origin_coord", "target_color",
        "target_normal"}


def test_collate_pair_scenes_refuses_a_view_without_origin_rows():
    """A view pipeline that subsampled ``coord`` but not ``origin_coord``
    is refused with the same error by both packages."""
    rng = np.random.RandomState(3)
    scene = {}
    for v, n in (("view1", 40), ("view2", 30)):
        scene.update({f"{v}_coord": rng.rand(n, 3).astype(np.float32),
                      f"{v}_grid_coord": rng.randint(0, 9, (n, 3)),
                      f"{v}_color": rng.rand(n, 3), f"{v}_normal": rng.rand(n, 3),
                      f"{v}_origin_coord": rng.rand(n, 3)})
    assert_same(tcollate.collate_pair_scenes([scene], 64, 1),
                jcollate.collate_pair_scenes([scene], 64, 1))
    scene["view2_origin_coord"] = rng.rand(50, 3)
    for fn in (tcollate.collate_pair_scenes, jcollate.collate_pair_scenes):
        with pytest.raises(ValueError, match="view2_origin_coord has 50 rows"):
            fn([scene], 64, 1)


def trainer_cfg(rooms, save):
    return Config(Config._wrap(dict(
        save_path=save, seed=0, num_devices=1, scenes_per_device=2,
        bucket_num_points=N, serialization_depth=DEPTH, epoch=1, resume=False,
        pair_feat_keys=FEAT_KEYS, model=copy.deepcopy(MODEL), optimizer=dict(OPTIMIZER),
        scheduler=dict(SCHEDULER), train=dict(type="MSCTrainer"),
        hooks=[dict(type="IterationTimer"), dict(type="InformationWriter", log_interval=1)],
        data=dict(num_classes=20, ignore_index=-1, train=dataset_cfg(rooms)))))


def test_msc_trainer_step_matches_jax(rooms, ref, tmp_path, jax_numpy_host_ops):
    """`MSCTrainer`'s loader batch and step (SGD + OneCycle) against
    JAX's `make_msc_train_step` from the same weights: the loss and the
    contrast metrics, then every updated parameter within 1e-5 of the
    tensor's largest value; then the trainer's whole epoch (2 steps)."""
    tr = TRAINERS.build(dict(type="MSCTrainer"), cfg=trainer_cfg(rooms, str(tmp_path)),
                        device="cpu")
    load_jax_variables(tr.model, copy.deepcopy(ref["variables"]))
    batch = next(tr.train_loader.epoch(0))
    assert_same(batch, ref["batches"][0])
    metrics = tr.train_step(tr.batch_to_points(batch), seed=torch.tensor(SEED),
                            score=T(ref["score"]))
    for k in ("loss", "nce_loss", "pos_sim", "neg_sim"):
        np.testing.assert_allclose(metrics[k].item(), ref["step_metrics"][k], rtol=1e-5)
    assert int(metrics["valid_points"]) == ref["step_metrics"]["valid_points"]
    want = dict(port_model(dict(params=ref["step_params"], batch_stats=ref["variables"][
        "batch_stats"])).named_parameters())
    for name, p in tr.model.named_parameters():
        err = (p - want[name]).abs().max().item()
        assert err <= 1e-5 * want[name].abs().max().item(), (name, err)

    token = tr.model.mask_token.detach().clone()
    tr.train()
    assert tr.step == 1 + tr.steps_per_epoch == 3
    assert np.isfinite(tr.comm_info["metrics"]["nce_loss"])
    assert not torch.equal(tr.model.mask_token, token)
