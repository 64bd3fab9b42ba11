"""PTv1 and farthest-point sampling in the port against the JAX package:
both FPS functions index for index (grid scenes with exact distance ties,
several scenes, per-scene quotas, padding, coincident points, a one-point
scene and an empty scene id), PT-v1 at a narrow width in f32 (eval logits;
one training forward and backward: loss, every gradient, the running
statistics), one `make_train_step` step of `DefaultSegmentor(PT-v1)` with
AdamW + OneCycle against JAX's step and optax, and the registered
Seg26/38/50 depths. Inputs and weights are made with numpy from a seed;
weights are carried across with `load_jax_variables`.

The batch is 4,096 slots of two synthetic scenes at 4 cm spacing. Its FPS
levels hold 3,686 / 920 / 230 / 56 / 14 valid points (capacities 4,096 /
1,024 / 256 / 64 / 16; each scene takes a quarter of its points per
level).

Nearly every bias of PT-v1 feeds a train-mode BatchNorm that cancels it
(directly, through the attention's shift-invariant softmax, or through the
blocks' ``bn2``), so its exact gradient is zero and both packages return
f32 rounding noise there. The gradient tests hold every tensor to
`test_torch_train.py`'s bound, except the tensors whose JAX gradient lies
below 1e-4 of the largest: those must lie below it in the port too
(`NOISE`). AdamW's first step moves each weight by the learning rate in
the direction of its gradient's sign, so the step test allows twice that
learning rate at the elements whose JAX gradient lies within the gradient
bound of 0, where the sign is not determined."""

import copy

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from cdsegnet_tpu.engine.optimizer import build_optimizer as jbuild_optimizer  # noqa: E402
from cdsegnet_tpu.models import losses as jl  # noqa: E402
from cdsegnet_tpu.models import ptv1 as jptv1  # noqa: E402
from cdsegnet_tpu.models.builder import build_model as jbuild  # noqa: E402
from cdsegnet_tpu.models.structure import make_point_batch as jmake  # noqa: E402
from cdsegnet_tpu.ops import pointops as jops  # noqa: E402
from cdsegnet_torch.engine.optimizer import build_optimizer  # noqa: E402
from cdsegnet_torch.engine.state import make_train_step  # noqa: E402
from cdsegnet_torch.models.builder import build_model as tbuild  # noqa: E402
from cdsegnet_torch.models.builder import build_model_criteria  # noqa: E402
from cdsegnet_torch.ops import pointops as tops  # noqa: E402
from cdsegnet_torch.utils.synthetic import synthetic_arrays  # noqa: E402
from cdsegnet_torch.utils.weights import load_jax_variables  # noqa: E402
from test_torch_model import as_numpy, random_variables, to_port  # noqa: E402

torch.set_num_threads(2)
T = lambda x: torch.from_numpy(np.array(x))
N = 4096
MODEL = dict(type="PT-v1", in_channels=6, num_classes=5, channels=(8, 8, 16, 16, 16),
             depths=(1, 2, 1, 1, 1), share_planes=4, nsample=(4, 8, 8, 8, 8),
             capacity_div=(1, 4, 16, 64, 256))
CRITERIA = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)]
# configs/scannet/ptv1.py's optimizer and schedule
ADAMW = dict(type="AdamW", lr=0.005, weight_decay=0.02)
ONECYCLE = dict(type="OneCycleLR", pct_start=0.05, anneal_strategy="cos", div_factor=10.0,
                final_div_factor=1000.0)
NOISE = 1e-4  # of the largest gradient: a tensor whose exact gradient is zero


def point():
    """N slots of two synthetic scenes at 4 cm spacing (see the module
    docstring for the level sizes)."""
    a = synthetic_arrays(N, 2, depth=9, seed=3)
    a["coord"] = a["coord"] * 2.0
    a["segment"] = a["segment"] % 5
    return jmake(**{k: jnp.asarray(v) for k, v in a.items()}, depth=9, num_scenes=2)


def grid_scenes(seed):
    """600 slots of points on a 6^3 grid at 5 cm (every distance ties with
    many others; repeated cells are coincident points): scenes 0, 1 and 3
    (scene 2 empty), scene 3 a single point, 15% padding."""
    rng = np.random.RandomState(seed)
    n = 600
    coord = (rng.randint(0, 6, size=(n, 3)) * 0.05).astype(np.float32)
    batch = np.sort(rng.choice([0, 1], size=n)).astype(np.int32)
    mask = rng.rand(n) < 0.85
    batch[-1], mask[-1] = 3, True
    return coord, batch, mask


# (seed, n_samples, stride): stride 4 and 2; more samples than the quotas
# (unused slots N) and fewer
FPS_CASES = [(0, 160, 4), (1, 330, 2), (2, 40, 4), (3, 160, 4)]


def _fps_ref(case):
    seed, n_samples, stride = case
    coord, batch, mask = grid_scenes(seed)
    fn = jax.jit(jops.farthest_point_sampling_batched,
                 static_argnames=("n_samples", "stride", "num_scenes"))
    batched = fn(jnp.asarray(coord), jnp.asarray(batch), jnp.asarray(mask),
                 n_samples=n_samples, stride=stride, num_scenes=4)
    plain = jops.farthest_point_sampling(jnp.asarray(coord), 64, jnp.asarray(mask),
                                         start=seed)
    return dict(batched=np.asarray(batched), plain=np.asarray(plain))


def _eval_ref(_):
    pt = point()
    jm = jbuild(copy.deepcopy(MODEL))
    v = random_variables(jm, pt, train=False)
    out = jax.jit(lambda v, p: jm.apply(v, p, train=False).feat)(v, pt)
    return dict(variables=as_numpy(v), out=np.asarray(out))


def _train_ref(_):
    """The backbone's training forward, CE on its logits, the gradients and
    the new running statistics."""
    pt = point()
    jm = jbuild(copy.deepcopy(MODEL))
    v = as_numpy(random_variables(jm, pt, train=False))
    crit = jl.Criteria(CRITERIA, loss_type="EW", task_num=2)

    def loss_fn(params, stats, p):
        out, mut = jm.apply({"params": params, "batch_stats": stats}, p, train=True,
                            mutable=["batch_stats"])
        o = dict(n_pred=out.feat, n_target=p.segment, seg_valid=p.mask & (p.segment >= 0))
        return crit(o, mode="train"), mut["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], v["batch_stats"], pt)
    return dict(variables=v, loss=float(loss), grads=as_numpy(grads), stats=as_numpy(stats))


def _step_ref(_):
    """One step of `DefaultSegmentor(PT-v1)`: JAX's loss, gradients and the
    AdamW + OneCycle update of the shipped config."""
    pt = point()
    cfg = dict(type="DefaultSegmentor", backbone=dict(MODEL))
    jm = jbuild(copy.deepcopy(cfg))
    v = as_numpy(random_variables(jm, pt))
    crit = jl.Criteria(CRITERIA, loss_type="EW", task_num=2)

    def loss_fn(params, stats, p):
        out, mut = jm.apply({"params": params, "batch_stats": stats}, p, train=True,
                            mutable=["batch_stats"])
        return crit(out, mode="train"), mut["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], v["batch_stats"], pt)
    tx = jbuild_optimizer(dict(ADAMW), v["params"], dict(ONECYCLE), total_steps=10)
    updates, _ = jax.jit(tx.update)(grads, jax.jit(tx.init)(v["params"]), v["params"])
    params = jax.jit(optax.apply_updates)(v["params"], updates)
    return dict(cfg=cfg, variables=v, loss=float(loss), params=as_numpy(params),
                stats=as_numpy(stats), grads=as_numpy(grads))


JOBS = ([("fps", c) for c in FPS_CASES] + [("eval", 0), ("train", 0), ("step", 0)])


@pytest.fixture(scope="module")
def ref():
    """Every JAX reference; inputs are jit arguments, never constants."""
    fns = dict(fps=_fps_ref, eval=_eval_ref, train=_train_ref, step=_step_ref)
    return {job: fns[job[0]](job[1]) for job in JOBS}


def port_model(cfg, variables):
    m = tbuild(copy.deepcopy(cfg), device="cpu")
    load_jax_variables(m, variables)
    return m


@pytest.mark.parametrize("case", FPS_CASES, ids=[f"seed{c[0]}_n{c[1]}_s{c[2]}"
                                                 for c in FPS_CASES])
def test_batched_fps_indices_are_jax_indices(ref, case):
    """`farthest_point_sampling_batched` equals JAX's index for index: each
    scene's quota ``count // stride`` (at least 1: the one-point scene
    takes its point), unused slots N, coincident points picked after the
    rest as JAX picks them, ties to the lower index."""
    seed, n_samples, stride = case
    coord, batch, mask = grid_scenes(seed)
    got = tops.farthest_point_sampling_batched(T(coord), T(batch), T(mask), n_samples,
                                               stride, 4)
    want = ref[("fps", case)]["batched"]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    picked = want[want < len(coord)]
    counts = np.bincount(batch[mask], minlength=4)
    quota = np.where(counts > 0, np.maximum(counts // stride, 1), 0)
    if quota.sum() <= n_samples:
        assert np.bincount(batch[picked], minlength=4).tolist() == quota.tolist()
    else:
        assert len(picked) == n_samples
    assert mask[picked].all() and len(set(picked.tolist())) == len(picked)
    assert 3 in batch[picked].tolist()  # the one-point scene


@pytest.mark.parametrize("case", FPS_CASES[:2], ids=["seed0", "seed1"])
def test_plain_fps_indices_are_jax_indices(ref, case):
    """`farthest_point_sampling` equals JAX's, quirk included: the running
    minimum starts at BIG for invalid points too, the mask enters the
    argmax only; started at ``start``."""
    seed = case[0]
    coord, _, mask = grid_scenes(seed)
    got = tops.farthest_point_sampling(T(coord), 64, T(mask), start=seed)
    np.testing.assert_array_equal(got.numpy(), ref[("fps", case)]["plain"])


def test_level_sizes_are_the_documented_ones():
    m = tbuild(copy.deepcopy(MODEL), device="cpu")
    levels, down_idx, self_idx = m.precompute_geometry(to_port(point()))
    assert [lv.size for lv in levels] == [4096, 1024, 256, 64, 16]
    assert [int(lv.point.mask.sum()) for lv in levels] == [3686, 920, 230, 56, 14]
    assert [lv.dropped for lv in levels[1:]] == [0, 0, 0, 0]
    assert down_idx[0] is None
    assert [t.shape[1] for t in self_idx] == list(MODEL["nsample"])


def test_eval_logits_match_jax(ref):
    """f32 eval logits within 1e-5 of max |logits| plus 1e-6 on the valid
    slots."""
    r = ref[("eval", 0)]
    m = port_model(MODEL, r["variables"])
    pt = point()
    with torch.no_grad():
        got = m(to_port(pt)).numpy()
    valid = np.asarray(pt.mask)
    assert got.shape == (N, 5) and got.dtype == np.float32
    want = r["out"][valid]
    assert np.abs(got[valid] - want).max() <= 1e-5 * np.abs(want).max() + 1e-6


def test_train_forward_and_backward_match_jax(ref):
    """Training mode: the CE loss, every parameter's gradient (1e-4 of the
    tensor's max |g| plus 1e-6 of the largest, the bound of
    `test_torch_train.py`) and the running statistics (momentum 0.1)."""
    r = ref[("train", 0)]
    m = port_model(MODEL, r["variables"]).train()
    p = to_port(point())
    logits = m(p)
    crit = build_model_criteria(dict(criteria=CRITERIA))
    loss = crit(dict(n_pred=logits, n_target=p.segment, seg_valid=p.mask & (p.segment >= 0)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), r["loss"], rtol=1e-5)
    want = dict(port_model(MODEL, dict(params=r["grads"],
                                       batch_stats=r["variables"]["batch_stats"]))
                .named_parameters())
    largest = max(w.abs().max().item() for w in want.values())
    noise = 0
    for pname, prm in m.named_parameters():
        g, w = prm.grad, want[pname].detach()
        assert g is not None, pname
        if w.abs().max().item() < NOISE * largest:  # rounding noise in both
            noise += 1
            assert g.abs().max().item() < NOISE * largest, pname
        else:
            err = (g - w).abs().max().item()
            assert err <= 1e-4 * w.abs().max().item() + 1e-6 * largest, pname
    assert 0 < noise < len(want) // 2
    stats = dict(port_model(MODEL, dict(params=r["variables"]["params"],
                                        batch_stats=r["stats"])).named_buffers())
    for bname, b in m.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[bname].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=bname)


def test_adamw_step_of_the_segmentor_matches_jax(ref):
    """`make_train_step` over `DefaultSegmentor(PT-v1)` with the shipped
    AdamW + OneCycle: the loss, the updated parameters (within 1e-5 of each
    tensor's largest value) and the running statistics equal JAX's step
    and optax's update; FPS reports no drop."""
    r = ref[("step", 0)]
    m = port_model(r["cfg"], r["variables"])
    crit = build_model_criteria(dict(criteria=CRITERIA))
    opt = build_optimizer(dict(ADAMW), m, dict(ONECYCLE), total_steps=10, device="cpu")
    step = make_train_step(m, crit, opt, device="cpu")
    metrics = step(to_port(point()))
    np.testing.assert_allclose(metrics["loss"].item(), r["loss"], rtol=1e-5)
    assert [int(metrics[f"dropped_l{i}"]) for i in range(1, 5)] == [0, 0, 0, 0]
    want = port_model(r["cfg"], dict(params=r["params"], batch_stats=r["stats"]))
    grads = dict(port_model(r["cfg"], dict(params=r["grads"],
                                           batch_stats=r["stats"])).named_parameters())
    largest = max(g.abs().max().item() for g in grads.values())
    lr0 = ADAMW["lr"] / ONECYCLE["div_factor"]
    for (name, a), (_, b) in zip(m.named_parameters(), want.named_parameters()):
        g = grads[name].detach()
        gmax = g.abs().max().item()
        # the gradient test's tolerance: an element of the gradient within it
        # of 0 may take either sign, and Adam's first step moves it by lr0
        # in the direction of its sign
        tol = NOISE * largest if gmax < NOISE * largest else 1e-4 * gmax + 1e-6 * largest
        bound = 1e-5 * b.abs().max().item() + 2 * lr0 * (g.abs() <= tol)
        assert ((a - b).abs() <= bound).all(), (name, (a - b).abs().max().item())
    for (name, a), (_, b) in zip(m.named_buffers(), want.named_buffers()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("kind", ["PT-v1", "PointTransformer-Seg26",
                                  "PointTransformer-Seg38", "PointTransformer-Seg50"])
def test_registered_variants_take_jax_depths(kind):
    """Each registered name builds with the JAX class's default depths (and
    a config's ``depths`` overrides them, as a flax field)."""
    cfg = dict(MODEL, type=kind)
    cfg.pop("depths")
    m = tbuild(copy.deepcopy(cfg), device="cpu")
    jcls = {"PT-v1": jptv1.PointTransformerV1,
            "PointTransformer-Seg26": jptv1.PointTransformerSeg26,
            "PointTransformer-Seg38": jptv1.PointTransformerSeg38,
            "PointTransformer-Seg50": jptv1.PointTransformerSeg50}[kind]
    assert m.depths == jcls.depths
    assert tbuild(dict(cfg, depths=(1, 1, 2, 1, 1)), device="cpu").depths == (1, 1, 2, 1, 1)
