"""The port's CNF training step against the JAX package: one step's loss,
gradients and running statistics against `jax.grad`, and AdamW + OneCycle
against optax (`tests/test_torch_step_parts.py` holds the step's pieces:
losses, masked BatchNorm, stochastic depth, schedules, clipping). Inputs
and weights are made with numpy from a seed and carried across; the random
draws of the step (timesteps, noise, MSE mask) are injected into both."""

import copy
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from cdsegnet_tpu.engine.optimizer import _path_contains  # noqa: E402
from cdsegnet_tpu.engine.optimizer import build_optimizer as jbuild_optimizer  # noqa: E402
from cdsegnet_tpu.models import losses as jl  # noqa: E402
from cdsegnet_tpu.models.builder import build_model as jbuild  # noqa: E402
from cdsegnet_torch.engine.optimizer import build_optimizer  # noqa: E402
from cdsegnet_torch.engine.state import make_train_step  # noqa: E402
from cdsegnet_torch.models import losses as tl  # noqa: E402
from cdsegnet_torch.models.builder import build_model as tbuild  # noqa: E402
from cdsegnet_torch.models.builder import build_model_criteria  # noqa: E402
from cdsegnet_torch.utils.weights import load_jax_variables  # noqa: E402
from test_torch_model import N, as_numpy, batches, random_variables, tiny_cfg, to_port  # noqa: E402

torch.set_num_threads(2)
GOLDEN = json.load(open(os.path.join(os.path.dirname(__file__), "golden_losses.json")))
CRITERIA = [
    dict(type="MSELoss", loss_weight=1.0, ignore_index=-1),
    dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1),
    dict(type="LovaszLoss", mode="multiclass", loss_weight=1.0, ignore_index=-1),
]
OPTIMIZER = dict(type="AdamW", lr=0.002, weight_decay=0.05)
SCHEDULER = dict(type="OneCycleLR", pct_start=0.5, anneal_strategy="cos",
                 div_factor=10.0, final_div_factor=1000.0)
PARAM_DICTS = [dict(keyword="block", lr=0.0002)]
TOTAL_STEPS = 6
T = lambda x: torch.from_numpy(np.array(x))


def test_criteria_reject_what_jax_rejects():
    with pytest.raises(ValueError, match="unknown config keys"):
        tl.Criteria([dict(type="LovaszLoss", mdoe="multiclass")])
    with pytest.raises(ValueError, match="unknown config keys"):
        jl.Criteria([dict(type="LovaszLoss", mdoe="multiclass")])
    with pytest.raises(NotImplementedError):
        tl.Criteria([dict(type="NoSuchLoss")])
    with pytest.raises(NotImplementedError):
        jl.Criteria([dict(type="NoSuchLoss")])


def test_train_step_draws_only_from_its_seed():
    """With stochastic depth and the curve shuffle on, and nothing injected,
    the step's draws come from its own generators: the same seed gives the
    same losses, another seed other losses."""
    pt = to_port(batches()["fit"])

    def run(seed):
        torch.manual_seed(1000 + seed)  # the global generator must not matter
        m = tbuild(tiny_cfg(shuffle_orders=True, drop_path=0.3), device="cpu")
        opt = build_optimizer(OPTIMIZER, m, SCHEDULER, TOTAL_STEPS, PARAM_DICTS,
                              device="cpu")
        step = make_train_step(m, build_model_criteria(train_cfg()), opt, seed=seed,
                               device="cpu")
        return np.array([step(pt)["loss"].item() for _ in range(3)])

    l0, l0b, l1 = run(0), run(0), run(1)
    # the same draws: equal but for the CPU BLAS, whose sums may round
    # differently between calls (an ulp in the stem's weight gradient, which
    # Adam turns into an lr-sized step of a noise-level element: the third
    # loss moves by a few 1e-6); another seed moves every loss by over 1e-3
    np.testing.assert_allclose(l0b, l0, rtol=1e-4)
    assert np.isfinite(l0).all()
    assert (np.abs(l1 - l0) > 1e-3 * l0).all()


# ---- one training step against jax.grad ----

def jax_train_out(mdl, point, ts_scene, noise, mse_valid):
    """The JAX training forward composed from the package's public pieces,
    as `CNFSegmentor.__call__` composes them, with the draws injected."""
    seg_valid = point.mask & (point.segment >= 0)
    c_x0 = mdl._c_x0(point)
    ts_pt = jnp.take(ts_scene, jnp.clip(point.batch, 0, point.num_scenes - 1))
    t_emb = mdl._scene_t_emb(ts_scene, point.batch)
    c_feat = mdl.schedule.q_sample(c_x0, ts_pt, noise)
    c_out, n_out = mdl.backbone(point, point.replace(feat=c_feat), t_emb=t_emb,
                                train=True)
    return dict(c_pred=c_out.feat, c_target=noise, n_pred=n_out.feat,
                n_target=point.segment, seg_valid=seg_valid, mse_valid=mse_valid)


def train_cfg(**backbone):
    cfg = tiny_cfg(shuffle_orders=False, drop_path=0.0, **backbone)
    cfg.update(criteria=copy.deepcopy(CRITERIA), loss_type="GLS", task_num=2)
    return cfg


def draws(seed, point):
    rng = np.random.RandomState(seed)
    return dict(ts_scene=rng.randint(0, 50, point.num_scenes).astype(np.int32),
                noise=rng.randn(N, 6).astype(np.float32),
                mse_valid=np.asarray(point.mask) & (rng.rand(N) < 0.5))


@pytest.fixture(scope="module")
def jref():
    """JAX losses, gradients and new running statistics of one step on both
    batches, and three AdamW + OneCycle steps on the batch that fits."""
    pts = batches()
    jm = jbuild(train_cfg())
    crit = jl.Criteria(CRITERIA, loss_type="GLS", task_num=2)
    variables = as_numpy(random_variables(jm, pts["fit"]))
    rngs = dict(dropout=jax.random.PRNGKey(0))  # drop_path is 0: unused draws

    def loss_fn(params, stats, point, d):
        out, mutated = jm.apply({"params": params, "batch_stats": stats}, point,
                                d["ts_scene"], d["noise"], d["mse_valid"],
                                method=jax_train_out, mutable=["batch_stats"],
                                rngs=rngs)
        return crit(out, mode="train"), mutated["batch_stats"]

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    geometry = jax.jit(lambda p: jm.backbone.precompute_geometry(p))
    res = dict(points=pts, variables=variables)
    for i, (name, pt) in enumerate(pts.items()):
        d = draws(10 + i, pt)
        (loss, stats), grads = grad_fn(variables["params"], variables["batch_stats"],
                                       pt, {k: jnp.asarray(v) for k, v in d.items()})
        res[name] = dict(draws=d, loss=float(loss), grads=as_numpy(grads),
                         stats=as_numpy(stats), dropped=[
                             int(lv.dropped) for lv in geometry(pt)[0][1:]])

    tx = jbuild_optimizer(OPTIMIZER, variables["params"], SCHEDULER, TOTAL_STEPS,
                          PARAM_DICTS)
    # jitted: eager, every op of the update compiles for each tensor shape
    tx_update, apply_updates = jax.jit(tx.update), jax.jit(optax.apply_updates)
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = jax.jit(tx.init)(params)
    fixed = jax.tree_util.tree_map(jnp.asarray, res["fit"]["grads"])
    p_fixed, s_fixed = params, opt_state
    losses, step_draws = [], []
    for k in range(3):
        # the optimizer alone: the same (step-0) gradients every update
        upd, s_fixed = tx_update(fixed, s_fixed, p_fixed)
        p_fixed = apply_updates(p_fixed, upd)
        # whole steps: forward, backward, update, new running statistics
        d = draws(20 + k, pts["fit"])
        step_draws.append(d)
        (loss, stats), grads = grad_fn(params, stats, pts["fit"],
                                       {k2: jnp.asarray(v) for k2, v in d.items()})
        upd, opt_state = tx_update(grads, opt_state, params)
        params = apply_updates(params, upd)
        losses.append(float(loss))
    res.update(opt_fixed=as_numpy(p_fixed), steps=dict(
        draws=step_draws, losses=losses, params=as_numpy(params), stats=as_numpy(stats)))
    return res


def port_model(jref, **backbone):
    m = tbuild(train_cfg(**backbone), device="cpu")
    load_jax_variables(m, jref["variables"])
    return m


def bridged(jref, params=None, stats=None):
    """A JAX params or batch_stats tree in the port's names, through the
    weight bridge: ``{name: tensor}``."""
    v = jref["variables"]
    m = tbuild(train_cfg(), device="cpu")
    load_jax_variables(m, dict(params=v["params"] if params is None else params,
                               batch_stats=v["batch_stats"] if stats is None else stats))
    return dict(m.named_parameters()) if stats is None else dict(m.named_buffers())


def port_inject(d):
    return dict(ts_scene=T(d["ts_scene"]), noise=T(d["noise"]),
                mse_valid=T(d["mse_valid"]))


def assert_grads_match(model, jref, batch):
    # per tensor: max |dg| <= 1e-4 * max |g_jax| (f32 on both sides; sums in
    # another order through some forty layers), plus 1e-6 of the largest
    # gradient of all: a bias that only batch-statistic norms read has a
    # gradient that is zero but for f32 rounding noise of that size
    want = bridged(jref, params=jref[batch]["grads"])
    floor = 1e-6 * max(w.abs().max().item() for w in want.values())
    for name, p in model.named_parameters():
        g, w = p.grad, want[name].detach()
        assert g is not None, name
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() + floor, name


def _zero_rows_without_keys(zeroed):
    from cdsegnet_torch.ops.attention import patch_attention

    def attn(q, k, v, batch_sorted, valid_sorted, patch_size, scale,
             upcast_softmax=True):
        out = patch_attention(q, k, v, batch_sorted, valid_sorted, patch_size,
                              scale, upcast_softmax=upcast_softmax)
        bp = batch_sorted.view(-1, patch_size)
        has = ((bp[:, :, None] == bp[:, None, :])
               & valid_sorted.view(-1, 1, patch_size)).any(-1).view(-1, 1, 1)
        zeroed.append(int((~has & (out != 0)).sum()))
        return torch.where(has, out, torch.zeros((), dtype=out.dtype))

    return attn


@pytest.mark.parametrize("rows", ["plain", "zeroed"])
@pytest.mark.parametrize("batch", ["overflow", "fit"])
def test_train_step_gradients_match_jax(jref, batch, rows, monkeypatch):
    """Loss, every parameter's gradient and the new running statistics of
    one step. ``zeroed``: the plain attention route writes zeros on rows
    with no allowed key, as the CUDA kernel does, where JAX gives the
    uniform mean; no gradient may depend on which."""
    zeroed = []
    if rows == "zeroed":
        from cdsegnet_torch.models import ptv3

        monkeypatch.setattr(ptv3, "attention_impl",
                            lambda use_pallas: _zero_rows_without_keys(zeroed))
    pt = jref["points"][batch]
    m = port_model(jref).train()
    out = m(to_port(pt), **port_inject(jref[batch]["draws"]))
    assert out["pyramid_dropped"] == jref[batch]["dropped"]
    assert (sum(jref[batch]["dropped"]) > 0) == (batch == "overflow")
    loss = build_model_criteria(train_cfg())(out, mode="train")
    loss.backward()
    assert (sum(zeroed) > 0) == (rows == "zeroed")
    np.testing.assert_allclose(loss.item(), jref[batch]["loss"], rtol=1e-5)
    assert_grads_match(m, jref, batch)
    want = bridged(jref, stats=jref[batch]["stats"])
    for name, b in m.named_buffers():
        np.testing.assert_allclose(b.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def port_optimizer(model):
    return build_optimizer(OPTIMIZER, model, SCHEDULER, TOTAL_STEPS, PARAM_DICTS,
                           device="cpu")


def test_block_group_holds_the_tensors_jax_labels(jref):
    params = jref["variables"]["params"]
    flags = jax.tree_util.tree_map_with_path(
        lambda path, x: np.full(np.shape(x), float(_path_contains(path, "block")),
                                np.float32), params)
    jax_block = {n for n, p in bridged(jref, params=flags).items()
                 if bool(p.detach().flatten()[0])}
    labels = port_optimizer(port_model(jref)).labels
    assert {n for n, g in labels.items() if g == "group0"} == jax_block
    assert 0 < len(jax_block) < len(labels)


def test_optimizer_matches_optax_on_the_same_gradients(jref):
    """Three AdamW + OneCycle updates from the same gradients (JAX's, bridged)
    on both sides: the optimizer alone."""
    m = port_model(jref)
    opt = port_optimizer(m)
    grads = bridged(jref, params=jref["fit"]["grads"])
    lrs = []
    for _ in range(3):
        lrs.append(opt.lrs())
        for name, p in m.named_parameters():
            p.grad = grads[name].detach().clone()
        opt.step()
    assert lrs[0]["default"] == pytest.approx(2e-4, rel=1e-6)  # sched(0) = lr / 10
    want = bridged(jref, params=jref["opt_fixed"])
    for name, p in m.named_parameters():
        lr = max(step[opt.labels[name]] for step in lrs)
        # an update is about lr per element: 1e-3 of it, plus f32 rounding
        # of p at each of the 3 updates (half an ulp each, and the update's)
        tol = 1e-3 * lr + 4 * 1.2e-7 * want[name].abs().max().item()
        assert (p - want[name]).abs().max().item() <= tol, name


def test_three_train_steps_match_jax(jref):
    """Three whole steps through `make_train_step` (AdamW + OneCycle, the
    "block" group, GLS), with the draws injected."""
    m = port_model(jref)
    opt = port_optimizer(m)
    step = make_train_step(m, build_model_criteria(train_cfg()), opt, device="cpu")
    pt = to_port(jref["points"]["fit"])
    losses, lrs = [], []
    for k in range(3):
        lrs.append(opt.lrs())
        metrics = step(pt, **port_inject(jref["steps"]["draws"][k]))
        losses.append(metrics["loss"].item())
        assert metrics["valid_points"].item() == int(pt.mask.sum())
        assert [metrics[f"dropped_l{i}"] for i in range(1, 5)] == [0, 0, 0, 0]
    np.testing.assert_allclose(losses, jref["steps"]["losses"], rtol=1e-4)
    want = bridged(jref, params=jref["steps"]["params"])
    g0 = bridged(jref, params=jref["fit"]["grads"])
    g_max = max(g.abs().max().item() for g in g0.values())
    for name, p in m.named_parameters():
        d = (p - want[name]).abs().detach()
        lr_g = max(step_lr[opt.labels[name]] for step_lr in lrs)
        # Adam divides each gradient by its own running magnitude, so an
        # element whose gradient is at rounding-noise level takes a full
        # +-lr step whose sign is the noise's: up to 2 lr apart per update,
        # 6 lr over three. A bias that only batch-statistic norms read has
        # such a gradient throughout (zero but for noise, under 1e-6 of the
        # largest); every other tensor's median element agrees to 1e-3 lr
        assert d.max().item() <= 6 * lr_g + 1e-6, name
        if g0[name].abs().max().item() > 1e-6 * g_max:
            tol = 1e-3 * lr_g + 4 * 1.2e-7 * want[name].abs().max().item()
            assert d.median().item() <= tol, name
    # the running statistics take momentum 0.01 of each step's batch
    # statistics, which come from parameters held only as above: a batch
    # mean that moves by 1e-3 of its size ~1 moves them by 1e-5 a step
    stats = bridged(jref, stats=jref["steps"]["stats"])
    for name, b in m.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[name].numpy(), rtol=1e-4,
                                   atol=3 * 1e-5, err_msg=name)
