"""The port's SGD and Adam against optax: 20 updates from the same gradients
with OneCycle and PolyLR and a keyword group, the coupled weight decay
against the reordered optax chain, JAX's own SGD chain under a zero
gradient (the departure), and a resumed optimizer bit-equal to an
uninterrupted one. Gradients and weights are made with numpy from a seed."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from cdsegnet_tpu.engine.optimizer import build_optimizer as jbuild_optimizer  # noqa: E402
from cdsegnet_tpu.engine.optimizer import build_schedule as jbuild_schedule  # noqa: E402
from cdsegnet_torch.engine.optimizer import build_optimizer  # noqa: E402

torch.set_num_threads(2)
STEPS = 20
SHAPES = {"block": {"weight": (5, 4), "bias": (5,)}, "head": {"weight": (3, 5)}}
SCHEDULES = {"onecycle": dict(type="OneCycleLR", pct_start=0.05, div_factor=10.0,
                              final_div_factor=10000.0),
             "poly": dict(type="PolyLR", power=0.9)}
OPTIMIZERS = {
    # the shipped SGD recipes (configs/scannet/spunet.py) without the decay
    "sgd_nesterov": dict(type="SGD", lr=0.05, momentum=0.9, nesterov=True),
    "sgd": dict(type="SGD", lr=0.24, momentum=0.8, nesterov=False),
    # JAX's Adam reads lr only: the betas and the decay here are ignored
    "adam": dict(type="Adam", lr=0.001, betas=(0.5, 0.6), weight_decay=0.1),
}
PARAM_DICTS = [dict(keyword="block", lr=0.01)]


class Tiny(torch.nn.Module):
    """Parameters named as the JAX tree's leaves (``block.weight`` for
    ``['block']['weight']``)."""

    def __init__(self, values):
        super().__init__()
        for mod, leaves in values.items():
            m = torch.nn.Module()
            for leaf, v in leaves.items():
                m.register_parameter(leaf, torch.nn.Parameter(torch.from_numpy(v.copy())))
            self.add_module(mod, m)


def draws(seed=0):
    """Initial weights and one gradient tree per update."""
    rng = np.random.RandomState(seed)
    tree = lambda: {m: {k: rng.randn(*s).astype(np.float32) for k, s in leaves.items()}
                    for m, leaves in SHAPES.items()}
    return tree(), [tree() for _ in range(STEPS)]


def port_run(cfg, sched, init, grads, param_dicts=(), steps=None, opt=None, model=None):
    model = model or Tiny(init)
    opt = opt or build_optimizer(dict(cfg), model, sched, total_steps=STEPS,
                                 param_dicts=list(param_dicts), device="cpu")
    for g in grads[:steps]:
        for name, p in model.named_parameters():
            mod, leaf = name.split(".")
            p.grad = torch.from_numpy(g[mod][leaf].copy())
        opt.step()
    return model, opt


def jax_run(tx, init, grads):
    params = jax.tree_util.tree_map(jnp.asarray, init)
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, updates)
    return jax.tree_util.tree_map(np.asarray, params)


def assert_close(model, want, rtol=2e-6):
    """Each tensor within ``rtol`` of its largest value (f32 on both sides;
    torch and XLA round the momentum and moment updates differently)."""
    for name, p in model.named_parameters():
        mod, leaf = name.split(".")
        w = want[mod][leaf]
        err = np.abs(p.detach().numpy() - w).max()
        assert err <= rtol * np.abs(w).max(), (name, err)


@pytest.mark.parametrize("sched", list(SCHEDULES))
@pytest.mark.parametrize("kind", list(OPTIMIZERS))
def test_optimizer_matches_optax_over_20_steps(kind, sched):
    """`build_optimizer` against JAX's `build_optimizer` (no decay) with the
    schedule and a keyword group at its own learning rate."""
    cfg, sc = OPTIMIZERS[kind], SCHEDULES[sched]
    init, grads = draws()
    model, opt = port_run(cfg, sc, init, grads, PARAM_DICTS)
    tx = jbuild_optimizer(dict(cfg), init, dict(sc), total_steps=STEPS,
                          param_dicts=PARAM_DICTS)
    assert_close(model, jax_run(tx, init, grads))
    assert opt.count == STEPS and opt.kind == cfg["type"]
    assert set(opt.labels.values()) == {"default", "group0"}


@pytest.mark.parametrize("nesterov", [True, False])
def test_sgd_decay_is_coupled(nesterov):
    """With weight decay the port is torch's coupled SGD: the decayed
    weights join the gradient before the momentum, i.e.
    ``chain(add_decayed_weights(wd), sgd(...))`` (JAX's own chain puts the
    decay last)."""
    cfg = dict(type="SGD", lr=0.05, momentum=0.9, nesterov=nesterov, weight_decay=1e-2)
    sc = SCHEDULES["onecycle"]
    init, grads = draws(1)
    model, _ = port_run(cfg, sc, init, grads)
    sched = jbuild_schedule(dict(sc), cfg["lr"], STEPS)
    tx = optax.chain(optax.add_decayed_weights(cfg["weight_decay"]),
                     optax.sgd(sched, momentum=0.9, nesterov=nesterov))
    assert_close(model, jax_run(tx, init, grads))


def test_jax_sgd_chain_grows_weights_under_a_zero_gradient():
    """The departure: one step at lr 0.1 and wd 1e-4 on a zero gradient
    multiplies JAX's weights by 1 + wd; the port's shrink by lr * wd * (1 +
    momentum) (the decay is the gradient; Nesterov's first step adds the
    momentum's look-ahead)."""
    cfg = dict(type="SGD", lr=0.1, momentum=0.9, nesterov=True, weight_decay=1e-4)
    init = {m: {k: np.ones(s, np.float32) for k, s in leaves.items()}
            for m, leaves in SHAPES.items()}
    zeros = [{m: {k: np.zeros(s, np.float32) for k, s in leaves.items()}
              for m, leaves in SHAPES.items()}]
    got = jax_run(jbuild_optimizer(dict(cfg), init), init, zeros)
    np.testing.assert_array_equal(got["head"]["weight"], np.float32(1.0001))
    model, _ = port_run(cfg, None, init, zeros)
    np.testing.assert_allclose(model.head.weight.detach().numpy(),
                               1.0 - 0.1 * 1e-4 * 1.9, rtol=1e-7)


@pytest.mark.parametrize("kind", list(OPTIMIZERS))
def test_resumed_optimizer_is_bit_equal(kind):
    """10 updates, the state saved and loaded into a new optimizer over a
    copy of the weights, 10 more: bit-equal to 20 uninterrupted updates
    (momentum buffers or moments and ``count`` carried)."""
    cfg, sc = dict(OPTIMIZERS[kind], weight_decay=1e-3), SCHEDULES["onecycle"]
    init, grads = draws(2)
    full, _ = port_run(cfg, sc, init, grads, PARAM_DICTS)
    half, opt = port_run(cfg, sc, init, grads, PARAM_DICTS, steps=10)
    state = opt.state_dict()
    resumed = Tiny({m: {k: getattr(getattr(half, m), k).detach().numpy() for k in leaves}
                    for m, leaves in SHAPES.items()})
    opt2 = build_optimizer(dict(cfg), resumed, sc, total_steps=STEPS,
                           param_dicts=list(PARAM_DICTS), device="cpu")
    opt2.load_state_dict(state)
    assert opt2.count == 10
    port_run(cfg, sc, init, grads[10:], opt=opt2, model=resumed)
    for (name, a), (_, b) in zip(full.named_parameters(), resumed.named_parameters()):
        assert torch.equal(a, b), name


def test_unknown_optimizer_is_refused():
    with pytest.raises(NotImplementedError, match="Lamb"):
        build_optimizer(dict(type="Lamb"), Tiny(draws()[0]), device="cpu")
