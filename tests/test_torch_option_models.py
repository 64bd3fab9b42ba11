"""Whole models with the rest of the PTv3 surface in the port against the
JAX package, at a tiny width: the seeded initializer's draws for the new
tensors against flax's init; then the three option models of the H100
phase 15 (FreeU, bidirectional gated transfer, dropout and the cond xCPE;
the Restomer, a scalar gate and the blocked xCPE; RPE attention): SSI on
both batches, and one training step's loss, gradients and running
statistics, with JAX's dropout masks fed in. `tests/test_torch_options.py`
holds each option module by itself and the helpers shared here."""

import copy
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import numpy as np  # noqa: E402

from cdsegnet_tpu.models import losses as jl  # noqa: E402
from cdsegnet_tpu.models.builder import build_model as jbuild  # noqa: E402
from cdsegnet_tpu.models.segmentor import CNFSegmentor as JCNF  # noqa: E402
from cdsegnet_torch.models.builder import build_model as tbuild  # noqa: E402
from cdsegnet_torch.models.builder import build_model_criteria  # noqa: E402
from cdsegnet_torch.models.modules import DropoutDraws  # noqa: E402
from cdsegnet_torch.utils.weights import load_jax_variables  # noqa: E402
from test_torch_model import N, as_numpy, batches, random_variables, tiny_cfg, to_port  # noqa: E402
from test_torch_options import (MODELS, T, assert_close, grad_bound,  # noqa: E402
                                mask_capture, sown_masks)
from test_torch_train import CRITERIA, jax_train_out  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("gate", ["b_channel_scale", "lr_scale"])
def test_init_weights_draws_the_flax_families(gate):
    """The seeded initializer on the new tensors, against flax's init of
    the same model: the RPE table a normal of std 0.02 truncated at 2 std,
    the Restomer's temperature ones and its depthwise convs uniform on
    [-1, 1] (variance scaling over a fan-in of 3), the gate's ``feat_scale``
    ones or 0.5; the same shapes, and the same constants."""
    cfg = tiny_cfg(enable_rpe=True, tm_restomer=True, tm_bidirectional=True, tm_feat=gate)
    m = tbuild(copy.deepcopy(cfg), device="cpu")
    jm = jbuild(copy.deepcopy(cfg))
    variables = as_numpy(jax.jit(lambda p: jm.init(
        {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "dropout", "shuffle",
                                                           "diffusion"))}, p,
        train=False))(batches()["fit"]))
    ref = tbuild(copy.deepcopy(cfg), device="cpu")
    load_jax_variables(ref, variables)  # flax's draws in the port's names
    named, flax_named = dict(m.named_parameters()), dict(ref.named_parameters())
    tables = [n for n in named if n.endswith("rpe_table")]
    bb = cfg["backbone"]
    blocks = sum(sum(bb[f"{p}_depths"]) for p in ("n_enc", "n_dec", "c_enc", "c_dec"))
    assert len(tables) == blocks and all(named[n].shape == flax_named[n].shape
                                         for n in tables)
    for params in (named, flax_named):
        t = torch.cat([params[n].detach().flatten() for n in tables])
        assert t.abs().max() <= 0.04 and 0.014 < t.std() < 0.020
    for n, p in named.items():
        leaf = n.rsplit(".", 1)[-1]
        if leaf in ("temperature", "feat_scale"):
            assert torch.equal(p, flax_named[n]), n
            assert (p == (0.5 if leaf == "feat_scale" and gate.startswith("b_") else 1.0)).all()
        if leaf in ("q_dw", "kv_dw"):
            for w in (p, flax_named[n]):
                assert w.shape[:2] == (3, 1) and w.abs().max() <= 1.0 and w.std() > 0.4


# ---- whole models with the options ----

def model_cfg(name):
    return tiny_cfg(scan_blocks=False, shuffle_orders=False, drop_path=0.0,
                    **MODELS[name])


def model_reference(name):
    """JAX's weights, SSI logits on both batches, and one training step on
    the batch that fits (timesteps, noise and MSE mask injected; dropout
    masks captured), with the loss, gradients and new running statistics."""
    cfg = model_cfg(name)
    cfg.update(criteria=copy.deepcopy(CRITERIA), loss_type="GLS", task_num=2)
    jm = jbuild(copy.deepcopy(cfg))
    pts = batches()
    rng = np.random.RandomState(40)
    noise = rng.randn(N, 6).astype(np.float32)
    variables = as_numpy(random_variables(jm, pts["fit"], noise, method=JCNF.inference))
    ssi = jax.jit(lambda v, p: jm.apply(v, p, noise, method=JCNF.inference)["seg_logits"])
    logits = {b: np.asarray(ssi(variables, p)) for b, p in pts.items()}
    pt = pts["fit"]
    d = dict(ts_scene=np.array([37, 12], np.int32), noise=noise,
             mse_valid=np.asarray(pt.mask) & (rng.rand(N) < 0.5))
    crit = jl.Criteria(CRITERIA, loss_type="GLS", task_num=2)

    def loss_fn(params, stats):
        with fnn.intercept_methods(mask_capture()):
            o, mut = jm.apply({"params": params, "batch_stats": stats}, pt,
                              d["ts_scene"], d["noise"], d["mse_valid"],
                              method=jax_train_out, rngs=dict(dropout=jax.random.PRNGKey(5)),
                              mutable=["batch_stats", "intermediates"])
        return crit(o, mode="train"), (mut["batch_stats"], mut.get("intermediates", {}))

    (loss, (stats, inter)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"])
    return dict(cfg=cfg, points=pts, variables=variables, noise=noise, logits=logits,
                draws=d, loss=float(loss), grads=as_numpy(grads), stats=as_numpy(stats),
                masks=sown_masks(inter))


@pytest.fixture(scope="module")
def mref():
    """The three JAX references, compiled on parallel threads (this file
    runs late in the suite, where cores are free)."""
    with ThreadPoolExecutor(len(MODELS)) as ex:
        return dict(zip(MODELS, ex.map(model_reference, MODELS)))


def port_model(ref, params=None, stats=None):
    m = tbuild(copy.deepcopy(ref["cfg"]), device="cpu")
    v = ref["variables"]
    load_jax_variables(m, dict(params=v["params"] if params is None else params,
                               batch_stats=v["batch_stats"] if stats is None else stats))
    return m


@pytest.mark.parametrize("batch", ["fit", "overflow"])
@pytest.mark.parametrize("name", list(MODELS))
def test_option_model_ssi_matches_jax(mref, name, batch):
    ref = mref[name]
    pt = ref["points"][batch]
    got = port_model(ref).inference(to_port(pt), noise=T(ref["noise"]))["seg_logits"]
    assert_close(got.numpy(), ref["logits"][batch], np.asarray(pt.mask))


@pytest.mark.parametrize("name", list(MODELS))
def test_option_model_train_step_matches_jax(mref, name):
    """One training step: the loss, every parameter's gradient and the new
    running statistics against `jax.grad`; model (a) with JAX's dropout
    masks."""
    ref = mref[name]
    assert (len(ref["masks"]) > 0) == (name == "a")
    m = port_model(ref).train()
    d = ref["draws"]
    gens = dict(dropout=DropoutDraws(None, [T(x) for x in ref["masks"]]))
    out = m(to_port(ref["points"]["fit"]), generators=gens, ts_scene=T(d["ts_scene"]),
            noise=T(d["noise"]), mse_valid=T(d["mse_valid"]))
    assert not gens["dropout"].masks
    loss = build_model_criteria(ref["cfg"])(out, mode="train")
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    want = {n: p.detach().numpy() for n, p in
            port_model(ref, params=ref["grads"]).named_parameters()}
    grad_bound({n: p.grad.numpy() for n, p in m.named_parameters()}, want)
    stats = dict(port_model(ref, stats=ref["stats"]).named_buffers())
    for bname, b in m.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[bname].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=bname)
