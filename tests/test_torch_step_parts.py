"""The pieces of the port's CNF training step against the JAX package: the
losses and `Criteria` (GLS and EW; focal, binary focal and Dice with their
gradients), `subsample_valid`, masked BatchNorm in training mode, stochastic
depth, the learning-rate schedules and keyword gradient clipping.
`tests/test_torch_train.py` holds the whole step against `jax.grad` and
optax, and the constants shared here."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cdsegnet_tpu.models import losses as jl  # noqa: E402
from cdsegnet_tpu.models import modules as jmod  # noqa: E402
from cdsegnet_torch.engine.optimizer import onecycle_schedule  # noqa: E402
from cdsegnet_torch.models import losses as tl  # noqa: E402
from cdsegnet_torch.models.modules import MaskedBatchNorm  # noqa: E402
from test_torch_train import CRITERIA, GOLDEN, T  # noqa: E402

torch.set_num_threads(2)


# ---- losses ----

def _golden():
    logits = np.array(GOLDEN["logits"], np.float32)
    labels = np.array(GOLDEN["labels"], np.int32)
    return logits, labels, labels >= 0


@pytest.mark.parametrize("loss", ["ce", "lovasz"])
def test_golden_losses_match_jax(loss):
    logits, labels, valid = _golden()
    fn_t = tl.cross_entropy_loss if loss == "ce" else tl.lovasz_softmax_loss
    fn_j = jl.cross_entropy_loss if loss == "ce" else jl.lovasz_softmax_loss
    got = fn_t(T(logits), T(labels), T(valid)).item()
    want = float(fn_j(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(valid)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, GOLDEN[loss], rtol=1e-5)  # as the JAX test


def test_cross_entropy_options_match_jax():
    logits, labels, valid = _golden()
    w = np.linspace(0.5, 2.0, logits.shape[1]).astype(np.float32)
    for kw in (dict(label_smoothing=0.1), dict(weight=w)):
        got = tl.cross_entropy_loss(T(logits), T(labels), T(valid), **kw).item()
        want = float(jl.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                           jnp.asarray(valid), **kw))
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("snr", [False, True])
def test_mse_matches_jax(snr):
    rng = np.random.RandomState(0)
    pred, target = (rng.randn(300, 6).astype(np.float32) for _ in range(2))
    valid = rng.rand(300) < 0.6
    w = (rng.rand(300) * 3).astype(np.float32) if snr else None
    got = tl.mse_loss(T(pred), T(target), T(valid), None if w is None else T(w)).item()
    want = float(jl.mse_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(valid),
                             None if w is None else jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("loss_type", ["GLS", "EW"])
def test_criteria_match_jax(loss_type):
    rng = np.random.RandomState(1)
    n, c = 400, 7
    out = dict(c_pred=rng.randn(n, 6), c_target=rng.randn(n, 6),
               n_pred=3 * rng.randn(n, c), n_target=rng.randint(-1, c, n),
               seg_valid=np.arange(n) < 350, mse_valid=rng.rand(n) < 0.3)
    out = {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in out.items()}
    out["seg_valid"] &= out["n_target"] >= 0
    got = tl.Criteria(CRITERIA, loss_type, 2)({k: T(v) for k, v in out.items()}).item()
    want = float(jl.Criteria(CRITERIA, loss_type, 2)(
        {k: jnp.asarray(v) for k, v in out.items()}))
    np.testing.assert_allclose(got, want, rtol=1e-6)


OTHER_LOSSES = {
    "FocalLoss": [dict(type="FocalLoss", loss_weight=0.7, gamma=2.0, alpha=0.25,
                       ignore_index=-1)],
    "BinaryFocalLoss": [dict(type="BinaryFocalLoss", loss_weight=1.3, gamma=1.5,
                             alpha=0.6)],
    "DiceLoss": [dict(type="DiceLoss", loss_weight=0.9, smooth=0.5, exponent=2.0,
                      ignore_index=-1)],
    "all": [dict(type="FocalLoss"), dict(type="DiceLoss"),
            dict(type="CrossEntropyLoss", loss_weight=1.0)],
}


@pytest.mark.parametrize("case", sorted(OTHER_LOSSES))
def test_other_losses_and_gradients_match_jax(case):
    """`FocalLoss`, `BinaryFocalLoss` and `DiceLoss` through `Criteria`:
    the value within 1e-6 relative and the gradient of the logits at
    `assert_grads_match`'s bound (1e-4 of max |g| plus 1e-6 of it). The
    binary loss takes one logit per point (``(N, 1)``: its target
    broadcasts against the logits, in both packages) and 0/1 targets (a
    target of -1 makes its focal weight NaN, in both)."""
    rng = np.random.RandomState(3)
    n, c = 300, 1 if case == "BinaryFocalLoss" else 6
    logits = (2 * rng.randn(n, c)).astype(np.float32)
    target = rng.randint(0 if c == 1 else -1, max(c, 2), n)
    valid = (target >= 0) & (rng.rand(n) < 0.9)
    cfg = OTHER_LOSSES[case]

    def jloss(x):
        return jl.Criteria(cfg)(dict(n_pred=x, n_target=jnp.asarray(target),
                                     seg_valid=jnp.asarray(valid)))

    want, want_g = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(logits))
    x = T(logits).requires_grad_()
    got = tl.Criteria(cfg)(dict(n_pred=x, n_target=T(target), seg_valid=T(valid)))
    got.backward()
    assert np.isfinite(float(want))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    want_g = np.asarray(want_g)
    assert np.isfinite(want_g).all() and np.abs(want_g).max() > 0
    bound = 1e-4 * np.abs(want_g).max() + 1e-6 * np.abs(want_g).max()
    assert np.abs(x.grad.numpy() - want_g).max() <= bound


def test_subsample_valid_keeps_the_rate_per_scene():
    n, per_scene, draws = 3000, 200, 400
    batch = np.repeat([0, 1, 2], [1500, 1000, 500]).astype(np.int32)
    valid = np.random.RandomState(2).rand(n) < 0.8
    valid[2800:] = False
    gen = torch.Generator().manual_seed(0)
    kept = np.zeros(3)
    for _ in range(draws):
        keep = tl.subsample_valid(T(valid), T(batch), 3, per_scene, gen).numpy()
        assert not (keep & ~valid).any()
        kept += np.bincount(batch[keep], minlength=3)
    counts = np.bincount(batch[valid], minlength=3)
    # each scene keeps per_scene points on average (or all when fewer):
    # a binomial mean over `draws` draws, held to 4 standard errors
    expect = np.minimum(per_scene, counts)
    rate = expect / counts
    se = np.sqrt(counts * rate * (1 - rate) / draws) + 1e-9
    assert (np.abs(kept / draws - expect) <= 4 * se + 1e-9).all(), (kept / draws, expect)


# ---- masked BatchNorm, training mode ----

def test_masked_batchnorm_training_matches_flax():
    rng = np.random.RandomState(3)
    x = (2 + 3 * rng.randn(200, 8)).astype(np.float32)
    mask = np.arange(200) < 150
    x[~mask] = 1e3  # padding rows must not touch the statistics
    variables = dict(params=dict(scale=rng.rand(8).astype(np.float32) + 0.5,
                                 bias=rng.randn(8).astype(np.float32)),
                     batch_stats=dict(mean=rng.randn(8).astype(np.float32),
                                      var=rng.rand(8).astype(np.float32) + 0.5))
    want, mutated = jmod.MaskedBatchNorm(8).apply(
        variables, jnp.asarray(x), jnp.asarray(mask), use_running_average=False,
        mutable=["batch_stats"])
    bn = MaskedBatchNorm(8)
    with torch.no_grad():
        bn.scale.copy_(T(variables["params"]["scale"]))
        bn.bias.copy_(T(variables["params"]["bias"]))
        bn.mean.copy_(T(variables["batch_stats"]["mean"]))
        bn.var.copy_(T(variables["batch_stats"]["var"]))
    got = bn.train()(T(x), T(mask))
    np.testing.assert_allclose(got.detach().numpy()[mask], np.asarray(want)[mask],
                               rtol=1e-5, atol=1e-5)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(mutated["batch_stats"][name]),
                                   rtol=1e-6, atol=1e-7)


def test_drop_path_keeps_the_rate_and_rescales():
    from cdsegnet_torch.models.modules import drop_path

    x = torch.ones((20000, 3))
    gen = torch.Generator().manual_seed(0)
    y = drop_path(x, 0.3, deterministic=False, generator=gen)
    kept = y[:, 0] != 0
    assert (y[kept] == x[kept] / torch.tensor(0.7)).all()
    assert (y[~kept] == 0).all() and (y == y[:, :1]).all()  # one draw per point
    # binomial keep rate, held to 4 standard errors
    assert abs(kept.float().mean().item() - 0.7) <= 4 * (0.7 * 0.3 / 20000) ** 0.5
    assert drop_path(x, 0.3, deterministic=True) is x
    assert drop_path(x, 0.0, deterministic=False) is x
    with pytest.raises(ValueError, match="Generator"):
        drop_path(x, 0.3, deterministic=False)


def test_onecycle_matches_jax():
    from cdsegnet_tpu.engine.optimizer import onecycle_schedule as jonecycle

    for total, pct in ((6, 0.5), (1000, 0.3), (7, 0.5)):
        got = onecycle_schedule(2e-3, total, pct, 10.0, 1000.0)
        want = jonecycle(2e-3, total, pct, 10.0, 1000.0)
        for k in range(total + 2):
            # f32 on both sides; cos differs by an ulp between numpy and XLA,
            # which near the end of the cycle is 2e-6 of the small lr there
            np.testing.assert_allclose(got(k), float(want(k)), rtol=1e-6, atol=2e-10)


@pytest.mark.parametrize("sched", [
    dict(type="MultiStepLR", milestones=[0.3, 0.32, 0.6], gamma=0.5),
    dict(type="PolyLR", power=0.9), dict(type="ExpLR", gamma=0.8),
    dict(type="CosineAnnealingLR")])
def test_other_schedules_match_jax(sched):
    from cdsegnet_tpu.engine.optimizer import build_schedule as jschedule
    from cdsegnet_torch.engine.optimizer import build_schedule

    got, want = build_schedule(sched, 2e-3, 10), jschedule(sched, 2e-3, 10)
    for k in range(12):
        np.testing.assert_allclose(got(k), float(want(k)), rtol=1e-6, atol=1e-12)


def test_clip_by_keyword_matches_jax():
    from cdsegnet_tpu.engine.optimizer import clip_by_keyword as jclip
    from cdsegnet_torch.engine.optimizer import clip_by_keyword

    rng = np.random.RandomState(5)
    grads = {"enc.block0.w": rng.randn(4, 3), "enc.block1.b": rng.randn(3),
             "head.w": rng.randn(3, 2)}
    grads = {k: v.astype(np.float32) for k, v in grads.items()}
    params = {k: torch.nn.Parameter(torch.zeros(v.shape)) for k, v in grads.items()}
    for k, p in params.items():
        p.grad = T(grads[k])
    clip_by_keyword(list(params.items()), ["block"], 0.1)
    tx = jclip(["block"], 0.1)
    want, _ = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, tx.init(None))
    for k, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[k]), rtol=1e-6, err_msg=k)
    assert not np.allclose(params["enc.block0.w"].grad.numpy(), grads["enc.block0.w"])
