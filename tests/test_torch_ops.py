"""Port ops against the JAX package: attention, segments, subm convs,
diffusion tables. Inputs are made with numpy from a seed and fed to both."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cdsegnet_tpu.models import pyramid as jpyr  # noqa: E402
from cdsegnet_tpu.models import diffusion as jdiff  # noqa: E402
from cdsegnet_tpu.models.structure import serialize as jserialize  # noqa: E402
from cdsegnet_tpu.ops import attention as jattn  # noqa: E402
from cdsegnet_tpu.ops import segments as jseg  # noqa: E402
from cdsegnet_tpu.ops import subm_conv as jconv  # noqa: E402
from cdsegnet_tpu.ops.pallas.flash_attention import flash_patch_attention  # noqa: E402
from cdsegnet_torch.models import diffusion as tdiff  # noqa: E402
from cdsegnet_torch.ops import attention as tattn  # noqa: E402
from cdsegnet_torch.ops import segments as tseg  # noqa: E402
from cdsegnet_torch.ops import subm_conv as tconv  # noqa: E402
from cdsegnet_torch.ops.flash_attention import (  # noqa: E402
    attention_impl,
    patch_attention_fwd,
)
from helpers import synthetic_batch  # noqa: E402

torch.set_num_threads(2)
ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")


def T(x):
    return torch.from_numpy(np.array(x))


def _attn_inputs(seed=0, n=256, h=2, d=16):
    rng = np.random.RandomState(seed)
    pt = jserialize(synthetic_batch(rng, counts=(150, 80), num_points=n, depth=6),
                    orders=ORDERS, shuffle_key=None)
    q, k, v = (rng.randn(n, h, d).astype(np.float32) for _ in range(3))
    order = np.asarray(pt.orders[0])
    bs = np.asarray(pt.batch)[order].astype(np.int32)
    ms = np.asarray(pt.mask)[order]
    return q, k, v, bs, ms


@pytest.mark.parametrize("route", ["plain", "wrapper"])
@pytest.mark.parametrize("patch", [64, 128])
def test_patch_attention_matches_jax(route, patch):
    q, k, v, bs, ms = _attn_inputs()
    scale = 16 ** -0.5
    want_xla = np.asarray(jattn.patch_attention(*map(jnp.asarray, (q, k, v, bs, ms)),
                                                patch, scale))
    want_pallas = np.asarray(flash_patch_attention(
        *map(jnp.asarray, (q, k, v, bs, ms)), patch, scale, interpret=True))
    fn = tattn.patch_attention if route == "plain" else patch_attention_fwd
    got = fn(T(q), T(k), T(v), T(bs), T(ms), patch, scale).numpy()
    for want in (want_xla, want_pallas):
        np.testing.assert_allclose(got[ms], want[ms], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("patch", [64, 128])
def test_patch_attention_bf16_matches_pallas(patch):
    """The port's plain version on bf16 inputs with the softmax in f32, the
    contract `chip_smoke.py` holds the bf16 kernel to, against the TPU kernel
    in interpret mode on the same bf16 inputs. Both round p to bf16 before
    p.v, but from f32 logits and sums that round differently (mask constants
    -1e9 and -1e30, other orders of summation), so a p can land on the other
    side of a bf16 rounding boundary: valid rows agree within 2e-2 of max
    |o|, the kernels' bf16 gate on the card."""
    q, k, v, bs, ms = _attn_inputs(seed=5)
    scale = 16 ** -0.5
    want = flash_patch_attention(*(jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v)),
                                 jnp.asarray(bs), jnp.asarray(ms), patch, scale,
                                 interpret=True)
    assert want.dtype == jnp.bfloat16
    got = tattn.patch_attention(*(T(x).to(torch.bfloat16) for x in (q, k, v)), T(bs), T(ms),
                                patch, scale, upcast_softmax=True)
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy()[ms], np.asarray(want.astype(jnp.float32))[ms]
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("patch", [64, 128])
def test_patch_attention_gradient_matches_pallas_backward(patch):
    """The port's gradient of q, k and v (the wrapper, which on the CPU runs
    the plain version under autograd) against the TPU kernel's own backward,
    `jax.vjp` through the Pallas kernel in interpret mode; the output
    gradient is zero on invalid rows, as `test_pallas_attention.py` has it."""
    import jax

    q, k, v, bs, ms = _attn_inputs(seed=3)
    g = np.random.RandomState(4).randn(*q.shape).astype(np.float32)
    g[~ms] = 0.0
    scale = 16 ** -0.5
    _, vjp = jax.vjp(lambda a, b, c: flash_patch_attention(
        a, b, c, jnp.asarray(bs), jnp.asarray(ms), patch, scale, interpret=True),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    leaves = [T(x).requires_grad_(True) for x in (q, k, v)]
    out = patch_attention_fwd(*leaves, T(bs), T(ms), patch, scale)
    got = torch.autograd.grad(out, leaves, T(g))
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=5e-4, atol=5e-5,
                                   err_msg=name)


def test_cross_patch_attention_matches_jax():
    q, k, v, bs, ms = _attn_inputs(seed=1)
    rng = np.random.RandomState(2)
    # kv scene ids differ from the queries' in places, so some query rows
    # have no allowed key and take the any_ok zeroing
    kv_bs = np.where(rng.rand(len(bs)) < 0.2, 1 - np.minimum(bs, 1), bs).astype(np.int32)
    kv_ms = ms & (rng.rand(len(ms)) < 0.9)
    scale = 16 ** -0.5
    want = np.asarray(jattn.cross_patch_attention(
        *map(jnp.asarray, (q, k, v, bs, ms, kv_bs, kv_ms)), 64, 64, scale))
    got = tattn.cross_patch_attention(
        *map(T, (q, k, v, bs, ms, kv_bs, kv_ms)), 64, 64, scale).numpy()
    np.testing.assert_allclose(got[ms], want[ms], rtol=2e-4, atol=2e-5)


def test_attention_impl_dispatch():
    assert attention_impl(False) is tattn.patch_attention
    assert attention_impl(None) is patch_attention_fwd
    assert attention_impl(True) is patch_attention_fwd
    q = torch.zeros((64, 1, 16), device="meta")
    b = torch.zeros(64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        patch_attention_fwd(q, q, q, b, b.bool(), 64, 0.25)


def _segments(seed=0, n=200, m=40):
    rng = np.random.RandomState(seed)
    keys = np.sort(rng.randint(0, 60, size=n)).astype(np.int64)
    vals = rng.randn(n, 5).astype(np.float32)
    valid = rng.rand(n) < 0.7
    return keys, vals, valid, m


def test_segments_match_jax():
    keys, vals, valid, m = _segments()
    seg_j = jseg.sorted_segment_ids(jnp.asarray(keys))
    seg_t = tseg.sorted_segment_ids(T(keys))
    np.testing.assert_array_equal(seg_t.numpy(), np.asarray(seg_j))
    seg_c = np.minimum(np.asarray(seg_j), m - 1).astype(np.int32)
    for reduce in ("max", "mean"):
        want = jseg.segment_reduce(jnp.asarray(vals), jnp.asarray(seg_c), m,
                                   reduce=reduce, valid=jnp.asarray(valid))
        got = tseg.segment_reduce(T(vals), T(seg_c), m, reduce=reduce, valid=T(valid))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        tseg.segment_any(T(valid), T(seg_c), m).numpy(),
        np.asarray(jseg.segment_any(jnp.asarray(valid), jnp.asarray(seg_c), m)))
    np.testing.assert_array_equal(
        tseg.segment_first_position(T(seg_c), m + 5).numpy(),
        np.asarray(jseg.segment_first_position(jnp.asarray(seg_c), m + 5)))


@pytest.fixture(scope="module")
def conv_geometry():
    """A surface-like batch with no overflow, so the blocked (parity) forms
    are exact, and its JAX pyramid."""
    from cdsegnet_torch.utils.synthetic import synthetic_arrays

    a = synthetic_arrays(512, 2, depth=6, seed=3)
    from cdsegnet_tpu.models.structure import make_point_batch

    pt = make_point_batch(**{k: jnp.asarray(v) for k, v in a.items()},
                          depth=6, num_scenes=2)
    levels, stem = jpyr.build_pyramid(pt, strides=(2, 2), capacities=(256, 128),
                                      orders=ORDERS, shuffle_key=None, stem_kernel=5)
    assert sum(int(lv.dropped) for lv in levels[1:]) == 0
    return levels, stem


def _blocked_args(levels, to):
    return dict(grid_coord=to(levels[0].point.grid_coord), mask=to(levels[0].point.mask),
                parent_inverse=to(levels[1].parent_inverse),
                child_nbr=to(levels[1].point.neighbor_idx))


@pytest.mark.parametrize("form", ["gather", "dual", "blocked", "blocked_stem"])
def test_subm_conv_forms_match_jax(conv_geometry, form):
    levels, stem = conv_geometry
    rng = np.random.RandomState(4)
    n = levels[0].size
    fa = rng.randn(n, 6).astype(np.float32)
    fb = rng.randn(n, 5).astype(np.float32)
    wa = rng.randn(125, 6, 8).astype(np.float32) / 10
    wb = rng.randn(125, 5, 4).astype(np.float32) / 10
    bias = rng.randn(8).astype(np.float32)
    J, t_args = jnp.asarray, _blocked_args(levels, T)
    j_args = _blocked_args(levels, lambda x: x)
    if form == "gather":
        nbr = levels[0].point.neighbor_idx  # k3 table with a k3 weight
        w3 = wa[:27]
        want = [jconv.subm_conv_apply(J(fa), nbr, J(w3), J(bias))]
        got = [tconv.subm_conv_apply(T(fa), T(nbr), T(w3), T(bias))]
    elif form == "dual":
        want = jconv.dual_subm_conv_apply(J(fa), J(fb), stem, J(wa), J(wb))
        got = tconv.dual_subm_conv_apply(T(fa), T(fb), T(stem), T(wa), T(wb))
    elif form == "blocked":
        want = [jconv.blocked_subm_conv_apply(J(fa), J(wa), **j_args)]
        got = [tconv.blocked_subm_conv_apply(T(fa), T(wa), **t_args)]
        # exact reformulation of the k125 gather under no overflow
        got.append(tconv.subm_conv_apply(T(fa), T(stem), T(wa)))
        want.append(want[0])
    else:
        want = jconv.blocked_stem_apply(J(fa), J(fb), J(wa), J(wb), **j_args)
        got = tconv.blocked_stem_apply(T(fa), T(fb), T(wa), T(wb), **t_args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


@pytest.mark.parametrize("schedule,start,stop", [
    ("linear", 1e-4, 0.02), ("cosine", 0.0, 1000.0), ("sigmoid", 0.0, 1.0),
    ("laplace", 0.0, 1.0)])
def test_diffusion_tables_match_jax(schedule, start, stop):
    a = jdiff.DiffusionSchedule.create(schedule, start, stop, 1000)
    b = tdiff.DiffusionSchedule.create(schedule, start, stop, 1000)
    for f in ("betas", "alphas", "alpha_bar", "sigma", "snr"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_t_emb_matches_jax():
    # angles reach T-1 = 999 rad, where one float32 ulp is 6e-5 and exp/sin
    # round differently between the two libraries
    ts = np.array([0, 1, 500, 999], np.int32)
    np.testing.assert_allclose(tdiff.calc_t_emb(T(ts), 128).numpy(),
                               np.asarray(jdiff.calc_t_emb(jnp.asarray(ts), 128)),
                               rtol=0, atol=1e-4)
