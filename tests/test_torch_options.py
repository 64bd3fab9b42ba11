"""The rest of the PTv3 surface in the port against the JAX package: RPE
attention, FreeU, the Restomer, the transfer module's gates and its
bidirectional form, ``proj_drop`` with JAX's dropout masks, and the blocked
k27 xCPE, module by module (`tests/test_torch_option_models.py` holds whole
models with these options). Inputs and weights are made with numpy from a
seed and carried across; JAX's dropout masks are captured as it draws them
(a flax method interceptor that draws each mask as `flax.linen.Dropout`
does and sows it) and fed to the port in call order."""

import re

import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cdsegnet_tpu.models import ptv3 as jp  # noqa: E402
from cdsegnet_tpu.models.builder import build_model as jbuild  # noqa: E402
from cdsegnet_tpu.models.structure import serialize as jserialize  # noqa: E402
from cdsegnet_tpu.ops.subm_conv import blocked_k3_conv_apply as jblocked_k3  # noqa: E402
from cdsegnet_torch.models import ptv3 as tp  # noqa: E402
from cdsegnet_torch.models.builder import build_model as tbuild  # noqa: E402
from cdsegnet_torch.models.modules import DropoutDraws, SubMConv  # noqa: E402
from cdsegnet_torch.models.structure import serialize as tserialize  # noqa: E402
from cdsegnet_torch.ops.subm_conv import blocked_k3_conv_apply, subm_conv_apply  # noqa: E402
from cdsegnet_torch.utils.weights import load_jax_variables  # noqa: E402
from helpers import synthetic_batch  # noqa: E402
from test_torch_model import N, as_numpy, batches, tiny_cfg, to_port  # noqa: E402

torch.set_num_threads(2)
T = lambda x: torch.from_numpy(np.array(x))
ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")
# the three option models of the H100 phase 15, at the tiny width: (a) FreeU,
# bidirectional gated transfer, dropout, cond xCPE; (b) the Restomer, a
# scalar gate, blocked xCPE; (c) RPE attention
MODELS = {
    "a": dict(b_factor=(1.2, 1.0, 1.0, 1.0), s_factor=(0.9, 1.0, 1.0, 1.0),
              tm_bidirectional=True, tm_feat="b_channel_scale", proj_drop=0.1,
              xcpe_mode="cond"),
    "b": dict(tm_restomer=True, tm_feat="lr_scale", xcpe_mode="blocked"),
    "c": dict(enable_rpe=True),
}


def assert_close(got, want, valid=None, rel=1e-5, floor=1e-6):
    """max |got - want| <= rel * max |want| + floor (over ``valid`` rows)."""
    got, want = np.asarray(got), np.asarray(want)
    if valid is not None:
        got, want = got[valid], want[valid]
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + floor, (err, np.abs(want).max())


def grad_bound(got: dict, want: dict):
    """tests/test_torch_train.py's bound: per tensor, max |dg| <= 1e-4 of
    its max |g| plus 1e-6 of the largest gradient of all."""
    floor = 1e-6 * max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max() + floor, name


# ---- JAX's dropout masks ----

def mask_capture():
    """A flax interceptor that draws each active `Dropout` mask as flax
    does (one ``bernoulli(keep, x.shape)`` from the module's ``dropout``
    rng) and sows it as ``intermediates/mask<k>``, k the call's rank in
    trace order."""
    count = [0]

    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if not isinstance(mod, fnn.Dropout) or context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        x = args[0]
        det = kwargs.get("deterministic", args[1] if len(args) > 1 else mod.deterministic)
        if det or mod.rate == 0.0:
            return next_fun(*args, **kwargs)
        keep = 1.0 - mod.rate
        mask = jax.random.bernoulli(mod.make_rng("dropout"), keep, x.shape)
        mod.sow("intermediates", f"mask{count[0]:05d}", mask)
        count[0] += 1
        return jax.lax.select(mask, x / keep, jnp.zeros_like(x))

    return intercept


def sown_masks(intermediates) -> list:
    """The sown masks in call order, as numpy."""
    found = []

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif re.fullmatch(r"mask\d+", k):
                found.append((k, np.asarray(v[0])))

    walk(jax.tree_util.tree_map(lambda x: x, dict(intermediates)))
    return [m for _, m in sorted(found, key=lambda kv: kv[0])]


# ---- geometry shared by the module tests ----

@pytest.fixture(scope="module")
def geo():
    """Both packages' pyramids of the tiny backbone on the batch that fits
    (parity tables: the blocked xCPE is exact) and the one that overflows."""
    jm = jbuild(tiny_cfg())
    out = {}
    for name, pt in batches().items():
        jl_ = jax.jit(lambda p: jm.backbone.precompute_geometry(p))(pt)[0]
        tm = tbuild(tiny_cfg(), device="cpu")
        tl_ = tm.backbone.precompute_geometry(to_port(pt))[0]
        out[name] = dict(point=pt, jax=jl_, port=tl_)
    return out


def fill(variables, seed):
    """Numpy draws from a seed for every leaf of a flax variable tree."""
    rng = np.random.RandomState(seed)

    def draw(path, x):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return (1 + 0.1 * rng.randn(*x.shape)).astype(np.float32)
        return (rng.randn(*x.shape) / np.sqrt(x.shape[0] if len(x.shape) else 1)
                ).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


# ---- RPE attention ----

def test_rpe_attention_matches_jax():
    """The relative-position bias and the biased attention at patch 48 (as
    tests/test_model.py runs it), outputs and the table's and qkv's
    gradients."""
    pt = synthetic_batch(np.random.RandomState(0), counts=(100, 60), num_points=192)
    jpt = jserialize(pt, orders=ORDERS)
    feat = np.random.RandomState(1).randn(192, 16).astype(np.float32)
    jpt = jpt.replace(feat=jnp.asarray(feat))
    mod = jp.SerializedAttention(channels=16, num_heads=2, patch_size=48, enable_rpe=True)
    variables = as_numpy(fill(jax.eval_shape(lambda p: mod.init(jax.random.PRNGKey(0), p),
                                             jpt), 2))
    w = np.random.RandomState(3).randn(192, 16).astype(np.float32)

    def loss(params):
        return jnp.sum(mod.apply({"params": params}, jpt).feat * w)

    want = np.asarray(jax.jit(lambda v: mod.apply(v, jpt).feat)(variables))
    want_g = as_numpy(jax.jit(jax.grad(loss))(variables["params"]))

    tm = tp.SerializedAttention(16, 2, 48, enable_rpe=True)
    load_jax_variables(tm, variables)
    tpt = tserialize(to_port(pt), orders=ORDERS)
    got = tm(T(feat), tpt)
    assert_close(got.detach().numpy(), want)
    (got * T(w)).sum().backward()
    grad_bound({"rpe": tm.rpe.rpe_table.grad.numpy(), "qkv": tm.qkv.weight.grad.numpy().T},
               {"rpe": want_g["rpe"]["rpe_table"], "qkv": want_g["qkv"]["kernel"]})
    assert tm.rpe.pos_bnd == int((4 * 48) ** (1 / 3) * 2)


# ---- FreeU ----

def _fft_inputs():
    rng = np.random.RandomState(4)
    return (3 * rng.randn(300, 16) + 1).astype(np.float32)


def fourier_filter_f64(x, threshold, scale):
    """numpy float64 reference of JAX's `fourier_filter`."""
    xf = np.fft.fftshift(np.fft.fftn(x.astype(np.float64).T[None], axes=(-2, -1)),
                         axes=(-2, -1))
    crow = x.shape[0] // 2
    xf[..., crow - threshold: crow + threshold] *= scale
    return np.fft.ifftn(np.fft.ifftshift(xf, axes=(-2, -1)), axes=(-2, -1)).real[0].T


@pytest.mark.parametrize("scale", [0.9, 0.5])
def test_fourier_filter_matches_jax(scale):
    """Both f32 FFTs against numpy's float64: the port may stray from it by
    at most 4x JAX's own f32 error, and the two stay within 5x of it of each
    other. On these inputs JAX's f32 error is 1.7-1.8e-7 of max |y| and the
    port's 1.4e-7 (measured on the CPU)."""
    x = _fft_inputs()
    want = np.asarray(jp.fourier_filter(jnp.asarray(x), 1, scale))
    got = tp.fourier_filter(T(x), 1, scale).numpy()
    ref = fourier_filter_f64(x, 1, scale)
    jax_err = np.abs(want - ref).max()
    assert jax_err <= 1e-5 * np.abs(ref).max()
    assert np.abs(got - ref).max() <= 4 * jax_err
    assert np.abs(got - want).max() <= 5 * jax_err


def test_freeu_backbone_scale_matches_jax():
    x = _fft_inputs()
    x[250:] = 0.0  # padding rows enter the min/max, as in JAX
    want = np.asarray(jp.freeu_backbone_scale(jnp.asarray(x), 1.2))
    got = tp.freeu_backbone_scale(T(x), 1.2).numpy()
    assert_close(got, want)
    assert not np.allclose(got, x)


# ---- Restomer, gates, bidirectional transfer ----

def _level_points(geo, level=4, batch="fit"):
    g = geo[batch]
    return g["jax"][level].point, g["port"][level].point


def test_cross_restomer_matches_jax(geo):
    jpt, tpt = _level_points(geo)
    n = jpt.num_points
    rng = np.random.RandomState(5)
    qf, kvf = rng.randn(n, 16).astype(np.float32), rng.randn(n, 8).astype(np.float32)
    mod = jp.CrossRestomer(q_channels=16, kv_channels=8, num_heads=2)
    jq, jkv = jpt.replace(feat=jnp.asarray(qf)), jpt.replace(feat=jnp.asarray(kvf))
    variables = as_numpy(fill(jax.eval_shape(
        lambda a, b: mod.init(jax.random.PRNGKey(0), a, b), jq, jkv), 6))
    variables["params"]["temperature"] = np.array([[[0.7]], [[1.3]]], np.float32)
    want = np.asarray(jax.jit(lambda v: mod.apply(v, jq, jkv).feat)(variables))
    tm = tp.CrossRestomer(16, 8, 2)
    load_jax_variables(tm, variables)
    with torch.no_grad():
        got = tm(T(qf), tpt, T(kvf), tpt).numpy()
    assert_close(got, want)


def _cross_block_case(geo, jmod, tmod, seed):
    """Outputs of one CrossBlock-shaped module (n at level 4 queries c) and
    the gradients of every parameter, both packages."""
    jpt, tpt = _level_points(geo)
    n = jpt.num_points
    rng = np.random.RandomState(seed)
    qf, kvf = rng.randn(n, 16).astype(np.float32), rng.randn(n, 16).astype(np.float32)
    jq, jkv = jpt.replace(feat=jnp.asarray(qf)), jpt.replace(feat=jnp.asarray(kvf))
    variables = as_numpy(fill(jax.eval_shape(
        lambda a, b: jmod.init(jax.random.PRNGKey(0), a, b), jq, jkv), seed + 1))
    w1, w2 = rng.randn(n, 16).astype(np.float32), rng.randn(n, 16).astype(np.float32)
    valid = np.asarray(jpt.mask)

    def out(params):
        a, b = jmod.apply({"params": params}, jq, jkv)
        return a.feat, b.feat

    def loss(params):
        a, b = out(params)
        m = jnp.asarray(valid)[:, None]
        return jnp.sum(jnp.where(m, a * w1 + b * w2, 0.0))

    want = [np.asarray(o) for o in jax.jit(out)(variables["params"])]
    want_g = as_numpy(jax.jit(jax.grad(loss))(variables["params"]))
    load_jax_variables(tmod, variables)
    got = tmod(T(qf), tpt, T(kvf), tpt)
    for g, w in zip(got, want):
        assert_close(g.detach().numpy(), w, valid)
    m = T(valid)[:, None]
    torch.where(m, got[0] * T(w1) + got[1] * T(w2), 0.0).sum().backward()
    grads = {n_: p.grad.numpy() for n_, p in tmod.named_parameters()}
    ref = {}
    for path, g in jax.tree_util.tree_flatten_with_path(want_g)[0]:
        keys = [k.key for k in path]
        if keys[-1] == "kernel":
            keys[-1], g = "weight", np.asarray(g).T
        ref[".".join(keys)] = np.asarray(g)
    assert ref.keys() == grads.keys()
    grad_bound(grads, ref)
    return tmod


@pytest.mark.parametrize("gate", ["channel_scale", "b_channel_scale", "lr_scale",
                                  "b_lr_scale", 0.7])
def test_cross_block_gate_matches_jax(geo, gate):
    """Each learned fusion gate and a scalar one: outputs (q and the kv
    branch's norm1) and every gradient, ``feat_scale``'s included."""
    jmod = jp.CrossBlock(q_channels=16, kv_channels=16, num_heads=2, patch_size=64,
                         mlp_ratio=2.0, tm_feat=gate)
    tmod = tp.CrossBlock(16, 16, 2, 64, mlp_ratio=2.0, tm_feat=gate)
    tmod = _cross_block_case(geo, jmod, tmod, 7)
    if isinstance(gate, str):
        assert tmod.feat_scale.shape == ((1, 16) if "channel" in gate else (1,))


def test_bidirectional_transfer_matches_jax(geo):
    """`TransferModule(bidirectional=True)`: ``cross_block1`` (c queries n)
    then ``cross_block2``; both outputs and every gradient."""
    jmod = jp.TransferModule(q_channels=16, kv_channels=16, q_num_heads=2,
                             kv_num_heads=2, patch_size=64, mlp_ratio=2.0,
                             bidirectional=True, tm_feat="b_channel_scale")
    tmod = tp.TransferModule(16, 16, 2, 64, kv_num_heads=2, bidirectional=True,
                             mlp_ratio=2.0, tm_feat="b_channel_scale")
    # both take (c, n) and give (c, n)
    _cross_block_case(geo, jmod, tmod, 8)
    assert tmod.cross_block1 is not None


# ---- proj_drop ----

def test_proj_drop_block_matches_jax(geo):
    """A Block in training with ``proj_drop=0.2``: JAX's three dropout masks
    (attention projection, after the GELU, after fc2) captured and fed to
    the port; outputs and gradients."""
    g = geo["fit"]
    jpt, tpt = g["jax"][0].point, g["port"][0].point
    rng = np.random.RandomState(9)
    feat = rng.randn(N, 8).astype(np.float32)
    jmod = jp.Block(channels=8, num_heads=1, patch_size=64, mlp_ratio=2.0, proj_drop=0.2)
    jx = jpt.replace(feat=jnp.asarray(feat))
    variables = as_numpy(fill(jax.eval_shape(
        lambda p: jmod.init(jax.random.PRNGKey(0), p), jx), 10))
    w = rng.randn(N, 8).astype(np.float32)
    valid = np.asarray(jpt.mask)

    def run(params):
        with fnn.intercept_methods(mask_capture()):
            out, mut = jmod.apply({"params": params}, jx, False, rngs=dict(
                dropout=jax.random.PRNGKey(11)), mutable=["intermediates"])
        return jnp.sum(jnp.where(jnp.asarray(valid)[:, None], out.feat * w, 0.0)), (
            out.feat, mut["intermediates"])

    (_, (want, inter)), want_g = jax.jit(jax.value_and_grad(run, has_aux=True))(
        variables["params"])
    masks = sown_masks(inter)
    assert [m.shape for m in masks] == [(N, 8), (N, 16), (N, 8)]
    assert 0.7 < np.mean([m.mean() for m in masks]) < 0.9
    tm = tp.Block(8, 1, 64, mlp_ratio=2.0, proj_drop=0.2).train()
    load_jax_variables(tm, variables)
    draws = DropoutDraws(None, [T(m) for m in masks])
    got = tm(T(feat), tpt, generator=draws)
    assert not draws.masks  # every mask used
    assert_close(got.detach().numpy(), np.asarray(want), valid)
    torch.where(T(valid)[:, None], got * T(w), 0.0).sum().backward()
    assert_close(tm.mlp.fc1.weight.grad.numpy().T, want_g["mlp"]["fc1"]["kernel"], rel=1e-4)
    assert_close(tm.attn.qkv.weight.grad.numpy().T, want_g["attn"]["qkv"]["kernel"],
                 rel=1e-4)


# ---- the blocked k27 xCPE ----

def _xcpe_operands(geo, batch, level):
    g = geo[batch]
    out = []
    for lv in (g["jax"], g["port"]):
        out.append(dict(grid_coord=lv[level].point.grid_coord, mask=lv[level].point.mask,
                        parent_inverse=lv[level + 1].parent_inverse,
                        child_nbr=lv[level + 1].point.neighbor_idx))
    return out


@pytest.mark.parametrize("level", [0, 1, 3])
def test_blocked_xcpe_matches_jax_and_gather(geo, level):
    """`blocked_k3_conv_apply` against JAX's at each level's real geometry,
    and, with no overflow, against the port's (N, 27) gather."""
    g = geo["fit"]
    assert sum(int(lv.dropped) for lv in g["jax"][1:]) == 0
    jops, tops = _xcpe_operands(geo, "fit", level)
    n = int(g["jax"][level].point.num_points)
    rng = np.random.RandomState(12 + level)
    feat = rng.randn(n, 8).astype(np.float32)
    weight = (rng.randn(27, 8, 6) / 8).astype(np.float32)
    bias = rng.randn(6).astype(np.float32)
    want = np.asarray(jax.jit(lambda f, w, b: jblocked_k3(f, w, bias=b, **jops))(
        feat, weight, bias))
    got = blocked_k3_conv_apply(T(feat), T(weight), bias=T(bias), **tops).numpy()
    valid = np.asarray(g["jax"][level].point.mask)
    assert_close(got, want, valid)
    gathered = subm_conv_apply(T(feat), g["port"][level].point.neighbor_idx, T(weight),
                               T(bias)).numpy()
    assert_close(got, gathered, valid)


@pytest.mark.parametrize("batch", ["fit", "overflow"])
def test_cond_xcpe_matches_jax(geo, batch):
    """`SubMConv` in ``"cond"`` mode against JAX's, which takes the blocked
    form where nothing dropped and the gather where a level overflowed (the
    port's "cond" gathers on both)."""
    g = geo[batch]
    dropped = sum(int(lv.dropped) for lv in g["jax"][1:])
    assert (dropped > 0) == (batch == "overflow")
    jops, tops = _xcpe_operands(geo, batch, 0)
    feat = np.random.RandomState(14).randn(N, 8).astype(np.float32)
    jmod = jp.SubMConv(8, 8, 27)
    jgeom = (jops["grid_coord"], jops["mask"], jops["parent_inverse"], jops["child_nbr"])
    nbr = g["jax"][0].point.neighbor_idx
    variables = as_numpy(fill(jax.eval_shape(lambda f: jmod.init(
        jax.random.PRNGKey(0), f, nbr), feat), 15))
    want = np.asarray(jax.jit(lambda v: jmod.apply(
        v, feat, nbr, blocked_geom=jgeom, no_overflow=jnp.asarray(dropped == 0),
        stem_mode="cond"))(variables))
    tm = SubMConv(8, 8, 27)
    load_jax_variables(tm, variables)
    tgeom = (tops["grid_coord"], tops["mask"], tops["parent_inverse"], tops["child_nbr"])
    with torch.no_grad():
        got = tm(T(feat), g["port"][0].point.neighbor_idx, blocked_geom=tgeom,
                 stem_mode="cond").numpy()
    assert_close(got, want, np.asarray(g["jax"][0].point.mask))
