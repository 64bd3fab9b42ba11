"""Point Transformer V2 and the shape classifier in the port against the JAX
package: grouped vector attention (both weight encodings, ``pe_multiplier``,
``pe_bias``), BlockV2 with plain and prompt-driven (adaptive) norms in eval
and training mode, PT-v2m1/m2/m3 and the serialization-pyramid fallback in
f32 eval, one training step of `DefaultSegmentor(PT-v2m2)` and of
`DefaultClassifier` against `jax.grad` (loss, gradients, running
statistics), the classifier's exports, and feature mode
(``num_classes=0``) against the last decoder block's output captured from
JAX, whose own module cannot build there. Inputs are made with numpy from a
seed; weights with numpy and carried across with `load_jax_variables`."""

import copy

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cdsegnet_tpu.models import losses as jl  # noqa: E402
from cdsegnet_tpu.models.builder import build_model as jbuild  # noqa: E402
from cdsegnet_tpu.models.ptv2 import BlockV2 as JBlock  # noqa: E402
from cdsegnet_tpu.models.ptv2 import GroupedVectorAttention as JGVA  # noqa: E402
from cdsegnet_tpu.models.structure import make_point_batch as jmake  # noqa: E402
from cdsegnet_tpu.ops.pointops import knn as jknn  # noqa: E402
from cdsegnet_torch.models.builder import build_model as tbuild  # noqa: E402
from cdsegnet_torch.models.builder import build_model_criteria  # noqa: E402
from cdsegnet_torch.models.ptv2 import BlockV2, GroupedVectorAttention  # noqa: E402
from cdsegnet_torch.utils.synthetic import synthetic_arrays  # noqa: E402
from cdsegnet_torch.utils.weights import load_jax_variables  # noqa: E402
from test_torch_model import as_numpy, random_variables, to_port  # noqa: E402

torch.set_num_threads(2)
T = lambda x: torch.from_numpy(np.array(x))
N = 4096
CTX = 16  # the adaptive PDNorm's context width in these tests
BACKBONE = dict(
    type="PT-v2m2", in_channels=6, num_classes=5, patch_embed_channels=8,
    patch_embed_groups=2, enc_channels=(8, 16, 16, 16), enc_depths=(1, 1, 2, 1),
    enc_groups=(2, 4, 4, 4), dec_channels=(8, 8, 16, 16), dec_depths=(1, 1, 1, 1),
    dec_groups=(2, 2, 4, 4), k_neighbors=8, capacity_div=(1, 1, 2, 4, 8))
MODELS = {
    "m2": dict(BACKBONE),
    "m1": dict(BACKBONE, type="PT-v2m1"),
    "m3": dict(BACKBONE, type="PT-v2m3", num_conditions=2, pdnorm_adaptive=True,
               context_channels=CTX),
    "serialization": dict(BACKBONE, grid_sizes=None),
}
CRITERIA = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1),
            dict(type="LovaszLoss", mode="multiclass", loss_weight=1.0, ignore_index=-1)]
CLS_CRITERIA = [dict(type="CrossEntropyLoss", loss_weight=1.0, label_smoothing=0.2)]


def jax_cfg(cfg):
    """The JAX module's fields: the port's ``context_channels`` (flax infers
    the modulation's input width) dropped."""
    return {k: v for k, v in cfg.items() if k != "context_channels"}


def point():
    """N slots of two synthetic scenes at 4 cm spacing: every pooled level
    holds tens of points of each scene or more, and none overflows."""
    a = synthetic_arrays(N, 2, depth=9, seed=3)
    a["coord"] = a["coord"] * 2.0
    a["segment"] = a["segment"] % 5
    return jmake(**{k: jnp.asarray(v) for k, v in a.items()}, depth=9, num_scenes=2)


def context():
    return np.random.RandomState(9).randn(1, CTX).astype(np.float32)


def layer_inputs(c):
    """Features, coords, mask and the kNN table of one level (k = 8)."""
    pt = point()
    feat = np.random.RandomState(4).randn(N, c).astype(np.float32)
    idx = jknn(pt.coord, pt.coord, 8, pt.mask, pt.mask, query_batch=pt.batch,
               ref_batch=pt.batch)[0]
    return pt, jnp.asarray(feat), idx


GVA = {"linear": dict(weight_encoding="linear"), "grouped": dict(weight_encoding="grouped"),
       "pe_multiplier": dict(weight_encoding="linear", pe_multiplier=True),
       "no_pe_bias": dict(weight_encoding="grouped", pe_bias=False)}
BLOCKS = {"bn": dict(), "pdnorm": dict(num_conditions=2, pdnorm_adaptive=True)}


def _gva_ref(name):
    pt, feat, idx = layer_inputs(16)
    mod = JGVA(channels=16, groups=4, k_neighbors=8, **GVA[name])
    v = random_variables(mod, feat, pt.coord, pt.mask, idx)
    out = jax.jit(mod.apply)(v, feat, pt.coord, pt.mask, idx)
    return dict(variables=as_numpy(v), out=np.asarray(out))


def _block_ref(name):
    pt, feat, idx = layer_inputs(16)
    mod = JBlock(channels=16, groups=4, k_neighbors=8, **BLOCKS[name])
    ctx = jnp.asarray(context())
    kw = dict(condition=1, context=ctx) if name == "pdnorm" else {}
    v = random_variables(mod, feat, pt.coord, pt.mask, idx, train=False, **kw)
    args = (feat, pt.coord, pt.mask, idx)
    ev = jax.jit(lambda v, a: mod.apply(v, *a, False, **kw))(v, args)
    tr, mut = jax.jit(lambda v, a: mod.apply(v, *a, True, mutable=["batch_stats"],
                                             **kw))(v, args)
    return dict(variables=as_numpy(v), eval=np.asarray(ev), train=np.asarray(tr),
                stats=as_numpy(mut["batch_stats"]))


def _model_ref(name):
    cfg = MODELS[name]
    pt = point()
    jm = jbuild(jax_cfg(cfg))
    kw = (dict(condition=1, context=jnp.asarray(context())) if name == "m3" else {})
    v = random_variables(jm, pt, train=False, **kw)
    out = jax.jit(lambda v, p: jm.apply(v, p, train=False, **kw).feat)(v, pt)
    res = dict(variables=as_numpy(v), out=np.asarray(out))
    if name == "m2":  # feature mode: the last decoder block's output
        _, inter = jax.jit(lambda v, p: jm.apply(v, p, train=False,
                                                 capture_intermediates=True))(v, pt)
        res["features"] = np.asarray(inter["intermediates"]["dec0_block0"]["__call__"][0])
    return res


def _train_ref(kind):
    """Loss, gradients and new running statistics of one training step."""
    pt = point()
    if kind == "segmentor":
        cfg = dict(type="DefaultSegmentor", backbone=dict(BACKBONE))
        crit = jl.Criteria(CRITERIA, loss_type="EW", task_num=2)
    else:
        cfg = dict(type="DefaultClassifier", backbone=dict(BACKBONE), num_classes=7)
        crit = jl.Criteria(CLS_CRITERIA, loss_type="EW", task_num=2)
        pt = pt.replace(segment=jnp.where(pt.batch == 0, 3, 6).astype(jnp.int32))
    jm = jbuild(copy.deepcopy(cfg))
    v = as_numpy(random_variables(jm, pt))

    def loss_fn(params, stats, p):
        out, mut = jm.apply({"params": params, "batch_stats": stats}, p, train=True,
                            mutable=["batch_stats"])
        return crit(out, mode="train"), mut["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], v["batch_stats"], pt)
    ev = jax.jit(lambda v, p: jm.apply(v, p, train=False))(v, pt)
    return dict(cfg=cfg, point=pt, variables=v, loss=float(loss), grads=as_numpy(grads),
                stats=as_numpy(stats),
                eval={k: np.asarray(x) for k, x in ev.items()} if isinstance(ev, dict)
                else None)


JOBS = ([("gva", n) for n in GVA] + [("block", n) for n in BLOCKS]
        + [("model", n) for n in MODELS] + [("train", "segmentor"), ("train", "classifier")])


@pytest.fixture(scope="module")
def ref():
    """Every JAX reference. The inputs are arguments of each jitted
    function, never constants: XLA would fold the kNN distances of a
    constant point without fused multiply-adds and order near-ties
    otherwise."""
    fns = dict(gva=_gva_ref, block=_block_ref, model=_model_ref, train=_train_ref)
    return {job: fns[job[0]](job[1]) for job in JOBS}


def _close(got, want, rel=1e-5):
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("name", list(GVA))
def test_grouped_vector_attention_matches_jax(ref, name):
    r = ref[("gva", name)]
    pt, feat, idx = layer_inputs(16)
    m = GroupedVectorAttention(16, 4, 8, **GVA[name])
    load_jax_variables(m, r["variables"])
    got = m(T(feat), T(pt.coord), T(idx)).detach().numpy()
    _close(got, r["out"])


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax_in_eval_and_training(ref, name):
    """Eval output, training output and the running statistics it leaves
    (only condition 1's advance under PDNorm)."""
    r = ref[("block", name)]
    pt, feat, idx = layer_inputs(16)
    m = BlockV2(16, 4, 8, context_channels=CTX, **BLOCKS[name])
    load_jax_variables(m, r["variables"])
    kw = dict(condition=1, context=T(context())) if name == "pdnorm" else {}
    args = (T(feat), T(pt.coord), T(pt.mask), T(idx))
    valid = np.asarray(pt.mask)
    _close(m.eval()(*args, **kw).detach().numpy()[valid], r["eval"][valid])
    _close(m.train()(*args, **kw).detach().numpy()[valid], r["train"][valid])
    want = tbuild_stats(m, r["variables"], r["stats"])
    for bname, b in m.named_buffers():
        np.testing.assert_allclose(b.numpy(), want[bname].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=bname)
    if name == "pdnorm":
        assert torch.equal(m.bn.mean[0], torch.from_numpy(
            r["variables"]["batch_stats"]["bn"]["mean"][0]))


def tbuild_stats(module, variables, stats):
    """JAX running statistics in the port's buffer names."""
    m = copy.deepcopy(module)
    load_jax_variables(m, dict(params=variables["params"], batch_stats=stats))
    return dict(m.named_buffers())


def port_model(cfg, variables):
    m = tbuild(copy.deepcopy(cfg), device="cpu")
    load_jax_variables(m, variables)
    return m


@pytest.mark.parametrize("name", list(MODELS))
def test_model_eval_logits_match_jax(ref, name):
    """f32 eval logits within 1e-5 of max |logits| on the valid slots."""
    r = ref[("model", name)]
    m = port_model(MODELS[name], r["variables"])
    kw = dict(condition=1, context=T(context())) if name == "m3" else {}
    pt = point()
    got = m(to_port(pt), **kw).detach().numpy()
    valid = np.asarray(pt.mask)
    assert got.shape == (N, 5) and got.dtype == np.float32
    _close(got[valid], r["out"][valid])


def test_feature_mode_returns_the_last_decoder_block(ref):
    """``num_classes=0``: the port builds no head and returns the last
    decoder block's output (captured from JAX's model with a head); JAX's
    own module fails to build at ``num_classes=0``."""
    r = ref[("model", "m2")]
    cfg = dict(BACKBONE, num_classes=0)
    params = {k: v for k, v in r["variables"]["params"].items() if k != "head"}
    m = port_model(cfg, dict(params=params, batch_stats=r["variables"]["batch_stats"]))
    assert m.head is None
    pt = point()
    got = m(to_port(pt)).detach().numpy()
    assert got.shape == (N, BACKBONE["dec_channels"][0])
    valid = np.asarray(pt.mask)
    _close(got[valid], r["features"][valid])
    jm = jbuild(jax_cfg(cfg))
    with pytest.raises(ZeroDivisionError):
        jax.eval_shape(lambda p: jm.init(jax.random.PRNGKey(0), p, train=False), pt)


@pytest.mark.parametrize("kind", ["segmentor", "classifier"])
def test_train_step_matches_jax(ref, kind):
    """One training step's loss, every parameter's gradient (1e-4 of the
    tensor's max |g| plus 1e-6 of the largest, the bound of
    `test_torch_train.py`) and the new running statistics."""
    r = ref[("train", kind)]
    m = port_model(r["cfg"], r["variables"]).train()
    out = m(to_port(r["point"]))
    crit = build_model_criteria(dict(criteria=CRITERIA if kind == "segmentor"
                                     else CLS_CRITERIA))
    loss = crit(out, mode="train")
    loss.backward()
    np.testing.assert_allclose(loss.item(), r["loss"], rtol=1e-5)
    want = dict(port_model(r["cfg"], dict(params=r["grads"],
                                          batch_stats=r["variables"]["batch_stats"]))
                .named_parameters())
    floor = 1e-6 * max(w.abs().max().item() for w in want.values())
    for name, p in m.named_parameters():
        g, w = p.grad, want[name].detach()
        assert g is not None, name
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() + floor, name
    stats = dict(port_model(r["cfg"], dict(params=r["variables"]["params"],
                                           batch_stats=r["stats"])).named_buffers())
    for bname, b in m.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[bname].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=bname)
    if kind == "classifier":
        assert out["n_pred"].shape == (2, 7)
        np.testing.assert_array_equal(out["n_target"].numpy(), [3, 6])


def test_classifier_eval_exports_match_jax(ref):
    """`DefaultClassifier` over a backbone with 5 classes (``cls_fc1`` reads
    the logits): ``cls_pred`` and the per-scene targets and validity."""
    r = ref[("train", "classifier")]
    m = port_model(r["cfg"], r["variables"]).eval()
    assert m.cls_fc1.weight.shape == (256, 5)
    out = m(to_port(r["point"]))
    assert set(out) == set(r["eval"])
    _close(out["cls_pred"].detach().numpy(), r["eval"]["cls_pred"])
    for k in ("n_target", "seg_valid", "cls_target"):
        np.testing.assert_array_equal(out[k].numpy(), r["eval"][k], err_msg=k)
