"""The window-attention family in the port against the JAX package:
`exact_sparse_attention` (with and without a relative-position bias, missing
keys and a query with none), Swin3D's binned value term against the literal
per-pair gather, and OctFormer (dilation 2, whose regrouped RPE deltas
include negative odd ones), Stratified (coarse keys, ``kc > 0``) and Swin3D
(``XYZ_RGB``; ``XYZ_RGB_NORM`` with ``stem_transformer=False``) at the test
widths of `tests/test_zoo2.py`, each in f32: the eval logits, and one
training forward and backward with JAX's stochastic-depth masks fed in
(loss, every gradient, the running statistics). Also: a JAX OctFormer
checkpoint through `convert_jax_checkpoint.py`, and the shipped Stratified
config's ``gredient_clip``, which both packages' `clip_by_keyword` refuse
with the same `TypeError`. Inputs and weights are made with numpy from a
seed; weights are carried across with `load_jax_variables`.

The batch is 4,096 slots of two synthetic scenes at 4 cm spacing
(3,686 valid). Its pyramid levels hold, per model (capacities in
parentheses, no level drops a point):

- OctFormer: 3,686 / 1,430 (2,048) / 419 (1,024) / 123 / 33 / 13 (512
  each);
- Stratified: 3,686 / 1,430 (2,048) / 419 (1,024) / 123 (512) / 33 (256);
- Swin3D: 3,686 / 1,430 (2,048) / 419 (1,024).
"""

import copy
import os
import re
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

import convert_jax_checkpoint as converter  # noqa: E402
from cdsegnet_tpu.engine.checkpoint import CheckpointManager as JManager  # noqa: E402
from cdsegnet_tpu.engine.config import Config as JConfig  # noqa: E402
from cdsegnet_tpu.engine.optimizer import clip_by_keyword as jclip  # noqa: E402
from cdsegnet_tpu.engine.state import TrainState  # noqa: E402
from cdsegnet_tpu.models import losses as jl  # noqa: E402
from cdsegnet_tpu.models import octformer as joct  # noqa: E402
from cdsegnet_tpu.models import stratified as jstrat  # noqa: E402
from cdsegnet_tpu.models import swin3d as jswin  # noqa: E402
from cdsegnet_tpu.models.builder import build_model as jbuild  # noqa: E402
from cdsegnet_tpu.models.structure import make_point_batch as jmake  # noqa: E402
from cdsegnet_tpu.ops.sparse_attention import exact_sparse_attention as jsparse  # noqa: E402
from cdsegnet_torch.engine.checkpoint import CheckpointManager  # noqa: E402
from cdsegnet_torch.engine.config import Config  # noqa: E402
from cdsegnet_torch.engine.optimizer import build_optimizer, clip_by_keyword  # noqa: E402
from cdsegnet_torch.models.builder import build_model as tbuild  # noqa: E402
from cdsegnet_torch.models.builder import build_model_criteria  # noqa: E402
from cdsegnet_torch.models.modules import DropoutDraws  # noqa: E402
from cdsegnet_torch.models.swin3d import binned_value, crse_logits, ordered_mean  # noqa: E402
from cdsegnet_torch.ops.sparse_attention import exact_sparse_attention  # noqa: E402
from cdsegnet_torch.utils.synthetic import synthetic_arrays  # noqa: E402
from cdsegnet_torch.utils.weights import load_jax_variables  # noqa: E402
from test_torch_model import as_numpy, random_variables, to_port  # noqa: E402

torch.set_num_threads(2)
T = lambda x: torch.from_numpy(np.array(x))
N = 4096
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWIN = dict(type="Swin3D-v1m1", in_channels=6, num_classes=5, base_grid_size=0.02,
            depths=(1, 1, 1), channels=(8, 16, 16), num_heads=(2, 2, 2),
            window_sizes=(5, 7, 7), quant_size=2, patch_size=16, capacity_div=(1, 2, 4),
            cRSE="XYZ_RGB", color_slice=(0, 3), normal_slice=(3, 6))
MODELS = {  # the widths of tests/test_zoo2.py, each model's default drop rate
    "octformer": dict(type="OctFormer-v1m1", in_channels=6, num_classes=5, fpn_channels=8,
                      channels=(8, 8, 16, 16), num_blocks=(2, 1, 1, 1),
                      num_heads=(2, 2, 2, 2), patch_size=8, dilation=2, stem_down=2,
                      head_up=2, capacity_div=(1, 2, 4, 8, 8, 8)),
    "stratified": dict(type="StratifiedTransformer", in_channels=6, num_classes=5,
                       channels=(8, 8, 16, 16), depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2),
                       patch_size=16, capacity_div=(1, 2, 4, 8, 16)),
    "swin3d": SWIN,
    "swin3d_norm": dict(SWIN, depths=(2, 1, 1), cRSE="XYZ_RGB_NORM",
                        stem_transformer=False),
}
LEVELS = {"octformer": [3686, 1430, 419, 123, 33, 13],
          "stratified": [3686, 1430, 419, 123, 33],
          "swin3d": [3686, 1430, 419], "swin3d_norm": [3686, 1430, 419]}
CRITERIA = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)]


def point():
    """N slots of two synthetic scenes at 4 cm spacing (level sizes in the
    module docstring)."""
    a = synthetic_arrays(N, 2, depth=9, seed=3)
    a["coord"] = a["coord"] * 2.0
    a["segment"] = a["segment"] % 5
    return jmake(**{k: jnp.asarray(v) for k, v in a.items()}, depth=9, num_scenes=2)


# ---- JAX's stochastic-depth masks ----

_TLS = threading.local()


def _capturing_drop_path(x, rate, rng, deterministic):
    """JAX's `drop_path` (`cdsegnet_tpu/models/modules.py:165`), which also
    records its keep mask in the calling thread's list."""
    if deterministic or rng is None:
        return x
    if isinstance(rate, (int, float)) and float(rate) == 0.0:
        return x
    keep = 1.0 - jnp.asarray(rate, jnp.float32)
    mask = jax.random.bernoulli(rng, keep, (x.shape[0], 1))
    _TLS.masks.append(mask)
    return jnp.where(mask, x / keep.astype(x.dtype), 0.0).astype(x.dtype)


def _eval_ref(name):
    pt = point()
    jm = jbuild(copy.deepcopy(MODELS[name]))
    v = random_variables(jm, pt, train=False)
    out = jax.jit(lambda v, p: jm.apply(v, p, train=False).feat)(v, pt)
    return dict(variables=as_numpy(v), out=np.asarray(out))


def _train_ref(name):
    """The backbone's training forward with its stochastic-depth masks
    recorded (in call order), CE on its logits, the gradients and the new
    running statistics."""
    pt = point()
    jm = jbuild(copy.deepcopy(MODELS[name]))
    v = as_numpy(random_variables(jm, pt, train=False))
    crit = jl.Criteria(CRITERIA, loss_type="EW", task_num=2)

    def loss_fn(params, stats, p):
        _TLS.masks = []
        out, mut = jm.apply({"params": params, "batch_stats": stats}, p, train=True,
                            rngs=dict(dropout=jax.random.PRNGKey(7)), mutable=["batch_stats"])
        o = dict(n_pred=out.feat, n_target=p.segment, seg_valid=p.mask & (p.segment >= 0))
        return crit(o, mode="train"), (mut["batch_stats"], list(_TLS.masks))

    (loss, (stats, masks)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], v["batch_stats"], pt)
    return dict(variables=v, loss=float(loss), grads=as_numpy(grads), stats=as_numpy(stats),
                masks=[np.asarray(m) for m in masks])


def _sparse_inputs():
    """24 queries of 2 heads of 8: each attends its (up to) 5 predecessors
    and itself, missing slots N; query 0 has no key at all."""
    rng = np.random.RandomState(0)
    n, h, d, s = 24, 2, 8, 6
    q, k, v = (rng.randn(n, h, d).astype(np.float32) for _ in range(3))
    idx = np.full((n, s), n, np.int32)
    for i in range(1, n):
        keys = list(range(max(0, i - s + 1), i + 1))
        idx[i, :len(keys)] = keys
    coords = rng.rand(n, 3).astype(np.float32)
    w = rng.randn(3, h).astype(np.float32)
    return q, k, v, idx, coords, w


def _sparse_ref(biased):
    q, k, v, idx, coords, w = _sparse_inputs()
    fn = (lambda rel: jnp.einsum("nsc,ch->nhs", rel, jnp.asarray(w))) if biased else None
    out = jax.jit(lambda q, k, v, i, c: jsparse(q, k, v, i, rel_bias_fn=fn, coords=c))(
        q, k, v, idx, coords)
    return np.asarray(out)


JOBS = ([("eval", n) for n in MODELS] + [("train", n) for n in MODELS]
        + [("sparse", False), ("sparse", True)])


@pytest.fixture(scope="module")
def ref():
    """Every JAX reference (each records its own stochastic-depth masks,
    in its thread's list); inputs are jit arguments."""
    fns = dict(eval=_eval_ref, train=_train_ref, sparse=_sparse_ref)
    mods = (joct, jstrat, jswin)
    saved = [m.drop_path for m in mods]
    for m in mods:
        m.drop_path = _capturing_drop_path
    try:
        return {job: fns[job[0]](job[1]) for job in JOBS}
    finally:
        for m, f in zip(mods, saved):
            m.drop_path = f


def port_model(cfg, variables):
    m = tbuild(copy.deepcopy(cfg), device="cpu")
    load_jax_variables(m, variables)
    return m


@pytest.mark.parametrize("biased", [False, True], ids=["plain", "rel_bias"])
def test_exact_sparse_attention_matches_jax(ref, biased):
    """Within 1e-6 of max |out|; the query with no key gives zeros."""
    q, k, v, idx, coords, w = _sparse_inputs()
    fn = (lambda rel: torch.einsum("nsc,ch->nhs", rel, T(w))) if biased else None
    got = exact_sparse_attention(T(q), T(k), T(v), T(idx), rel_bias_fn=fn,
                                 coords=T(coords)).numpy()
    want = ref[("sparse", biased)]
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert not got[0].any()


def test_swin3d_table_terms_equal_the_literal_gathers():
    """`binned_value` (the attention binned per table row, then one product
    with the table) and `crse_logits` against JAX's literal forms, ``sum_j
    attn[i, j] table[idx(i, j)]`` over a (P, K, K, H, D) gather and
    ``qdot[i, idx(i, j)] + kdot[j, idx(i, j)]`` over a broadcast, for two
    pairs of offset rows: values and the gradients of every input within
    1e-6 of their largest in f32 (both functions have their own
    backward)."""
    rng = np.random.RandomState(5)
    p, h, k, d, length = 3, 2, 16, 4, 10
    f = lambda *shape: T(rng.randn(*shape).astype(np.float32)).requires_grad_()
    logits, table, qdot, kdot = f(p, h, k, k), f(2 * length, h, d), f(p, h, k, 2 * length), \
        f(p, h, k, 2 * length)
    pairs = torch.stack([T(rng.randint(0, length, (p, k, k))),
                         T(rng.randint(length, 2 * length, (p, k, k)))]).long()
    attn = torch.softmax(logits, dim=-1)
    got = [binned_value(attn, pairs, table), crse_logits(qdot, kdot, pairs)]
    ar = torch.arange(k)
    want = [sum(torch.einsum("phij,pijhd->pihd", attn, table[ia]) for ia in pairs),
            sum(qdot[torch.arange(p)[:, None, None, None], torch.arange(h)[None, :, None, None],
                     ar[None, None, :, None], ia[:, None]]
                + kdot[torch.arange(p)[:, None, None, None], torch.arange(h)[None, :, None, None],
                       ar[None, None, None, :], ia[:, None]] for ia in pairs)]
    assert got[0].shape == (p, k, h, d) and got[1].shape == (p, h, k, k)
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max()
    cot = [T(rng.randn(*x.shape).astype(np.float32)) for x in want]
    grads = [torch.autograd.grad([(x * c).sum() for x, c in zip(outs, cot)],
                                 [logits, table, qdot, kdot], retain_graph=True)
             for outs in (got, want)]
    for a, b in zip(*grads):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max()


@pytest.mark.parametrize("name", list(MODELS))
def test_eval_logits_match_jax(ref, name):
    """f32 eval logits within 1e-5 of max |logits| plus 1e-6 on the valid
    slots; the pyramid's levels as documented. OctFormer's dilated blocks
    see negative odd grid deltas, where JAX's floor division and a
    truncating one differ; Stratified's fine patches take ``kc > 0``
    coarse keys."""
    r = ref[("eval", name)]
    m = port_model(MODELS[name], r["variables"])
    pt = point()
    p = to_port(pt)
    levels, _ = m.precompute_geometry(p)
    assert [int(lv.point.mask.sum()) for lv in levels] == LEVELS[name]
    assert not any(lv.dropped for lv in levels[1:])
    if name == "octformer":
        attn = m.stage0_block1.attention
        assert attn.dilation == 2
        lv = levels[m.stem_down].point
        gc = attn._regroup(lv.grid_coord, lv.orders[0]).reshape(-1, attn.patch_size, 3)
        rel = gc[:, :, None] - gc[:, None]
        assert ((rel < 0) & (rel % 2 == 1)).any()
        assert not torch.equal(torch.div(rel, 2, rounding_mode="floor"),
                               torch.div(rel, 2, rounding_mode="trunc"))
    if name.startswith("swin3d"):  # each cluster summed in order: the pyramid's bits
        coord = p.coord
        for lv in levels[1:]:
            coord = ordered_mean(coord, lv)
            assert torch.equal(coord, lv.point.coord)
    if name == "stratified":
        for s in range(len(m.channels)):
            n_fine = levels[s].size // m.patch_size
            assert levels[s + 1].size // n_fine > 0
    with torch.no_grad():
        got = m(p).numpy()
    valid = np.asarray(pt.mask)
    assert got.shape == (N, 5) and got.dtype == np.float32
    want = r["out"][valid]
    assert np.abs(got[valid] - want).max() <= 1e-5 * np.abs(want).max() + 1e-6


@pytest.mark.parametrize("name", list(MODELS))
def test_train_forward_and_backward_match_jax(ref, name):
    """Training mode with JAX's stochastic-depth masks fed in (two per
    block past the first, in call order, every one used): the CE loss,
    every parameter's gradient (1e-4 of the tensor's max |g| plus 1e-6 of
    the largest, the bound of `test_torch_train.py`) and the running
    statistics."""
    r = ref[("train", name)]
    assert r["masks"] and all(x.ndim == 2 and x.shape[1] == 1 for x in r["masks"])
    m = port_model(MODELS[name], r["variables"]).train()
    p = to_port(point())
    draws = DropoutDraws(None, [], path_masks=[T(x) for x in r["masks"]])
    logits = m(p, generator=draws)
    assert not draws.path_masks
    crit = build_model_criteria(dict(criteria=CRITERIA))
    loss = crit(dict(n_pred=logits, n_target=p.segment, seg_valid=p.mask & (p.segment >= 0)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), r["loss"], rtol=1e-5)
    want = dict(port_model(MODELS[name], dict(params=r["grads"],
                                              batch_stats=r["variables"]["batch_stats"]))
                .named_parameters())
    floor = 1e-6 * max(w.abs().max().item() for w in want.values())
    for pname, prm in m.named_parameters():
        g, w = prm.grad, want[pname].detach()
        assert g is not None, pname
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() + floor, pname
    stats = dict(port_model(MODELS[name], dict(params=r["variables"]["params"],
                                               batch_stats=r["stats"])).named_buffers())
    for bname, b in m.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[bname].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=bname)


def test_jax_octformer_checkpoint_converts(ref, tmp_path):
    """A `TrainState` of `DefaultSegmentor(OctFormer-v1m1)` with AdamW,
    saved by JAX's `CheckpointManager`, converts: the port's model loaded
    from it gives JAX's eval logits (within 1e-5 of max |logits| plus
    1e-6), and the optimizer's moments are not carried."""
    r = ref[("eval", "octformer")]
    cfg = dict(type="DefaultSegmentor", backbone=dict(MODELS["octformer"]))
    variables = dict(params=dict(backbone=r["variables"]["params"]),
                     batch_stats=dict(backbone=r["variables"]["batch_stats"]))
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                              optax.adamw(1e-3), jax.random.PRNGKey(0))
    JManager(str(tmp_path / "jax")).save(state.replace(step=jnp.int32(3)), "model_last")
    config = tmp_path / "octformer.py"
    config.write_text(f"model = {cfg!r}\n")
    out = str(tmp_path / "port" / "model_last")
    got = converter.main(["--config-file", str(config), "--jax-checkpoint",
                          str(tmp_path / "jax" / "model_last"), "--output", out])
    assert got["step"] == 3 and got["kept"] == []
    state = CheckpointManager(os.path.dirname(out)).restore_raw("model_last")
    assert sorted(state) == ["model", "step"]
    m = tbuild(copy.deepcopy(cfg), device="cpu")
    m.load_state_dict(state["model"])
    pt = point()
    with torch.no_grad():
        logits = m(to_port(pt))["n_pred"].numpy()
    valid = np.asarray(pt.mask)
    want = r["out"][valid]
    assert np.abs(logits[valid] - want).max() <= 1e-5 * np.abs(want).max() + 1e-6


def test_shipped_stratified_clip_fails_in_both_packages():
    """`configs/scannet/stratified.py` sets ``gredient_clip =
    [dict(keyword="", max_norm=1.0)]``: both packages' `clip_by_keyword`
    test ``keyword in parameter name`` with the dict and raise the same
    `TypeError`, so neither trainer takes a step of the shipped config (a
    reference behaviour the port copies; the config predates the port)."""
    path = os.path.join(REPO, "configs", "scannet", "stratified.py")
    clip, jclip_cfg = Config.fromfile(path).gredient_clip, JConfig.fromfile(path).gredient_clip
    assert list(clip) == list(jclip_cfg) == [dict(keyword="", max_norm=1.0)]
    grads = {"stem_conv": {"weight": jnp.ones((2, 2))}}
    tx = jclip(jclip_cfg, 0.1)
    with pytest.raises(TypeError, match=re.escape("requires string as left operand")) as jerr:
        tx.update(grads, tx.init(grads), grads)
    lin = torch.nn.Linear(2, 2)
    lin(torch.ones(1, 2)).sum().backward()
    with pytest.raises(TypeError) as terr:
        clip_by_keyword(list(lin.named_parameters()), list(clip), 0.1)
    assert str(terr.value) == str(jerr.value)
    opt = build_optimizer(dict(type="AdamW", lr=1e-3), lin, clip_keywords=list(clip),
                          device="cpu")
    with pytest.raises(TypeError, match=re.escape("requires string as left operand")):
        opt.step()
