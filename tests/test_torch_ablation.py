"""The NCF ablation segmentors ③ ContinuousDM, ④ CCDM and ⑤ DiscreteDM in
the port against the JAX package (⑥ CDDM and the single-branch DM in
tests/test_torch_ablation_cddm.py, over this file's helpers), on the tiny
configs of tests/test_ablation_segmentors.py with weights made with numpy
from a seed and carried across: the training forward and one step through
`make_train_step` (loss, gradients, running statistics) with every draw
injected, SSI, `denoise_step` and `inference_multistep` MSAI and MSFI with
the initial state and JAX's Gumbel uniforms fed in. Then the tester's
non-CNF route against JAX's `SemSegTester` and the evaluator's draws.

JAX's forwards are composed from the package's public pieces (as
tests/test_torch_train.py composes `CNFSegmentor.__call__`) so that the
timesteps, noises, D3PM keep masks and uniform labels are inputs; its
`denoise_step` and `inference_multistep` run as they are, with the Gumbel
uniforms read from the keys `d3pm_ddim_sample` receives.

The models run on two synthetic scenes of 1,024 slots, whose coarsest
pyramid level holds 8 valid points. On the 256-slot batches of the other
port tests it holds 2, and train-mode BatchNorm there divides by the spread
of two nearly equal values: f32 rounding of either package is amplified
some 60 times, and one step's gradients on that batch lie up to 8x the
gradient bound from a float64 copy of the port in the port and 0.9x in JAX
(⑤; 3.4x and 0.5x for ③). On the 1,024-slot batch both lie within 0.07x
of it (measured on the CPU)."""

import copy

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from cdsegnet_tpu.engine.state import TrainState  # noqa: E402
from cdsegnet_tpu.engine.test import SemSegTester as JTester  # noqa: E402
from cdsegnet_tpu.models import ablation_segmentors as ja  # noqa: E402
from cdsegnet_tpu.models import losses as jl  # noqa: E402
from cdsegnet_tpu.models.builder import build_model as jbuild  # noqa: E402
from cdsegnet_tpu.models.structure import make_point_batch as jmake  # noqa: E402
from cdsegnet_torch.engine.config import Config  # noqa: E402
from cdsegnet_torch.engine.optimizer import build_optimizer  # noqa: E402
from cdsegnet_torch.engine.state import make_train_step  # noqa: E402
from cdsegnet_torch.engine.test import SemSegTester  # noqa: E402
from cdsegnet_torch.models import ablation_segmentors as ta  # noqa: E402
from cdsegnet_torch.models.builder import build_model as tbuild  # noqa: E402
from cdsegnet_torch.models.builder import build_model_criteria  # noqa: E402
from cdsegnet_torch.utils.weights import load_jax_variables  # noqa: E402
from test_ablation_segmentors import _cfg  # noqa: E402
from test_engine import _write_synthetic_dataset  # noqa: E402
from cdsegnet_torch.utils.synthetic import synthetic_arrays  # noqa: E402
from test_torch_model import as_numpy, random_variables, to_port  # noqa: E402
from test_torch_tester import scene_cfg  # noqa: E402
from test_torch_trainer import trainer_cfg  # noqa: E402

torch.set_num_threads(2)
T = lambda x: torch.from_numpy(np.array(x))
K = 5  # the tiny configs' classes
N = 1024  # slots of the test batch: two scenes, depth 7
KINDS = ("ContinuousDMSegmentor", "CCDMSegmentor", "DiscreteDMSegmentor",
         "CDDMSegmentor", "DMSegmentor")
# ③-⑤ here; ⑥ and DM in tests/test_torch_ablation_cddm.py
HERE = KINDS[:3]
MSE = dict(type="MSELoss", loss_weight=1.0)
CE = dict(type="CrossEntropyLoss", loss_weight=1.0)
LOVASZ = dict(type="LovaszLoss", mode="multiclass", loss_weight=1.0)
KL = dict(type="D3PMKLLoss", loss_weight=1.0)
# the criteria of the H100 phase 16: the shipped MSE + CE + Lovasz under GLS
# where a Gaussian branch is trained on noise; the posterior KL under EW
CRITERIA = {"ContinuousDMSegmentor": ([MSE, CE, LOVASZ], "GLS"),
            "CCDMSegmentor": ([MSE, CE, LOVASZ], "GLS"),
            "DiscreteDMSegmentor": ([KL, CE, LOVASZ], "EW"),
            "CDDMSegmentor": ([MSE, KL, CE, LOVASZ], "EW"),
            "DMSegmentor": ([KL, CE, LOVASZ], "EW")}
D3PM = ("DiscreteDMSegmentor", "CDDMSegmentor", "DMSegmentor")
STEPS = 2  # MSAI / MSFI: time_schedule(20, 2) = [19, 9, -1], three forwards


def batch():
    """Two synthetic scenes in N slots; no pooled level overflows."""
    a = synthetic_arrays(N, 2, depth=7, seed=3)
    return jmake(**{k: jnp.asarray(v) for k, v in a.items()}, depth=7, num_scenes=2)


def ablation_cfg(kind):
    cfg = _cfg(kind)
    cfg["backbone"].update(drop_path=0.0, shuffle_orders=False)
    crit, loss_type = CRITERIA[kind]
    cfg.update(criteria=copy.deepcopy(crit), loss_type=loss_type, task_num=2)
    return cfg


def assert_close(got, want, valid=None, rel=1e-5, floor=1e-6):
    """max |got - want| <= rel * max |want| + floor (over ``valid`` rows),
    the logits bound of tests/test_torch_ddim.py."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if valid is not None:
        got, want = got[valid], want[valid]
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + floor, (err, np.abs(want).max())


def draws(kind, cfg, point, seed):
    """The training forward's draws, made with numpy: a timestep per scene
    (t = 0 on the first, the posterior's t = 0 branch), the Gaussian
    noises, and the D3PM keep mask (Bernoulli(ab_t)) and uniform labels."""
    from cdsegnet_tpu.models.diffusion import DiffusionSchedule

    rng = np.random.RandomState(seed)
    ts = np.array([0, cfg["T"] // 2 + 3], np.int32)
    ts_pt = ts[np.clip(np.asarray(point.batch), 0, 1)]
    d = dict(ts_scene=ts)
    if kind == "ContinuousDMSegmentor":
        d["noise"] = rng.randn(N, K).astype(np.float32)
    if kind in ("CCDMSegmentor", "CDDMSegmentor"):
        d["c_noise"] = rng.randn(N, 6).astype(np.float32)
    if kind == "CCDMSegmentor":
        d["n_noise"] = rng.randn(N, K).astype(np.float32)
    if kind in D3PM:
        ab = DiffusionSchedule.create("cosine", 0, 1000, cfg["T"]).alpha_bar
        d["keep"] = rng.rand(N) < ab[ts_pt]
        d["uniform_labels"] = rng.randint(0, K, N).astype(np.int32)
    return d


def ssi_draws(kind, seed):
    """SSI's start: N(0, 1) noises and uniform labels."""
    rng = np.random.RandomState(seed)
    s = {}
    if kind == "ContinuousDMSegmentor":
        s["noise"] = rng.randn(N, K).astype(np.float32)
    if kind in ("CCDMSegmentor", "CDDMSegmentor"):
        s["noise"] = rng.randn(N, 6).astype(np.float32)
    if kind == "CCDMSegmentor":
        s["n_noise"] = rng.randn(N, K).astype(np.float32)
    if kind in D3PM:
        s["x_t"] = rng.randint(0, K, N).astype(np.int32)
    return s


def jax_train_out(mdl, point, d):
    """The JAX training forward of each ablation, composed from the
    package's public pieces as its ``__call__`` composes them, with the
    draws injected."""
    seg = point.segment
    out = dict(n_target=seg, seg_valid=point.mask & (seg >= 0))
    ts = d["ts_scene"]
    ts_pt = jnp.take(ts, jnp.clip(point.batch, 0, point.num_scenes - 1))
    t_emb = mdl._t_emb(ts, point.batch)
    q = mdl.schedule.q_sample
    name = type(mdl).__name__
    if name == "ContinuousDMSegmentor":
        x0 = ja.labels_to_log_onehot(seg, K)
        c, n = mdl.backbone(point, point.replace(feat=q(x0, ts_pt, d["noise"])),
                            t_emb=t_emb, train=True)
        return dict(out, c_pred=c.feat, c_target=d["noise"], n_pred=n.feat)
    if name == "CCDMSegmentor":
        n_feat = q(ja.labels_to_log_onehot(seg, K), ts_pt, d["n_noise"])
        c, n = mdl.backbone(point.replace(feat=n_feat),
                            point.replace(feat=q(mdl._c_x0(point), ts_pt, d["c_noise"])),
                            t_emb=t_emb, train=True)
        return dict(out, c_pred=c.feat, c_target=d["c_noise"], n_pred=n.feat)
    x_t = jnp.where(d["keep"], jnp.clip(seg, 0, K - 1), d["uniform_labels"])
    oh = jax.nn.one_hot(x_t, K, dtype=jnp.float32)
    if name == "DiscreteDMSegmentor":
        c, n = mdl.backbone(point, point.replace(feat=oh), t_emb=t_emb, train=True)
        head = c.feat
    elif name == "CDDMSegmentor":
        c, n = mdl.backbone(point.replace(feat=oh),
                            point.replace(feat=q(mdl._c_x0(point), ts_pt, d["c_noise"])),
                            t_emb=t_emb, train=True)
        head = n.feat
        out.update(c_pred=c.feat, c_target=d["c_noise"])
    else:
        n = mdl.backbone(point.replace(feat=oh), train=True)
        head = n.feat
    true_q, pred_q = mdl.d3pm_posterior_pair(head, seg, x_t, ts_pt)
    return dict(out, d3pm_logits=head, d3pm_true_q=true_q, d3pm_pred_q=pred_q,
                n_pred=n.feat)


def jax_ssi(mdl, point, s):
    """JAX's SSI: ③'s own `inference` (it takes its noise); the others'
    composed with their draws injected."""
    name = type(mdl).__name__
    if name == "ContinuousDMSegmentor":
        return mdl.inference(point, s["noise"])["seg_logits"]
    ts = jnp.full((point.num_scenes,), mdl.T - 1, jnp.int32)
    t_emb = mdl._t_emb(ts, point.batch)
    if name == "CCDMSegmentor":
        _, n = mdl.backbone(point.replace(feat=s["n_noise"]),
                            point.replace(feat=s["noise"]), t_emb=t_emb, train=False)
        return n.feat
    oh = jax.nn.one_hot(s["x_t"], K, dtype=jnp.float32)
    if name == "DiscreteDMSegmentor":
        _, n = mdl.backbone(point, point.replace(feat=oh), t_emb=t_emb, train=False)
    elif name == "CDDMSegmentor":
        _, n = mdl.backbone(point.replace(feat=oh), point.replace(feat=s["noise"]),
                            t_emb=t_emb, train=False)
    else:
        n = mdl.backbone(point.replace(feat=oh), train=False)
    return n.feat


_SAMPLE = ja._D3PMMixin.d3pm_ddim_sample


def _sowing_sample(self, x0_logits, t, key):
    """JAX's `d3pm_ddim_sample`, sowing the uniforms it draws from ``key``."""
    self.sow("intermediates", "gumbel_u", jax.random.uniform(key, x0_logits.shape))
    return _SAMPLE(self, x0_logits, t, key)


def reference(i, kind):
    """JAX's weights, one training step with its outputs, SSI logits, and
    MSAI and MSFI through `inference_multistep` with each step's result and
    Gumbel uniforms recorded."""
    cfg = ablation_cfg(kind)
    jm = jbuild(copy.deepcopy(cfg))
    pt = batch()
    variables = as_numpy(random_variables(jm, pt))
    d = draws(kind, cfg, pt, 60 + i)
    crit = jl.Criteria(cfg["criteria"], loss_type=cfg["loss_type"], task_num=2)

    def loss_fn(params, stats):
        o, mut = jm.apply({"params": params, "batch_stats": stats}, pt,
                          {k: jnp.asarray(v) for k, v in d.items()},
                          method=jax_train_out, mutable=["batch_stats"])
        return crit(o, mode="train"), (mut["batch_stats"], o)

    (loss, (stats, out)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"])
    s = ssi_draws(kind, 70 + i)
    ssi = jax.jit(lambda v: jm.apply(v, pt, {k: jnp.asarray(x) for k, x in s.items()},
                                     method=jax_ssi))(variables)

    inner = jax.jit(lambda v, p, st, t, k: jm.apply(
        v, p, st, t, method=type(jm).denoise_step, rngs=dict(diffusion=k),
        mutable=["intermediates"]))
    steps = []

    def jit_step(v, p, st, t, k):
        res, mut = inner(v, p, st, t, k)
        u = mut["intermediates"].get("gumbel_u")
        steps.append(dict(t=int(t), state=jax.tree_util.tree_map(np.asarray, res["state"]),
                          n_logits=np.asarray(res["n_logits"]),
                          u=None if u is None else np.asarray(u[0])))
        return res

    key = jax.random.PRNGKey(80 + i)
    state0 = jax.tree_util.tree_map(
        np.asarray, ja.init_multistep_state(jm, pt, jax.random.split(key)[0]))
    multi = {}
    for mode in ("avg", "final"):
        steps.clear()
        logits = ja.inference_multistep(jm, variables, pt, key, step=STEPS, mode=mode,
                                        jit_step=jit_step)
        multi[mode] = dict(logits=np.asarray(logits), steps=list(steps))
    return dict(cfg=cfg, point=pt, variables=variables, draws=d, loss=float(loss),
                grads=as_numpy(grads), stats=as_numpy(stats), out=as_numpy(out),
                ssi_draws=s, ssi=np.asarray(ssi), state0=state0, multi=multi)


@pytest.fixture(scope="module")
def jref():
    """The JAX references of this file's kinds, with `d3pm_ddim_sample`
    sowing its uniforms for their duration."""
    ja._D3PMMixin.d3pm_ddim_sample = _sowing_sample
    try:
        return {kind: reference(KINDS.index(kind), kind) for kind in HERE}
    finally:
        ja._D3PMMixin.d3pm_ddim_sample = _SAMPLE


def port_model(ref, params=None, stats=None):
    m = tbuild(copy.deepcopy(ref["cfg"]), device="cpu")
    v = ref["variables"]
    load_jax_variables(m, dict(params=v["params"] if params is None else params,
                               batch_stats=v["batch_stats"] if stats is None else stats))
    return m


def port_inject(d):
    return {k: T(v) for k, v in d.items()}


def to_state(x):
    return tuple(T(a) for a in x) if isinstance(x, tuple) else T(x)


def check_forward(ref, kind):
    """Every output of the training forward that `Criteria` reads, with the
    draws injected. Training mode normalizes with batch statistics, so the
    outputs are held to the whole-model bound of tests/test_torch_model.py,
    1e-4 of max |x| + 1e-5 (⑤'s n_pred differs by 1.08e-5 of its max |x|
    here, measured on the CPU); the loss and gradients are held in the step
    test."""
    m = port_model(ref).train()
    out = m(to_port(ref["point"]), **port_inject(ref["draws"]))
    want = ref["out"]
    assert set(want) <= set(out)
    valid = np.asarray(ref["point"].mask)
    for k, w in want.items():
        g = out[k].detach().numpy()
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert_close(g, w, valid, rel=1e-4, floor=1e-5)
    assert out["pyramid_dropped"] == [0, 0, 0, 0]


def check_train_step(ref, kind):
    """One step through `make_train_step`: the loss, every parameter's
    gradient (left on the parameters after the update) and the new running
    statistics against `jax.grad`."""
    m = port_model(ref)
    opt = build_optimizer(dict(type="AdamW", lr=1e-3), m, device="cpu")
    step = make_train_step(m, build_model_criteria(ref["cfg"]), opt, device="cpu")
    metrics = step(to_port(ref["point"]), **port_inject(ref["draws"]))
    np.testing.assert_allclose(metrics["loss"].item(), ref["loss"], rtol=1e-5)
    # as tests/test_torch_train.py: per tensor, max |dg| <= 1e-4 max |g_jax|
    # plus 1e-6 of the largest gradient of all
    want = dict(port_model(ref, params=ref["grads"]).named_parameters())
    floor = 1e-6 * max(w.abs().max().item() for w in want.values())
    for name, p in m.named_parameters():
        w = want[name].detach()
        g = p.grad if p.grad is not None else torch.zeros_like(w)
        if p.grad is None:  # unread by the training forward
            assert not w.any(), name
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() + floor, name
    stats = dict(port_model(ref, stats=ref["stats"]).named_buffers())
    for name, b in m.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[name].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def check_ssi(ref, kind):
    m = port_model(ref)
    got = m.inference(to_port(ref["point"]), **port_inject(ref["ssi_draws"]))["seg_logits"]
    assert_close(got.numpy(), ref["ssi"], np.asarray(ref["point"].mask))


def check_multistep(ref, kind):
    """`denoise_step` from JAX's initial state (t = T-1, then t = 0 on
    that step's state) and `inference_multistep` MSAI and MSFI with JAX's
    state and Gumbel uniforms: categorical states equal, logits and
    Gaussian states within the logits bound."""
    m = port_model(ref)
    pt = to_port(ref["point"])
    valid = np.asarray(ref["point"].mask)
    steps = ref["multi"]["avg"]["steps"]
    assert [s["t"] for s in steps] == [19, 9, 0]
    assert all((s["u"] is not None) == (kind in D3PM) for s in steps)
    state = to_state(ref["state0"])
    for k, s in enumerate(steps):
        kw = dict(uniform=T(s["u"])) if kind in D3PM else {}
        res = m.denoise_step(pt, state, s["t"], **kw)
        assert_close(res["n_logits"].numpy(), s["n_logits"], valid)
        got = res["state"] if isinstance(res["state"], tuple) else (res["state"],)
        want = s["state"] if isinstance(s["state"], tuple) else (s["state"],)
        for g, w in zip(got, want):
            if np.issubdtype(w.dtype, np.integer):
                np.testing.assert_array_equal(g.numpy(), w)
            else:
                assert_close(g.numpy(), w, valid)
        state = to_state(s["state"])  # the next step from JAX's state
    us = [T(s["u"]) for s in steps] if kind in D3PM else None
    for mode in ("avg", "final"):
        got = ta.inference_multistep(m, pt, step=STEPS, mode=mode,
                                     state=to_state(ref["state0"]), uniforms=us)
        assert_close(got.numpy(), ref["multi"][mode]["logits"], valid)


# ---- the engine on an ablation model ----

def _fixed_q_jax(self, labels, ts_pt, key):
    return ((jnp.arange(labels.shape[0]) * 7 + ts_pt) % self.num_classes).astype(labels.dtype)


def _fixed_ts_jax(self, point):
    ts = jnp.full((point.num_scenes,), 7, jnp.int32)
    return ts, jnp.take(ts, jnp.clip(point.batch, 0, point.num_scenes - 1)), None


def _fixed_q_port(self, labels, ts_pt, generator=None, keep=None, uniform=None):
    n = labels.shape[0]
    return ((torch.arange(n) * 7 + ts_pt) % self.num_classes).to(labels.dtype)


def _fixed_ts_port(self, point, gens, ts_scene):
    ts = torch.full((point.num_scenes,), 7, dtype=torch.int32)
    return ts, ts[point.batch.long().clamp(0, point.num_scenes - 1)]


def test_tester_non_cnf_route_matches_jax(jref, tmp_path, monkeypatch):
    """JAX's `SemSegTester` sends a model that is not a `CNFSegmentor`
    through its plain forward in eval mode and reads ``n_pred``: for ⑤ the
    training forward, which draws a timestep and noised labels from the
    fragment's labels (-1 where the test pipeline collects none). With both
    packages' draws replaced by the same function of the points, the
    per-fragment probabilities agree."""
    kind = "DiscreteDMSegmentor"
    ref = jref[kind]
    root = str(tmp_path / "data")
    _write_synthetic_dataset(root, n_scenes=2, n_points=300)
    model = jbuild(copy.deepcopy(ref["cfg"]))
    n = 512
    point = jmake(coord=jnp.zeros((n, 3)), feat=jnp.zeros((n, 6)),
                  grid_coord=jnp.zeros((n, 3), jnp.int32), batch=jnp.zeros((n,), jnp.int32),
                  mask=jnp.zeros((n,), bool).at[:300].set(True),
                  segment=jnp.zeros((n,), jnp.int32), depth=7, num_scenes=1)
    variables = as_numpy(random_variables(model, point))
    monkeypatch.setattr(ja._DiffusionBase, "_sample_ts", _fixed_ts_jax)
    monkeypatch.setattr(ja._D3PMMixin, "d3pm_q_sample", _fixed_q_jax)
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                              optax.identity(), jax.random.PRNGKey(0))
    jt = JTester(Config(Config._wrap(scene_cfg(root, str(tmp_path / "jax"),
                                               model=copy.deepcopy(ref["cfg"])))),
                 state=state, model=model, verbose=False)
    want = []
    predict = jt.predict_fragment

    def record(frag, rng):
        p = predict(frag, rng)
        want.append(np.asarray(p))
        return p

    jt.predict_fragment = record
    jmiou = jt.test()

    monkeypatch.setattr(ta._DiffusionBase, "_timesteps", _fixed_ts_port)
    monkeypatch.setattr(ta._D3PMMixin, "d3pm_q_sample", _fixed_q_port)
    m = tbuild(copy.deepcopy(ref["cfg"]), device="cpu")
    load_jax_variables(m, variables)
    tester = SemSegTester(Config(Config._wrap(scene_cfg(root, str(tmp_path / "port"),
                                                        model=copy.deepcopy(ref["cfg"])))),
                          model=m, device="cpu", verbose=False)
    got = []
    tpredict = tester.predict_fragment

    def trecord(frag, index, noise_fn=None, feat_noise_fn=None):
        p = tpredict(frag, index, noise_fn, feat_noise_fn)
        got.append(p.numpy())
        return p

    tester.predict_fragment = trecord
    miou = tester.test()
    assert len(got) == len(want) >= 4
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-4
    assert sorted(tester.records) == sorted(jt.records)
    assert miou == pytest.approx(jmiou, abs=1e-6)


def test_evaluator_draws_each_scenes_start_from_its_own_generator(jref, tmp_path):
    """`SemSegEvaluator` on ⑤: the model draws its SSI start (no
    `draw_ssi_noise`) from a generator seeded for scene i from ``(seed +
    epoch, i)``, whatever was evaluated before it, so that ranks that split
    the scenes draw what one process draws."""
    from cdsegnet_torch.engine import hooks as thooks
    from cdsegnet_torch.engine.state import rank_seed
    from test_torch_trainer import port_eval_trainer

    root = str(tmp_path / "data")
    _write_synthetic_dataset(root)
    m = port_model(jref["DiscreteDMSegmentor"])
    tr = port_eval_trainer(trainer_cfg(root, "unused"), m, epoch=2)
    seen = []
    step = tr.eval_step

    def recorded(batch, generator=None, noise=None):
        assert noise is None
        seen.append((batch, generator.get_state()))
        return step(batch, generator=generator, noise=noise)

    tr.eval_step = recorded
    hook = thooks.SemSegEvaluator()
    hook.trainer = tr
    hook.after_epoch()
    assert len(seen) == 2
    for i, (_, state) in enumerate(seen):
        want = torch.Generator().manual_seed(rank_seed(tr.seed + tr.epoch, i + 1))
        assert torch.equal(state, want.get_state())
    assert not torch.equal(seen[0][1], seen[1][1])


@pytest.mark.parametrize("kind", HERE)
def test_ablation_forward_matches_jax(jref, kind):
    check_forward(jref[kind], kind)


@pytest.mark.parametrize("kind", HERE)
def test_ablation_train_step_matches_jax(jref, kind):
    check_train_step(jref[kind], kind)


@pytest.mark.parametrize("kind", HERE)
def test_ablation_ssi_matches_jax(jref, kind):
    check_ssi(jref[kind], kind)


@pytest.mark.parametrize("kind", HERE)
def test_ablation_multistep_matches_jax(jref, kind):
    check_multistep(jref[kind], kind)
