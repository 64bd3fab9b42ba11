"""The port's microbatches and ranks against the JAX package.

The microbatch step against JAX's `_grads_micro`, and the two-rank step at
microbatch 1 and 2 against JAX's step over a mesh of two virtual devices
(`_build_grad_step` with the draws injected through the batch, the
optimizer swapped for one that keeps the averaged gradients): loss, every
gradient, the running statistics and the AdamW update. `TrainLoader`'s
micro buckets and each rank's scenes against JAX's loader. Two gloo ranks
on the CPU, spawned by `parallel.dist.launch` (workers in
`tests/torch_ranks.py`): the step (the ranks bit-equal), the evaluator and
the fragment-parallel tester in SSI and MSAI (equal to one rank, and to
JAX's with JAX's noise fed in), the testing CLI on two ranks spawned by
``--num-gpus 2`` or by ``torchrun`` (one process's predictions), and the
training CLI with ``--num-gpus 2``, stopped after an epoch and resumed,
bit-equal to an uninterrupted run. Also the rules: ``num_devices`` > 1
without a process group raises, and no rank runs on the CPU unless asked."""

import copy
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from cdsegnet_tpu.data import datasets as jdatasets  # noqa: E402
from cdsegnet_tpu.data import loader as jloader  # noqa: E402
from cdsegnet_tpu.engine.optimizer import build_optimizer as jbuild_optimizer  # noqa: E402
from cdsegnet_tpu.engine.state import TrainState, _build_grad_step  # noqa: E402
from cdsegnet_tpu.engine.state import batch_to_point as jbatch_to_point  # noqa: E402
from cdsegnet_tpu.engine.test import SemSegTester as JTester  # noqa: E402
from cdsegnet_tpu.models import losses as jl  # noqa: E402
from cdsegnet_tpu.models.builder import build_model as jbuild  # noqa: E402
from cdsegnet_tpu.models.structure import make_point_batch as jmake  # noqa: E402
from cdsegnet_tpu.parallel.mesh import make_mesh  # noqa: E402
from cdsegnet_torch.data import datasets as tdatasets  # noqa: E402
from cdsegnet_torch.data import loader as tloader  # noqa: E402
from cdsegnet_torch.engine import hooks as thooks  # noqa: E402
from cdsegnet_torch.engine.checkpoint import CheckpointManager  # noqa: E402
from cdsegnet_torch.engine.config import Config  # noqa: E402
from cdsegnet_torch.engine.optimizer import build_optimizer  # noqa: E402
from cdsegnet_torch.engine.state import make_generators, make_train_step  # noqa: E402
from cdsegnet_torch.engine.test import SemSegTester  # noqa: E402
from cdsegnet_torch.engine.train import Trainer  # noqa: E402
from cdsegnet_torch.tools import test as ttool  # noqa: E402
from cdsegnet_torch.models.builder import build_model as tbuild  # noqa: E402
from cdsegnet_torch.models.builder import build_model_criteria  # noqa: E402
from cdsegnet_torch.parallel import dist  # noqa: E402
from cdsegnet_torch.utils.synthetic import synthetic_arrays  # noqa: E402
from cdsegnet_torch.utils.weights import load_jax_variables  # noqa: E402
from test_engine import _write_synthetic_dataset  # noqa: E402
from test_model import TINY_MODEL  # noqa: E402
from test_torch_data import assert_same, jax_numpy_host_ops  # noqa: E402,F401
from test_torch_model import N, as_numpy, random_variables  # noqa: E402
from test_torch_tester import TEST_DATA, outputs, scene_cfg  # noqa: E402
from test_torch_train import (CRITERIA, OPTIMIZER, PARAM_DICTS, SCHEDULER,  # noqa: E402
                              TOTAL_STEPS, jax_train_out, train_cfg)
from test_torch_train_data import train_dataset_cfg  # noqa: E402
from test_torch_trainer import (TINY_CONFIG, jeval, port_eval_trainer, root,  # noqa: E402,F401
                                trainer_cfg)
import torch_ranks  # noqa: E402
from torch_ranks import launch_cases, numpy_point  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = lambda x: torch.from_numpy(np.array(x))


# ---- the step: JAX's references ----

def micro_point(seed):
    """N slots of two scenes that fit the pyramid (as `batches()["fit"]`)."""
    a = synthetic_arrays(N, 2, depth=6, seed=seed)
    return jmake(**{k: jnp.asarray(v) for k, v in a.items()}, depth=6, num_scenes=2)


def micro_draws(seed, point):
    rng = np.random.RandomState(seed)
    return dict(ts_scene=rng.randint(0, 50, point.num_scenes).astype(np.int32),
                noise=rng.randn(N, 6).astype(np.float32),
                mse_valid=np.asarray(point.mask) & (rng.rand(N) < 0.5))


# the micro buckets of each rank (JAX device) in the two-rank microbatch-2 step
RANK_MICROS = ((0, 1), (1, 0))


def keep_gradients():
    """An optax transformation that leaves the parameters and keeps the
    gradients it is given as its state."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)
    return optax.GradientTransformation(lambda p: zeros(p),
                                        lambda g, s, p=None: (zeros(g), g))


def jax_step(jm, variables, buckets, mesh, microbatch):
    """JAX's own step builder (`_build_grad_step`: the micro scan, the
    mesh's `pmean`s) on ``buckets``, every draw injected through the batch:
    the averaged loss and gradients, the new running statistics, and the
    parameters after AdamW + OneCycle from those gradients."""
    crit = jl.Criteria(CRITERIA, loss_type="GLS", task_num=2)

    def apply_loss(state, batch, rngs):
        point = jbatch_to_point(batch, 6, 2)

        def loss_fn(params):
            out, mutated = jm.apply(
                {"params": params, "batch_stats": state.batch_stats}, point,
                batch["ts_scene"], batch["noise"], batch["mse_valid"],
                method=jax_train_out, mutable=["batch_stats"], rngs=rngs)
            return crit(out, mode="train"), (out, mutated["batch_stats"])

        return loss_fn, lambda out: dict(valid_points=jnp.sum(point.mask))

    step = _build_grad_step(apply_loss, keep_gradients(), mesh, microbatch=microbatch)
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                              keep_gradients(), jax.random.PRNGKey(0))
    new_state, metrics = step(state, buckets)
    grads = as_numpy(new_state.opt_state)
    tx = jbuild_optimizer(OPTIMIZER, variables["params"], SCHEDULER, TOTAL_STEPS,
                          PARAM_DICTS)
    upd, _ = jax.jit(tx.update)(jax.tree_util.tree_map(jnp.asarray, grads),
                                jax.jit(tx.init)(variables["params"]), variables["params"])
    return dict(loss=float(metrics["loss"]), grads=grads,
                stats=as_numpy(new_state.batch_stats),
                params=as_numpy(jax.jit(optax.apply_updates)(variables["params"], upd)),
                valid_points=int(np.sum(metrics["valid_points"])))


def stack(buckets):
    """Batch dicts of the micros (or devices) on a leading axis."""
    return {k: np.stack([b[k] for b in buckets]) for k in buckets[0]}


def bucket_dict(point, d):
    b = {k: v for k, v in numpy_point(point).items() if k not in ("depth", "num_scenes")}
    b.update(d)
    return b


@pytest.fixture(scope="module")
def jsteps():
    """The three JAX steps on the same tiny model, weights and two buckets:
    one device with two micro buckets, two devices of one bucket each, and
    two devices of two micro buckets each (`RANK_MICROS`: the second device
    takes them in the other order, so its running statistics carry
    otherwise)."""
    jm = jbuild(train_cfg())
    # the ranks take the micros' buckets and draws: the same mean gradient,
    # other running statistics (averaged, not carried). The bound is tight
    # for this f32 model: other buckets and draws put the port 1.1x (fc_t1)
    # to 3.2x (the stem's weight) past it, where JAX's own f32 gradient is
    # also past it against the port's float64 one (ROADMAP Queue 3)
    points = [micro_point(seed) for seed in (3, 4)]
    draws = [micro_draws(40 + i, p) for i, p in enumerate(points)]
    variables = as_numpy(random_variables(jm, points[0]))
    buckets = [bucket_dict(p, d) for p, d in zip(points, draws)]
    # (device, micro, ...) for the last; the three compile on parallel
    # threads (this file runs late in the suite, where cores are free)
    jobs = dict(micro=(stack(buckets), None, 2), ranks=(stack(buckets), make_mesh(2), 1),
                ranks_micro=(stack([stack([buckets[i] for i in micros])
                                    for micros in RANK_MICROS]), make_mesh(2), 2))
    with ThreadPoolExecutor(len(jobs)) as ex:
        futures = {k: ex.submit(jax_step, jm, variables, *args) for k, args in jobs.items()}
        steps = {k: f.result() for k, f in futures.items()}
    return dict(variables=variables, points=points, draws=draws, **steps)


def bridged(variables, params=None, stats=None):
    """A JAX params or batch_stats tree in the port's names: ``{name: tensor}``."""
    m = tbuild(train_cfg(), device="cpu")
    load_jax_variables(m, dict(params=variables["params"] if params is None else params,
                               batch_stats=(variables["batch_stats"] if stats is None
                                            else stats)))
    return dict(m.named_parameters()) if stats is None else dict(m.named_buffers())


def port_inject(d):
    return dict(ts_scene=T(d["ts_scene"]), noise=T(d["noise"]),
                mse_valid=T(d["mse_valid"]))


def assert_step_matches(ref, variables, loss, grads, params, buffers, lrs):
    """As `tests/test_torch_train.py`: the loss to 1e-5; per tensor, max |dg|
    <= 1e-4 of the tensor's max |g| plus 1e-6 of the largest gradient; the
    running statistics to 1e-5; after one AdamW update each element within
    2 lr (a gradient at rounding-noise level takes a +-lr step of the
    noise's sign), the median element within 1e-3 lr where the gradient is
    not noise."""
    np.testing.assert_allclose(loss, ref["loss"], rtol=1e-5)
    want_g = bridged(variables, params=ref["grads"])
    floor = 1e-6 * max(w.abs().max().item() for w in want_g.values())
    g_max = max(w.abs().max().item() for w in want_g.values())
    want_p = bridged(variables, params=ref["params"])
    for name, w in want_g.items():
        g = grads[name]
        assert (g - w.detach()).abs().max().item() <= 1e-4 * w.abs().max().item() + floor, name
        d = (params[name] - want_p[name]).abs().detach()
        lr = lrs[name]
        assert d.max().item() <= 2 * lr + 1e-6, name
        if w.abs().max().item() > 1e-6 * g_max:
            tol = 1e-3 * lr + 1.2e-7 * want_p[name].abs().max().item()
            assert d.median().item() <= tol, name
    want_s = bridged(variables, stats=ref["stats"])
    for name, b in buffers.items():
        np.testing.assert_allclose(b.numpy(), want_s[name].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def port_parts(variables):
    m = tbuild(train_cfg(), device="cpu")
    load_jax_variables(m, variables)
    opt = build_optimizer(OPTIMIZER, m, SCHEDULER, TOTAL_STEPS, PARAM_DICTS, device="cpu")
    return m, opt


def first_lrs(opt):
    lrs = opt.lrs()
    return {n: lrs[g] for n, g in opt.labels.items()}


def test_microbatch_step_matches_jax(jsteps):
    """Two micro buckets through `make_train_step(microbatch=2)` against
    JAX's `_grads_micro`: the running statistics carry from micro to micro,
    the gradients are the micros' mean, then one AdamW update."""
    from test_torch_model import to_port

    m, opt = port_parts(jsteps["variables"])
    lrs = first_lrs(opt)
    step = make_train_step(m, build_model_criteria(train_cfg()), opt, device="cpu",
                           microbatch=2)
    points = [to_port(p) for p in jsteps["points"]]
    injects = [port_inject(d) for d in jsteps["draws"]]
    metrics = step(points, **{k: [i[k] for i in injects] for k in injects[0]})
    ref = jsteps["micro"]
    assert int(metrics["valid_points"]) == ref["valid_points"] == sum(
        int(p.mask.sum()) for p in points)
    assert [metrics[f"dropped_l{i}"] for i in range(1, 5)] == [0, 0, 0, 0]
    assert_step_matches(ref, jsteps["variables"], metrics["loss"].item(),
                        {n: p.grad for n, p in m.named_parameters()},
                        dict(m.named_parameters()), dict(m.named_buffers()), lrs)
    # the micros' mean is not either micro's gradient alone
    with pytest.raises(ValueError, match="micro buckets"):
        step(points[0], **injects[0])


# ---- the ranks: cases run by two gloo processes ----

def port_state(variables):
    m = tbuild(copy.deepcopy(TINY_MODEL), device="cpu")
    load_jax_variables(m, as_numpy(variables))
    return m.state_dict()


@pytest.fixture(scope="module")
def jtest(tmp_path_factory):
    """JAX's fragment-parallel tester over two virtual devices (one
    fragment per device and group), its per-fragment noise recorded."""
    tmp = tmp_path_factory.mktemp("ptester")
    data = str(tmp / "data")
    _write_synthetic_dataset(data, n_scenes=2, n_points=300)
    model = jbuild(copy.deepcopy(TINY_MODEL))
    n = 512
    point = jmake(coord=jnp.zeros((n, 3)), feat=jnp.zeros((n, 6)),
                  grid_coord=jnp.zeros((n, 3), jnp.int32), batch=jnp.zeros((n,), jnp.int32),
                  mask=jnp.zeros((n,), bool).at[:300].set(True),
                  segment=jnp.zeros((n,), jnp.int32), depth=7, num_scenes=1)
    variables = random_variables(model, point)
    state = TrainState.create(variables, optax.identity(), jax.random.PRNGKey(0))
    save = str(tmp / "jax")
    tester = JTester(Config(Config._wrap(scene_cfg(data, save, num_devices=2))),
                     state=state, model=model, verbose=False)
    assert tester.mesh is not None and tester.mesh.devices.size == 2
    noise = []
    prepare = tester._prepare_fragment

    def record(frag, rng):
        out = prepare(frag, rng)
        noise.append(np.asarray(out[3]))
        return out

    tester._prepare_fragment = record
    miou = tester.test()
    return dict(data=data, variables=variables, noise=noise, miou=miou,
                records=tester.records)


def msai_cfg(data, save, num_devices=2):
    return scene_cfg(data, save, num_devices=num_devices, inference_mode="MSAI",
                     inference_step=2)


@pytest.fixture(scope="module")
def ranks(jsteps, jtest, jeval, root, tmp_path_factory):
    """One launch of two gloo ranks on the CPU running every case: two
    steps of the two-rank step at microbatch 1 and at microbatch 2, the
    evaluator with JAX's noise and with its own, the tester with JAX's
    noise, with its own, rerun on its cache, and in MSAI."""
    tmp = tmp_path_factory.mktemp("ranks")
    m, _ = port_parts(jsteps["variables"])

    def rank_steps(microbatch):
        """Two steps: the JAX reference's draws, then others; rank r takes
        bucket r, or at microbatch 2 the buckets ``RANK_MICROS[r]``."""
        points = jsteps["points"]
        later = [micro_draws(60 + i, p) for i, p in enumerate(points)]
        steps = []
        for draws in (jsteps["draws"], later):
            ranks = []
            for r in (0, 1):
                mine = (r,) if microbatch == 1 else RANK_MICROS[r]
                injects = [port_inject(draws[i]) for i in mine]
                ranks.append(([numpy_point(points[i]) for i in mine],
                              injects[0] if microbatch == 1 else
                              {k: [i[k] for i in injects] for k in injects[0]}))
            steps.append(ranks)
        return steps

    eval_cfg = trainer_cfg(root, str(tmp / "unused"))
    eval_state = port_state(jeval["variables"])
    test_state = port_state(jtest["variables"])
    cases = {name: dict(kind="train_steps", model_cfg=train_cfg(), state=m.state_dict(),
                        optimizer=OPTIMIZER, scheduler=SCHEDULER, total_steps=TOTAL_STEPS,
                        param_dicts=PARAM_DICTS, microbatch=micro, steps=rank_steps(micro))
             for name, micro in (("step", 1), ("step_micro", 2))}
    cases.update(
        eval_jax=dict(kind="evaluate", cfg=eval_cfg, model_cfg=copy.deepcopy(TINY_MODEL),
                      state=eval_state, epoch=0, noise=jeval["noise"]),
        eval_own=dict(kind="evaluate", cfg=eval_cfg, model_cfg=copy.deepcopy(TINY_MODEL),
                      state=eval_state, epoch=3),
        test_jax=dict(kind="run_tester", cfg=scene_cfg(jtest["data"], str(tmp / "tj"),
                                                       num_devices=2),
                      model_cfg=copy.deepcopy(TINY_MODEL), state=test_state,
                      noise=jtest["noise"]),
        test_own=dict(kind="run_tester", cfg=scene_cfg(jtest["data"], str(tmp / "to"),
                                                       num_devices=2),
                      model_cfg=copy.deepcopy(TINY_MODEL), state=test_state),
        test_cached=dict(kind="run_tester", cfg=scene_cfg(jtest["data"], str(tmp / "to"),
                                                          num_devices=2),
                         model_cfg=copy.deepcopy(TINY_MODEL), state=test_state),
        test_msai=dict(kind="run_tester", cfg=msai_cfg(jtest["data"], str(tmp / "tm")),
                       model_cfg=copy.deepcopy(TINY_MODEL), state=test_state))
    out = launch_cases(cases, str(tmp), world=2, timeout=300)
    return dict(out=out, tmp=str(tmp), eval_cfg=eval_cfg, eval_state=eval_state,
                test_state=test_state)


@pytest.mark.parametrize("case, microbatch, ref", [("step", 1, "ranks"),
                                                  ("step_micro", 2, "ranks_micro")])
def test_two_rank_step_matches_jax_and_the_ranks_agree(jsteps, ranks, case, microbatch,
                                                       ref):
    """The first step against JAX's over two devices (the mean of the two
    devices' gradients, loss and running statistics, then AdamW), at
    microbatch 1 and at microbatch 2 (each device's micros scanned first:
    the gradients divided by micros times ranks); after each of two steps
    both ranks hold the same parameters and running statistics, bit for
    bit."""
    r0, r1 = (o[case] for o in ranks["out"])
    for a, b in zip(r0, r1):
        assert a["loss"] == b["loss"]
        for key in ("grads", "params", "buffers"):
            assert a[key].keys() == b[key].keys()
            for name in a[key]:
                assert torch.equal(a[key][name], b[key][name]), (key, name)
    _, opt = port_parts(jsteps["variables"])
    assert_step_matches(jsteps[ref], jsteps["variables"], r0[0]["loss"],
                        r0[0]["grads"], r0[0]["params"], r0[0]["buffers"], first_lrs(opt))
    # each rank counted its own buckets' points
    points = jsteps["points"]
    assert [r0[0]["valid_points"], r1[0]["valid_points"]] == [
        sum(int(np.sum(points[i].mask)) for i in ((r,) if microbatch == 1 else RANK_MICROS[r]))
        for r in (0, 1)]
    # the second step moved the parameters again
    assert any(not torch.equal(r0[0]["params"][n], r0[1]["params"][n]) for n in r0[0]["params"])
    # rank 0 keeps a single process's streams; rank 1 has its own
    own = make_generators(0, torch.device("cpu"))
    for k, g in own.items():
        assert torch.equal(r0[0]["generators"][k], g.get_state()), k
        assert not torch.equal(r1[0]["generators"][k], g.get_state()), k


def test_two_rank_evaluator_equals_one_rank_and_jax(jeval, ranks):
    """With JAX's noise fed in, each rank evaluates one val scene and the
    summed histograms, mIoU and `comm_info` are JAX's; with its own noise
    the two ranks give what one rank gives, though each draws every
    scene's noise and forwards half the scenes."""
    out = ranks["out"]
    want = np.sum([np.stack(h) for h in jeval["hists"]], axis=0)
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o["eval_jax"]["histograms"], want)
        assert o["eval_jax"]["comm_info"] == jeval["comm_info"]
        assert o["eval_jax"]["calls"] == [r]  # the noise of its own scene only
    model = tbuild(copy.deepcopy(TINY_MODEL), device="cpu")
    model.load_state_dict(ranks["eval_state"])
    tr = port_eval_trainer(ranks["eval_cfg"], model, epoch=3)
    hook = thooks.SemSegEvaluator()
    hook.trainer = tr
    hook.after_epoch()
    for o in out:
        np.testing.assert_array_equal(o["eval_own"]["histograms"], hook.histograms)
        assert o["eval_own"]["comm_info"] == tr.comm_info
    assert hook.histograms[2].sum() > 400  # both scenes' labelled points


def test_two_rank_tester_equals_one_rank_and_jax(jtest, ranks, tmp_path):
    """Rank ``k % 2`` forwards fragment k; both ranks end with the same
    records. With JAX's noise fed in: JAX's fragment-parallel records.
    With its own noise: one rank's preds, records and submission files; a
    rerun reads the cache and forwards nothing."""
    out = ranks["out"]
    n_frag = len(jtest["noise"])
    assert n_frag >= 4
    for r, o in enumerate(out):
        t = o["test_jax"]
        assert t["calls"] == list(range(r, n_frag, 2))
        assert len(t["forwarded"]) == len(range(r, n_frag, 2))
        assert sorted(t["records"]) == sorted(jtest["records"])
        for name, rec in jtest["records"].items():
            for k in ("intersection", "union", "target"):
                np.testing.assert_array_equal(t["records"][name][k], rec[k])
        assert t["miou"] == pytest.approx(jtest["miou"], abs=0)
    model = tbuild(copy.deepcopy(TINY_MODEL), device="cpu")
    model.load_state_dict(ranks["test_state"])
    save = str(tmp_path / "one")
    one = SemSegTester(Config(Config._wrap(scene_cfg(jtest["data"], save))),
                       model=model, device="cpu", verbose=False)
    one.test()
    names = sorted(one.records)
    want_files = outputs(save, names)
    got_files = outputs(os.path.join(ranks["tmp"], "to"), names)
    for name in names:
        np.testing.assert_array_equal(got_files[name][0], want_files[name][0])
        assert got_files[name][1] == want_files[name][1]
    for o in out:
        for case in ("test_own", "test_cached"):
            t = o[case]
            assert t["result"] == one.result
            for name in names:
                for k in ("intersection", "union", "target"):
                    np.testing.assert_array_equal(t["records"][name][k],
                                                  one.records[name][k])
        assert len(o["test_own"]["forwarded"]) >= n_frag // 2
        assert o["test_cached"]["forwarded"] == []
    assert sum(len(o["test_own"]["forwarded"]) for o in out) == n_frag


def test_two_rank_msai_tester_equals_one_rank(jtest, ranks, tmp_path):
    """MSAI splits its fragments over the ranks as SSI does (no rank waits
    out the run in a collective): rank ``k % 2`` runs fragment k's DDIM
    loop, and both ranks end with one rank's records, result and preds."""
    model = tbuild(copy.deepcopy(TINY_MODEL), device="cpu")
    model.load_state_dict(ranks["test_state"])
    save = str(tmp_path / "one")
    one = SemSegTester(Config(Config._wrap(msai_cfg(jtest["data"], save, num_devices=1))),
                       model=model, device="cpu", verbose=False)
    assert one.inference_mode == "MSAI"
    one.test()
    names = sorted(one.records)
    n_frag = len(jtest["noise"])
    for r, o in enumerate(ranks["out"]):
        t = o["test_msai"]
        assert len(t["forwarded"]) == len(range(r, n_frag, 2))
        assert t["result"] == one.result
        for name in names:
            for k in ("intersection", "union", "target"):
                np.testing.assert_array_equal(t["records"][name][k], one.records[name][k])
    got, want = (outputs(d, names) for d in (os.path.join(ranks["tmp"], "tm"), save))
    for name in names:
        np.testing.assert_array_equal(got[name][0], want[name][0])


@pytest.mark.parametrize("launcher", ["num_gpus", "torchrun"])
def test_tester_cli_on_two_ranks_equals_one_process(jtest, ranks, tmp_path, launcher):
    """`tools/test.py` on two gloo ranks on the CPU, spawned by
    ``--num-gpus 2`` or by ``torchrun`` (each process joins the group its
    environment describes): the predictions and the result of one
    process's run of the same CLI."""
    config = str(tmp_path / "tiny.py")
    with open(config, "w") as f:
        f.write(f"model = {copy.deepcopy(TINY_MODEL)!r}\n")

    def cli_args(save):
        os.makedirs(os.path.join(save, "model"))
        torch.save(dict(model=ranks["test_state"], step=0),
                   os.path.join(save, "model", "model_last"))
        data = dict(num_classes=5, ignore_index=-1, test=dict(TEST_DATA, data_root=jtest["data"]))
        return ["--config-file", config, "--checkpoint", "model_last", "--device", "cpu",
                "--options", f"save_path={save}", f"data={data!r}", "serialization_depth=7",
                "test_buckets=[256, 512]"]

    one = ttool.main(cli_args(str(tmp_path / "one")))
    save = str(tmp_path / launcher)
    run = ([sys.executable, "-m", "cdsegnet_torch.tools.test", "--num-gpus", "2"]
           if launcher == "num_gpus" else
           [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2", "-m", "cdsegnet_torch.tools.test"])
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    proc = subprocess.run(run + cli_args(save), cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("Test result: mIoU") == 1  # rank 0 logs
    assert f"Test result: mIoU {one.result['miou']:.4f}" in proc.stdout
    assert sorted(os.listdir(os.path.join(save, "result"))) == [
        f"{n}_pred.npy" for n in sorted(one.records)]
    for name in one.records:
        np.testing.assert_array_equal(
            np.load(os.path.join(save, "result", f"{name}_pred.npy")),
            np.load(os.path.join(tmp_path / "one", "result", f"{name}_pred.npy")))


# ---- the loader ----

class Recorder:
    """A dataset that records the scene ids it is asked for."""

    def __init__(self, ds):
        self.ds, self.ids = ds, []

    def __len__(self):
        return len(self.ds)

    def get(self, idx, rng):
        self.ids.append(idx)
        return self.ds.get(idx, rng)


def test_cli_two_ranks_resume_equals_an_uninterrupted_run(root, tmp_path):
    """``tools/train.py --num-gpus 2 --device cpu`` on the tiny config (two
    gloo ranks, microbatch 2, 2 epochs of 2 steps), run through; then the
    same run stopped after epoch 1 (a hook raises on both ranks) and
    resumed by the CLI: it ends bit-equal to the uninterrupted run, model,
    optimizer and both ranks' generators. Rank 0 alone writes the log, the
    metrics and the checkpoints."""
    whole = cli(str(tmp_path / "whole"), root)
    assert whole["step"] == 4 and len(whole["rank_generators"]) == 2
    resumed_dir = str(tmp_path / "resumed")
    with pytest.raises(Exception, match="stopped after epoch 1"):
        dist.launch(torch_ranks.train_cli_stopped, 2,
                    args=(cli_argv(resumed_dir, root, stop=True),), device="cpu", timeout=300)
    assert sorted(os.listdir(os.path.join(resumed_dir, "model"))) == [
        "epoch_1", "model_best", "model_last"]
    assert CheckpointManager(os.path.join(resumed_dir, "model")).restore_raw()["step"] == 2
    resumed = cli(resumed_dir, root, "resume=True")
    assert resumed["step"] == 4
    for k, v in whole["model"].items():
        assert torch.equal(v, resumed["model"][k]), k
    ow, orr = whole["optimizer"], resumed["optimizer"]
    assert ow["count"] == orr["count"] == 4
    for i, st in ow["opt"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, orr["opt"]["state"][i][k]), (i, k)
    for a, b in zip(whole["rank_generators"], resumed["rank_generators"]):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert not torch.equal(whole["rank_generators"][0]["dropout"],
                           whole["rank_generators"][1]["dropout"])
    log = open(tmp_path / "whole" / "train.log").read()
    assert log.count("Train [2/2][2/2] loss") == 1 and log.count("Val result") == 2
    recs = [json.loads(line) for line in open(tmp_path / "whole" / "metrics.jsonl")]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    # a checkpoint of two ranks does not resume one
    tr = Trainer(trainer_cfg(root, resumed_dir, resume=True), device="cpu")
    with pytest.raises(ValueError, match="generators of 2 ranks"):
        tr.train()


# ---- the rules ----

@pytest.fixture
def smoke_root(tmp_path):
    data = str(tmp_path / "data")
    _write_synthetic_dataset(data, n_scenes=4, n_points=400)
    return data


def test_micro_buckets_match_jax(smoke_root, jax_numpy_host_ops):
    """``microbatch=2``: each bucket is two micro buckets of one scene in
    half the slots, array-equal to JAX's `_collate_micro` (Mix3D within a
    micro bucket: a no-op at one scene each) over two epochs."""
    cfg = train_dataset_cfg(smoke_root, loop=2)
    kw = dict(num_devices=1, scenes_per_device=2, num_points=300, mix_prob=0.8,
              seed=54421566, prefetch=0, microbatch=2)
    jl_ = jloader.TrainLoader(jdatasets.build_dataset(cfg), **kw)
    tl = tloader.TrainLoader(tdatasets.build_dataset(cfg), **kw)
    assert len(tl) == len(jl_) == 4
    for epoch in (0, 1):
        for g, w in zip(tl.epoch(epoch), jl_.epoch(epoch)):
            assert_same(g, {k: v[0] for k, v in w.items()})
            assert g["coord"].shape == (2, 150, 3)
            assert (g["batch"][g["mask"]] == 0).all()  # one scene per micro


def test_rank_buckets_take_jax_devices_scenes(smoke_root, jax_numpy_host_ops):
    """Two ranks over two epochs: rank r loads exactly the scenes JAX's
    loader puts on device r, every step; rank 0's bucket is JAX's device 0
    bucket array for array (rank 1 draws its augmentations from its own
    stream). Both count global batches, as JAX's does."""
    cfg = train_dataset_cfg(smoke_root, loop=4)
    kw = dict(num_devices=2, scenes_per_device=2, num_points=300, mix_prob=0.8,
              seed=7, prefetch=0)
    jds = Recorder(jdatasets.build_dataset(cfg))
    jl_ = jloader.TrainLoader(jds, **kw)
    tls = [tloader.TrainLoader(Recorder(tdatasets.build_dataset(cfg)), rank=r, **kw)
           for r in (0, 1)]
    assert len(jl_) == len(tls[0]) == len(tls[1]) == 16 // 4
    for epoch in (0, 1):
        want = list(jl_.epoch(epoch))
        got = [list(t.epoch(epoch)) for t in tls]
        for g0, w in zip(got[0], want):
            assert_same(g0, {k: v[0] for k, v in w.items()})
        assert not all(np.array_equal(g1["coord"], w["coord"][1])
                       for g1, w in zip(got[1], want))
    per_step = np.array(jds.ids).reshape(-1, 2, 2)  # (step, device, scene)
    for r, t in enumerate(tls):
        np.testing.assert_array_equal(np.array(t.dataset.ids).reshape(-1, 2), per_step[:, r])
    assert set(per_step[:4].ravel()) == set(range(16))  # every scene once an epoch


# ---- the CLI on two ranks, stopped and resumed ----

def cli_argv(save, root_dir, *extra, stop=False):
    hooks = [dict(type="CheckpointLoader"), dict(type="InformationWriter", log_interval=1),
             dict(type="SemSegEvaluator"), dict(type="CheckpointSaver", save_freq=1)]
    hooks += [dict(type="StopAfterEpoch1")] if stop else []
    return ["--config-file", TINY_CONFIG, "--num-gpus", "2", "--device", "cpu",
            "--options", f"save_path={save}", "epoch=2", "microbatch=2",
            "data.train.loop=2", f"data.train.data_root={root_dir}",
            f"data.val.data_root={root_dir}", f"hooks={hooks!r}", *extra]


def cli(save, root_dir, *extra):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "cdsegnet_torch.tools.train", *cli_argv(save, root_dir, *extra)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return CheckpointManager(os.path.join(save, "model")).restore_raw("model_last")


def test_more_devices_need_a_process_group(root, tmp_path, monkeypatch):
    assert not dist.is_initialized() and dist.world_size() == 1
    with pytest.raises(RuntimeError, match="needs a process group"):
        Trainer(trainer_cfg(root, str(tmp_path), num_devices=2), device="cpu")
    cfg = Config(Config._wrap(scene_cfg("unused", str(tmp_path), num_devices=2)))
    with pytest.raises(RuntimeError, match="needs a process group"):
        SemSegTester(cfg, device="cpu")
    with pytest.raises(ValueError, match="rank 1 of num_devices=1"):
        tloader.TrainLoader([], rank=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dist.rank_device()
    assert dist.rank_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="2 ranks need 2 GPUs"):
        dist.launch(print, 2)
