"""The DDIM inference modes of the port against the JAX package: the time
schedule and the reverse step, each `denoise_step` (n-branch logits and the
next c state, the c-decoder in eval mode), `inference_ddim` in both modes
(MSAI averages the logits of every step, MSFI keeps the last) and the
tester's MSAI probabilities and records. The tiny model at the shipped
T = 1000 and cosine schedule, weights made with numpy from a seed and
carried across; the initial c state is JAX's draw, fed to the port."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from cdsegnet_tpu.engine.state import TrainState  # noqa: E402
from cdsegnet_tpu.engine.test import SemSegTester as JTester  # noqa: E402
from cdsegnet_tpu.models import diffusion as jdiff  # noqa: E402
from cdsegnet_tpu.models.builder import build_model as jbuild  # noqa: E402
from cdsegnet_tpu.models.segmentor import CNFSegmentor as JCNF  # noqa: E402
from cdsegnet_tpu.models.segmentor import inference_ddim as jinference_ddim  # noqa: E402
from cdsegnet_torch.engine.config import Config  # noqa: E402
from cdsegnet_torch.engine.test import SemSegTester  # noqa: E402
from cdsegnet_torch.models import diffusion as tdiff  # noqa: E402
from cdsegnet_torch.models.builder import build_model as tbuild  # noqa: E402
from cdsegnet_torch.models.segmentor import inference_ddim  # noqa: E402
from cdsegnet_torch.utils.weights import load_jax_variables  # noqa: E402
from test_engine import _write_synthetic_dataset  # noqa: E402
from test_torch_model import N, as_numpy, batches, random_variables, tiny_cfg, to_port  # noqa: E402
from test_torch_tester import scene_cfg  # noqa: E402

torch.set_num_threads(2)
STEPS = 3  # time_schedule(1000, 3) = [999, 665, 332, -1]: four forwards
T = lambda x: torch.from_numpy(np.array(x))


def ddim_cfg():
    cfg = tiny_cfg()
    cfg["T"] = 1000
    return cfg


def close(got, want, valid=None):
    """max |got - want| <= 1e-4 max |want| + 1e-5 over the valid rows (the
    SSI tolerance of tests/test_torch_model.py)."""
    got, want = np.asarray(got), np.asarray(want)
    if valid is not None:
        got, want = got[valid], want[valid]
    err = np.abs(got - want).max()
    assert err <= 1e-4 * np.abs(want).max() + 1e-5, (err, np.abs(want).max())


@pytest.mark.parametrize("t_max,step", [(1000, 5), (1000, 3), (1000, 1), (50, 3)])
def test_time_schedule_matches_jax(t_max, step):
    got, want = tdiff.time_schedule(t_max, step), jdiff.time_schedule(t_max, step)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and got[0] == t_max - 1 and got[-1] == -1


@pytest.mark.parametrize("target", ["noise", "x0"])
@pytest.mark.parametrize("schedule", [("cosine", 0, 1000), ("linear", 0.001, 0.005)])
def test_ddim_step_matches_jax(target, schedule):
    name, b0, b1 = schedule
    js = jdiff.DiffusionSchedule.create(name, b0, b1, 1000)
    ts = tdiff.DiffusionSchedule.create(name, b0, b1, 1000)
    rng = np.random.RandomState(4)
    x_t, out = (rng.randn(300, 6).astype(np.float32) for _ in range(2))
    t = rng.randint(0, 1000, 300).astype(np.int32)
    t[:20] = 0  # rows at t = 0 return x0
    t[20:40] = 999
    want = np.asarray(js.ddim_step(jnp.asarray(x_t), jnp.asarray(t), jnp.asarray(out),
                                   target=target))
    got = ts.ddim_step(T(x_t), T(t), T(out), target=target).numpy()
    # f32 on both sides: x0 = (x_t - sqrt(1 - ab) eps) / sqrt(ab) divides by
    # sqrt(ab), down to 4.9e-5 at t = 999, so compare each row to its size
    scale = np.abs(want).max(1, keepdims=True)
    assert (np.abs(got - want) <= 1e-5 * scale + 1e-6).all()
    # a scalar step for every row, as denoise_step gives it
    want1 = np.asarray(js.ddim_step(jnp.asarray(x_t), jnp.int32(500), jnp.asarray(out),
                                    target=target))
    got1 = ts.ddim_step(T(x_t), torch.tensor(500), T(out), target=target).numpy()
    np.testing.assert_allclose(got1, want1, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jref():
    """JAX: every denoise step of the loop from one initial state (the input
    c state, logits and next state of each), and `inference_ddim` in both
    modes from the same state."""
    pt = batches()["fit"]
    jm = jbuild(ddim_cfg())
    variables = as_numpy(random_variables(jm, pt))
    rng = jax.random.PRNGKey(11)
    c0 = np.asarray(jax.random.normal(rng, (N, 6), jnp.float32))  # inference_ddim's draw
    geometry = jax.jit(jm.backbone.precompute_geometry)(pt)
    step = jax.jit(lambda v, p, cf, t, g: jm.apply(v, p, cf, t, g,
                                                   method=JCNF.denoise_step))
    steps, c_feat = [], jnp.asarray(c0)
    for t in jdiff.time_schedule(jm.T, STEPS):
        res = step(variables, pt, c_feat, jnp.int32(max(t, 0)), geometry)
        steps.append(dict(t=int(max(t, 0)), c_in=np.asarray(c_feat),
                          logits=np.asarray(res["n_logits"]),
                          c_next=np.asarray(res["c_next"])))
        c_feat = res["c_next"]
    modes = {mode: np.asarray(jinference_ddim(jm, variables, pt, rng, step=STEPS,
                                              mode=mode, jit_step=step))
             for mode in ("avg", "final")}
    return dict(point=pt, variables=variables, c0=c0, steps=steps, modes=modes)


def port_model(variables):
    m = tbuild(ddim_cfg(), device="cpu")
    load_jax_variables(m, variables)
    return m.eval()


def test_denoise_steps_match_jax(jref):
    """Each step from JAX's own input state: the logits and the next c
    state. The states grow as the loop divides by sqrt(alpha_bar) (from 3.5
    to 287 after the first step at these random weights), so both are held
    relative to their size (read: under 1e-6 of it)."""
    m = port_model(jref["variables"])
    pt = to_port(jref["point"])
    geometry = m.backbone.precompute_geometry(pt)
    valid = np.asarray(jref["point"].mask)
    assert [s["t"] for s in jref["steps"]] == [999, 665, 332, 0]
    for s in jref["steps"]:
        res = m.denoise_step(pt, T(s["c_in"]), s["t"], geometry)
        close(res["n_logits"].numpy(), s["logits"], valid)
        close(res["c_next"].numpy(), s["c_next"], valid)
    assert np.abs(jref["steps"][1]["c_in"][valid]).max() > 100  # the growth


@pytest.mark.parametrize("mode", ["avg", "final"])
def test_inference_ddim_matches_jax(jref, mode):
    """The whole loop from the injected initial state. MSAI divides the sum
    of the four steps' logits by len(time_schedule) = 4, the t = -1 slot
    included; MSFI is the last step's logits. Held as each step is (read:
    under 6e-7 of max |logits|)."""
    m = port_model(jref["variables"])
    valid = np.asarray(jref["point"].mask)
    got = inference_ddim(m, to_port(jref["point"]), step=STEPS, mode=mode,
                         noise=T(jref["c0"]))
    close(got.numpy(), jref["modes"][mode], valid)
    logits = [s["logits"] for s in jref["steps"]]
    want = sum(logits) / 4.0 if mode == "avg" else logits[-1]
    close(jref["modes"][mode], want, valid)


def test_inference_ddim_draws_from_its_generator(jref):
    m = port_model(jref["variables"])
    pt = to_port(jref["point"])
    run = lambda seed: inference_ddim(m, pt, step=1, mode="final",
                                      generator=torch.Generator().manual_seed(seed))
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="MSAI"):
        inference_ddim(m, pt, mode="mean")


@pytest.fixture(scope="module")
def jtester(tmp_path_factory):
    """JAX's tester in MSAI mode: per-fragment noise (its initial c state)
    and probabilities, recorded by wrapping the instance's methods, and the
    records."""
    tmp = tmp_path_factory.mktemp("ddim_tester")
    root = str(tmp / "data")
    _write_synthetic_dataset(root, n_scenes=2, n_points=300)
    model = jbuild(ddim_cfg())
    variables = random_variables(model, batches()["fit"])
    state = TrainState.create(variables, optax.identity(), jax.random.PRNGKey(0))
    cfg = scene_cfg(root, str(tmp / "jax"), inference_mode="MSAI",
                    inference_step=STEPS, model=ddim_cfg())
    tester = JTester(Config(Config._wrap(cfg)), state=state, model=model, verbose=False)
    noise, probs = [], []
    prepare, predict = tester._prepare_fragment, tester.predict_fragment

    def record_noise(frag, rng):
        out = prepare(frag, rng)
        noise.append(np.asarray(out[3]))
        # the DDIM loop draws its initial state from the same key and shape
        c0 = np.asarray(jax.random.normal(out[4], (out[0], 6), jnp.float32))
        assert np.array_equal(c0, noise[-1])
        return out

    def record_probs(frag, rng):
        p = predict(frag, rng)
        probs.append(np.asarray(p))
        return p

    tester._prepare_fragment = record_noise
    tester.predict_fragment = record_probs
    miou = tester.test()
    return dict(root=root, cfg=cfg, variables=as_numpy(variables), noise=noise,
                probs=probs, miou=miou, records=tester.records)


def test_msai_tester_matches_jax(jtester, tmp_path):
    cfg = dict(jtester["cfg"], save_path=str(tmp_path / "port"))
    tester = SemSegTester(Config(Config._wrap(cfg)), model=port_model(jtester["variables"]),
                          device="cpu", verbose=False)
    assert tester.inference_mode == "MSAI" and tester.inference_step == STEPS
    probs = []
    predict = tester.predict_fragment

    def record_probs(frag, index, noise_fn=None, feat_noise_fn=None):
        p = predict(frag, index, noise_fn, feat_noise_fn)
        probs.append(p.numpy())
        return p

    tester.predict_fragment = record_probs
    miou = tester.test(noise_fn=lambda i, bucket, c_in: np.array(jtester["noise"][i]))
    assert len(probs) == len(jtester["probs"]) >= 4
    for got, want in zip(probs, jtester["probs"]):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4
    assert sorted(tester.records) == sorted(jtester["records"])
    for name, rec in jtester["records"].items():
        for k in ("intersection", "union", "target"):
            np.testing.assert_array_equal(tester.records[name][k], rec[k])
    assert miou == pytest.approx(jtester["miou"], abs=0)
