"""The NCF ablation segmentors ⑥ CDDM and the single-branch DM in the port
against the JAX package: the same checks as `tests/test_torch_ablation.py`
(③–⑤ there), over its helpers and seeds, with this file's own JAX
references: the training forward and one step with every draw injected,
SSI, `denoise_step` and `inference_multistep` MSAI and MSFI with JAX's
state and Gumbel uniforms; the non-CNF tester route's draws, independent of
the rank; `D3PMKLLoss` in `Criteria`; ⑥ through the training CLI; a
converted JAX ⑥ checkpoint."""

import copy
import os
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import convert_jax_checkpoint as converter  # noqa: E402
from cdsegnet_tpu.models import ablation_segmentors as ja  # noqa: E402
from cdsegnet_tpu.models import losses as jl  # noqa: E402
from cdsegnet_torch.engine.checkpoint import CheckpointManager  # noqa: E402
from cdsegnet_torch.engine.config import Config  # noqa: E402
from cdsegnet_torch.engine.test import SemSegTester  # noqa: E402
from cdsegnet_torch.models import losses as tl  # noqa: E402
from cdsegnet_torch.models.builder import build_model as tbuild  # noqa: E402
from cdsegnet_torch.tools import train as ttrain  # noqa: E402
from test_engine import _write_synthetic_dataset  # noqa: E402
from test_torch_ablation import (CE, KINDS, KL, K, T, _SAMPLE, _sowing_sample,  # noqa: E402
                                 ablation_cfg, assert_close, check_forward,
                                 check_multistep, check_ssi, check_train_step,
                                 port_inject, port_model, reference)
from test_torch_convert import save_jax_train_state, write_config  # noqa: E402
from test_torch_model import to_port  # noqa: E402
from test_torch_tester import scene_cfg  # noqa: E402
from test_torch_trainer import default_hooks, trainer_cfg  # noqa: E402

torch.set_num_threads(2)
HERE = KINDS[3:]


@pytest.fixture(scope="module")
def jref():
    """The JAX references of this file's kinds, with `d3pm_ddim_sample`
    sowing its uniforms for their duration; compiled on parallel threads
    (this file runs late in the suite, where cores are free)."""
    ja._D3PMMixin.d3pm_ddim_sample = _sowing_sample
    try:
        with ThreadPoolExecutor(len(HERE)) as ex:
            return dict(zip(HERE, ex.map(lambda k: reference(KINDS.index(k), k), HERE)))
    finally:
        ja._D3PMMixin.d3pm_ddim_sample = _SAMPLE


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


def test_d3pm_kl_loss_in_criteria_matches_jax():
    rng = np.random.RandomState(3)
    n = 300
    out = dict(d3pm_pred_q=3 * rng.randn(n, K), d3pm_true_q=np.log(
        rng.dirichlet(np.ones(K), n) + 1e-6), n_pred=rng.randn(n, K),
        n_target=rng.randint(-1, K, n), seg_valid=np.arange(n) < 260)
    out = {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in out.items()}
    out["seg_valid"] &= out["n_target"] >= 0
    cfgs = [KL, dict(CE, pred="n_pred"), dict(KL, pred="d3pm_true_q", loss_weight=0.5)]
    got = tl.Criteria(cfgs, "EW")({k: T(v) for k, v in out.items()}).item()
    want = float(jl.Criteria(cfgs, "EW")({k: jnp.asarray(v) for k, v in out.items()}))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    kl = tl.d3pm_kl_loss(T(out["d3pm_pred_q"]), T(out["d3pm_true_q"]), T(out["seg_valid"]))
    assert kl.item() > 0.1


def test_tester_ablation_draws_do_not_depend_on_the_rank(jref, tmp_path):
    """The non-CNF route draws from a generator seeded per fragment: the
    same fragment forwarded twice, after other fragments or none, gives the
    same probabilities."""
    kind = "CDDMSegmentor"
    ref = jref[kind]
    root = str(tmp_path / "data")
    _write_synthetic_dataset(root, n_scenes=2, n_points=300)
    m = port_model(ref)
    cfg = Config(Config._wrap(scene_cfg(root, str(tmp_path / "port"),
                                        model=copy.deepcopy(ref["cfg"]))))
    from cdsegnet_torch.data.datasets import build_dataset

    scene = build_dataset(dict(cfg.data.test)).get(0, np.random.default_rng(0))
    frags = scene["fragment_list"]
    a = SemSegTester(cfg, model=m, device="cpu", verbose=False)
    first = [a.predict_fragment(f, i) for i, f in enumerate(frags)]
    b = SemSegTester(cfg, model=m, device="cpu", verbose=False)
    last = b.predict_fragment(frags[-1], len(frags) - 1)
    assert len(frags) > 1 and torch.equal(first[-1], last)


def test_train_cli_trains_an_ablation_config(tmp_path):
    """⑥ through the training CLI on the CPU: one evaluated epoch of two
    steps (the evaluator's SSI draws the model's own noise), checkpoints."""
    root = str(tmp_path / "data")
    _write_synthetic_dataset(root)
    save = str(tmp_path / "run")
    cfg = trainer_cfg(root, save, epoch=1, model=ablation_cfg("CDDMSegmentor"),
                      hooks=default_hooks(1))
    path = write_config(tmp_path / "cddm.py", cfg["model"],
                        **{k: v for k, v in cfg.items() if k != "model"})
    trainer = ttrain.main(["--config-file", path, "--device", "cpu"])
    assert trainer.step == 2
    assert {"model_best", "model_last"} <= set(os.listdir(os.path.join(save, "model")))
    log = open(os.path.join(save, "train.log")).read()
    assert "Train [1/1][2/2] loss" in log and "Val result: mIoU" in log
    import json

    recs = [json.loads(x) for x in open(os.path.join(save, "metrics.jsonl"))]
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)


def test_converted_ablation_checkpoint_loads(jref, tmp_path):
    """A `TrainState` of ⑥ saved by JAX's `CheckpointManager` converts with
    `convert_jax_checkpoint.py` (strict, nothing kept from the initializer)
    and gives JAX's SSI logits."""
    kind = "CDDMSegmentor"
    ref = jref[kind]
    config = write_config(tmp_path / "cddm.py", copy.deepcopy(ref["cfg"]))
    jax_dir = save_jax_train_state(ref["variables"], str(tmp_path / "jax"), 5)
    out_file = str(tmp_path / "port" / "model" / "model_last")
    got = converter.main(["--config-file", config, "--jax-checkpoint", jax_dir,
                          "--output", out_file])
    assert got["step"] == 5 and got["kept"] == []
    m = tbuild(copy.deepcopy(ref["cfg"]), device="cpu")
    CheckpointManager(os.path.dirname(out_file)).restore(m, "model_last")
    logits = m.inference(to_port(ref["point"]), **port_inject(ref["ssi_draws"]))["seg_logits"]
    assert_close(logits.numpy(), ref["ssi"], np.asarray(ref["point"].mask))
