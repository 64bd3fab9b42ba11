"""`convert_jax_checkpoint.py` against the JAX package: a `TrainState` that
JAX's `CheckpointManager` saved (orbax), converted into a port checkpoint,
gives JAX's tester records in the port's `SemSegTester` with JAX's noise
fed in; a Baseline (dm=False) checkpoint, which has no timestep MLP, converts, names
the tensors the port's initializer filled, and its training forward gives
JAX's loss with the draws injected."""

import copy
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import convert_jax_checkpoint as converter  # noqa: E402
from cdsegnet_tpu.engine.checkpoint import CheckpointManager as JManager  # noqa: E402
from cdsegnet_tpu.engine.state import TrainState  # noqa: E402
from cdsegnet_tpu.models import losses as jl  # noqa: E402
from cdsegnet_tpu.models.builder import build_model as jbuild  # noqa: E402
from cdsegnet_torch.engine.checkpoint import CheckpointManager  # noqa: E402
from cdsegnet_torch.engine.config import Config  # noqa: E402
from cdsegnet_torch.engine.test import SemSegTester  # noqa: E402
from cdsegnet_torch.models.builder import build_model as tbuild  # noqa: E402
from cdsegnet_torch.models.builder import build_model_criteria  # noqa: E402
from test_model import TINY_MODEL  # noqa: E402
from test_torch_model import N, as_numpy, random_variables, to_port  # noqa: E402
from test_torch_tester import ref, scene_cfg  # noqa: E402,F401
from test_torch_variants import jax_train_out, variant_cfg, variant_point  # noqa: E402

torch.set_num_threads(2)
T = lambda x: torch.from_numpy(np.array(x))


def write_config(path, model_cfg, **extra):
    """A config file holding ``model`` (and ``extra``) as literals."""
    with open(path, "w") as f:
        for k, v in dict(model=model_cfg, **extra).items():
            f.write(f"{k} = {v!r}\n")
    return str(path)


def save_jax_train_state(variables, ckpt_dir, step):
    """A `TrainState` with AdamW moments, saved by JAX's `CheckpointManager`
    as ``model_last``; returns its directory."""
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                              optax.adamw(1e-3), jax.random.PRNGKey(0))
    JManager(ckpt_dir).save(state.replace(step=jnp.int32(step)), "model_last")
    return os.path.join(ckpt_dir, "model_last")


def test_converted_checkpoint_gives_jax_records(ref, tmp_path, capsys):
    config = write_config(tmp_path / "tiny.py", copy.deepcopy(TINY_MODEL))
    jax_dir = save_jax_train_state(ref["variables"], str(tmp_path / "jax"), 7)
    save = str(tmp_path / "port")
    out = converter.main(["--config-file", config, "--jax-checkpoint", jax_dir,
                          "--output", os.path.join(save, "model", "model_best")])
    assert out["step"] == 7 and out["kept"] == []
    assert "step 7 ->" in capsys.readouterr().out
    state = CheckpointManager(os.path.join(save, "model")).restore_raw("model_best")
    assert sorted(state) == ["model", "step"]  # weights only: no optimizer moments
    model = tbuild(copy.deepcopy(TINY_MODEL), device="cpu")
    CheckpointManager(os.path.join(save, "model")).restore(model, "model_best")
    tester = SemSegTester(Config(Config._wrap(scene_cfg(ref["root"], save))), model=model,
                          device="cpu", verbose=False)
    miou = tester.test(noise_fn=lambda i, bucket, c_in: np.array(ref["noise"][i]))
    assert sorted(tester.records) == sorted(ref["records"])
    for name, rec in ref["records"].items():
        for k in ("intersection", "union", "target"):
            np.testing.assert_array_equal(tester.records[name][k], rec[k])
    assert miou == pytest.approx(ref["miou"], abs=0)


def test_baseline_checkpoint_converts_and_names_its_timestep_mlp(tmp_path, capsys):
    """JAX initialises the Baseline through its training forward, which
    embeds no timestep when dm=False: its checkpoint has no fc_t1/fc_t2 and
    no c-block t_mlp. The converter fills them from the port's seeded
    initializer and names them; the training forward, which does not read them, gives JAX's loss
    with the MSE mask and curve permutations injected."""
    name = "scannet/baseline.py"
    cfg = variant_cfg(name)
    jm = jbuild(copy.deepcopy(cfg))
    pt = variant_point(name, "fit")
    variables = as_numpy(random_variables(jm, pt, train=True))
    assert "fc_t1" not in variables["params"]["backbone"]
    key = jax.random.PRNGKey(30)
    perms = [np.asarray(jax.random.permutation(k, 4)).tolist()
             for k in jax.random.split(key, len(cfg["backbone"]["n_stride"]) + 1)]
    geometry = jax.jit(lambda p: jm.backbone.precompute_geometry(p, shuffle_key=key))(pt)
    d = dict(mse_valid=np.asarray(pt.mask) & (np.random.RandomState(5).rand(N) < 0.5))
    crit = jl.Criteria(cfg["criteria"], loss_type=cfg.get("loss_type", "EW"),
                       task_num=cfg.get("task_num", 2))
    want = float(jax.jit(lambda v, p, dd, g: crit(jm.apply(
        v, p, dd, g, method=jax_train_out, mutable=["batch_stats"])[0], mode="train"))(
        variables, pt, {k: jnp.asarray(v) for k, v in d.items()}, geometry))

    config = write_config(tmp_path / "baseline.py", cfg)
    jax_dir = save_jax_train_state(variables, str(tmp_path / "jax"), 3)
    port_file = str(tmp_path / "port" / "model" / "model_last")
    got = converter.main(["--config-file", config, "--jax-checkpoint", jax_dir,
                          "--output", port_file])
    kept = [n for n, _ in tbuild(copy.deepcopy(cfg), device="cpu").named_parameters()
            if n.startswith(("backbone.fc_t1.", "backbone.fc_t2.")) or ".t_mlp." in n]
    assert len(kept) == 4 + 2 * (sum(cfg["backbone"]["c_enc_depths"])
                                 + sum(cfg["backbone"]["c_dec_depths"]))
    assert got["step"] == 3 and got["kept"] == sorted(kept)
    printed = capsys.readouterr().out
    assert all(f"kept from the port's initializer: {k}" in printed for k in kept)
    model = tbuild(copy.deepcopy(cfg), device="cpu")
    CheckpointManager(os.path.dirname(port_file)).restore(model, "model_last")
    seeded = tbuild(copy.deepcopy(cfg), device="cpu", generator=torch.Generator().manual_seed(0))
    for k in kept:
        assert torch.equal(model.state_dict()[k], seeded.state_dict()[k]), k
    model.train()
    out = model(to_port(pt), perms=perms, mse_valid=T(d["mse_valid"]))
    loss = build_model_criteria(cfg)(out, mode="train").item()
    np.testing.assert_allclose(loss, want, rtol=1e-5)
    # strict otherwise: any other tensor missing from the tree raises
    del variables["params"]["backbone"]["n_head"]
    bad = save_jax_train_state(variables, str(tmp_path / "bad"), 0)
    with pytest.raises(ValueError, match="not filled"):
        converter.main(["--config-file", config, "--jax-checkpoint", bad,
                        "--output", str(tmp_path / "bad_port" / "model_last")])
