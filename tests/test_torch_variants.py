"""The CDSegNet family's other configurations in the port against the JAX
package: the Baseline (dm=False), PTv3+CNF (linear betas, a shallower last
encoder stage), plain PTv3 through `DefaultSegmentor`, ScanNet200 (200
classes, linear betas) and nuScenes (4 input channels). Each is its config
file's model at a shrunk width (channels, heads, patches and depths cut,
every other field as shipped), with weights made with numpy from a seed.
One parametrised test per check: SSI logits (the plain model's eval
logits), and one training step through `make_train_step` with the timesteps,
noise, MSE mask and curve permutations injected, against `jax.grad`. The
four nuScenes configurations run the same checks, over this file's
helpers, in `tests/test_torch_variants_nuscenes.py`;
`tests/test_torch_configs.py` loads and builds every shipped config."""

import copy
import os
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cdsegnet_tpu.models import losses as jl  # noqa: E402
from cdsegnet_tpu.models.builder import build_model as jbuild  # noqa: E402
from cdsegnet_tpu.models.segmentor import CNFSegmentor as JCNF  # noqa: E402
from cdsegnet_tpu.models.segmentor import PlainSegmentor as JPlain  # noqa: E402
from cdsegnet_tpu.models.structure import make_point_batch as jmake  # noqa: E402
from cdsegnet_torch.engine.config import Config  # noqa: E402
from cdsegnet_torch.engine.optimizer import build_optimizer  # noqa: E402
from cdsegnet_torch.engine.state import make_train_step  # noqa: E402
from cdsegnet_torch.models.builder import build_model as tbuild  # noqa: E402
from cdsegnet_torch.models.builder import build_model_criteria  # noqa: E402
from cdsegnet_torch.models.segmentor import CNFSegmentor, PlainSegmentor  # noqa: E402
from cdsegnet_torch.utils.synthetic import synthetic_arrays  # noqa: E402
from cdsegnet_torch.utils.weights import load_jax_variables  # noqa: E402
from helpers import synthetic_batch  # noqa: E402
from test_torch_model import N, as_numpy, random_variables, to_port  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
# the variants and the batch each runs on: nuScenes on scattered voxels,
# which overflow the pooled levels as outdoor sweeps do
VARIANTS = {"scannet/baseline.py": "fit", "scannet/ptv3_cnf.py": "fit",
            "scannet/ptv3_plain.py": "fit", "scannet200/cdsegnet.py": "fit",
            "nuscenes/cdsegnet.py": "overflow", "nuscenes/ptv3_cnf.py": "overflow",
            "nuscenes/baseline.py": "overflow", "nuscenes/ptv3_plain.py": "overflow"}
# the indoor variants here; the nuScenes ones in tests/test_torch_variants_nuscenes.py
INDOOR = [n for n in VARIANTS if not n.startswith("nuscenes/")]
T = lambda x: torch.from_numpy(np.array(x))


def shrink(model_cfg):
    """The config's model at a test width: narrow channels, one or two heads,
    64-point patches, each stage's depth divided by 3 (at least 1: the
    shipped 6 becomes 2, the shipped 2 becomes 1), a 16-wide timestep
    embedding, f32, no stochastic depth. Every other field as shipped."""
    cfg = copy.deepcopy(dict(model_cfg))
    bb = dict(cfg["backbone"])
    depth = lambda key: tuple(max(1, d // 3) for d in bb[key])
    bb.update(
        c_enc_depths=depth("c_enc_depths"), c_enc_channels=(8, 16, 16),
        c_enc_num_head=(1, 2, 2), c_enc_patch_size=(64,) * 3,
        c_dec_depths=depth("c_dec_depths"), c_dec_channels=(8, 8),
        c_dec_num_head=(1, 1), c_dec_patch_size=(64,) * 2,
        n_enc_depths=depth("n_enc_depths"), n_enc_channels=(8, 16, 16, 16, 16),
        n_enc_num_head=(1, 2, 2, 2, 2), n_enc_patch_size=(64,) * 5,
        n_dec_depths=depth("n_dec_depths"), n_dec_channels=(8, 8, 16, 16),
        n_dec_num_head=(1, 1, 2, 2), n_dec_patch_size=(64,) * 4,
        mlp_ratio=2, drop_path=0.0, dtype="float32",
        T_dim=16 if bb.get("T_dim", 128) != -1 else -1)
    cfg["backbone"] = bb
    if "T_dim" in cfg:
        cfg["T_dim"] = 16
    return cfg


def variant_cfg(name):
    return shrink(Config.fromfile(os.path.join(CONFIGS, name)).model)


def variant_point(name, kind):
    """N points of two scenes with the variant's input channels."""
    c_in = Config.fromfile(os.path.join(CONFIGS, name)).model.backbone.n_in_channels
    if kind == "overflow":
        return synthetic_batch(np.random.RandomState(0), counts=(150, 90), num_points=N,
                               depth=6, feat_dim=c_in)
    a = synthetic_arrays(N, 2, depth=6, seed=3)
    a["feat"] = a["feat"][:, :c_in]
    return jmake(**{k: jnp.asarray(v) for k, v in a.items()}, depth=6, num_scenes=2)


def variant_variables(jm, point, noise):
    """`random_variables`, a CNF model's initialised through SSI: its
    training forward creates no timestep MLP when dm=False (the Baseline),
    but SSI embeds t = 0 and needs one."""
    if isinstance(jm, JCNF):
        return random_variables(jm, point, noise, method=JCNF.inference)
    return random_variables(jm, point)


def jax_train_out(mdl, point, d, geometry):
    """The JAX training forward composed from the package's public pieces,
    as `CNFSegmentor.__call__` and `PlainSegmentor.__call__` compose them,
    with the draws (timesteps, noise, MSE mask, the shuffled pyramid)
    injected."""
    seg_valid = point.mask & (point.segment >= 0)
    if isinstance(mdl, JPlain):
        n_out = mdl.backbone(point, train=True, geometry=geometry)
        return dict(n_pred=n_out.feat, n_target=point.segment, seg_valid=seg_valid)
    c_x0 = mdl._c_x0(point)
    c_feat, c_target, t_emb = c_x0, c_x0, None
    if mdl.dm:
        ts_pt = jnp.take(d["ts_scene"], jnp.clip(point.batch, 0, point.num_scenes - 1))
        t_emb = mdl._scene_t_emb(d["ts_scene"], point.batch)
        c_feat = mdl.schedule.q_sample(c_x0, ts_pt, d["noise"])
        c_target = d["noise"]
    c_out, n_out = mdl.backbone(point, point.replace(feat=c_feat), t_emb=t_emb,
                                train=True, geometry=geometry)
    return dict(c_pred=c_out.feat, c_target=c_target, n_pred=n_out.feat,
                n_target=point.segment, seg_valid=seg_valid, mse_valid=d["mse_valid"])


def jax_reference(name):
    """JAX's weights, SSI (eval) logits, and one training step's loss,
    gradients and running statistics with every draw injected; the seeds
    from the variant's rank in `VARIANTS`."""
    i, kind = list(VARIANTS).index(name), VARIANTS[name]
    cfg = variant_cfg(name)
    jm = jbuild(copy.deepcopy(cfg))
    pt = variant_point(name, kind)
    rng = np.random.RandomState(20 + i)
    noise = rng.randn(N, cfg.get("c_in_channels", 6)).astype(np.float32)
    variables = as_numpy(variant_variables(jm, pt, noise))
    # the step's draws: timesteps at SSI's step and mid-schedule; the curve
    # permutations are those JAX draws from its shuffle key (one split per
    # level)
    key = jax.random.PRNGKey(30 + i)
    n_levels = len(cfg["backbone"]["n_stride"]) + 1
    perms = [np.asarray(jax.random.permutation(k, 4)).tolist()
             for k in jax.random.split(key, n_levels)]
    geometry = jax.jit(lambda p: jm.backbone.precompute_geometry(p, shuffle_key=key))(pt)
    t_max = cfg.get("T", 1000)
    d = dict(ts_scene=np.array([t_max - 1, t_max // 2], np.int32), noise=noise,
             mse_valid=np.asarray(pt.mask) & (rng.rand(N) < 0.5))
    crit = jl.Criteria(cfg["criteria"], loss_type=cfg.get("loss_type", "EW"),
                       task_num=cfg.get("task_num", 2))

    def loss_fn(params, stats):
        o, mutated = jm.apply({"params": params, "batch_stats": stats}, pt,
                              {k: jnp.asarray(v) for k, v in d.items()}, geometry,
                              method=jax_train_out, mutable=["batch_stats"])
        return crit(o, mode="train"), mutated["batch_stats"]

    if isinstance(jm, JCNF):
        logits = jax.jit(lambda v: jm.apply(v, pt, noise, method=JCNF.inference)[
            "seg_logits"])(variables)
    else:
        logits = jax.jit(lambda v: jm.apply(v, pt)["n_pred"])(variables)
    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"])
    return dict(cfg=cfg, point=pt, variables=variables, noise=noise,
                logits=np.asarray(logits), draws=d, perms=perms, loss=float(loss),
                grads=as_numpy(grads), stats=as_numpy(stats),
                dropped=[int(lv.dropped) for lv in geometry[0][1:]])


def jax_references(names):
    """The JAX references of ``names``, compiled on parallel threads (this
    file and its nuScenes half run late in the suite, where cores are
    free)."""
    with ThreadPoolExecutor(len(names)) as ex:
        return dict(zip(names, ex.map(jax_reference, names)))


@pytest.fixture(scope="module")
def jref():
    return jax_references(INDOOR)


def port_model(ref, params=None, stats=None):
    m = tbuild(copy.deepcopy(ref["cfg"]), device="cpu")
    v = ref["variables"]
    load_jax_variables(m, dict(params=v["params"] if params is None else params,
                               batch_stats=v["batch_stats"] if stats is None else stats))
    return m


def check_ssi(ref, name):
    m = port_model(ref)
    pt = to_port(ref["point"])
    if isinstance(m, CNFSegmentor):
        got = m.inference(pt, noise=T(ref["noise"]))["seg_logits"]
    else:
        assert isinstance(m, PlainSegmentor)
        with torch.no_grad():
            got = m(pt)["n_pred"]
    want = ref["logits"]
    valid = np.asarray(ref["point"].mask)
    assert got.shape == want.shape == (N, ref["cfg"]["backbone"]["num_classes"])
    err = np.abs(got.numpy() - want)[valid].max()
    assert err <= 1e-4 * np.abs(want[valid]).max() + 1e-5


def check_train_step(ref, name):
    """One step through `make_train_step`: the loss and drops it reports,
    every parameter's gradient (left on the parameters after the update) and
    the new running statistics, against `jax.grad`."""
    m = port_model(ref)
    opt = build_optimizer(dict(type="AdamW", lr=1e-3), m, device="cpu")
    step = make_train_step(m, build_model_criteria(ref["cfg"]), opt, device="cpu")
    d = ref["draws"]
    inject = dict(perms=ref["perms"])
    if isinstance(m, CNFSegmentor):
        inject.update(ts_scene=T(d["ts_scene"]), noise=T(d["noise"]),
                      mse_valid=T(d["mse_valid"]))
    metrics = step(to_port(ref["point"]), **inject)
    np.testing.assert_allclose(metrics["loss"].item(), ref["loss"], rtol=1e-5)
    n_levels = len(ref["dropped"])
    assert [metrics[f"dropped_l{i + 1}"] for i in range(n_levels)] == ref["dropped"]
    assert (sum(ref["dropped"]) > 0) == (VARIANTS[name] == "overflow")
    # as tests/test_torch_train.py: per tensor, max |dg| <= 1e-4 max |g_jax|
    # plus 1e-6 of the largest gradient of all
    want = dict(port_model(ref, params=ref["grads"]).named_parameters())
    floor = 1e-6 * max(w.abs().max().item() for w in want.values())
    for pname, p in m.named_parameters():
        g, w = p.grad, want[pname].detach()
        if g is None:  # unused by the training forward: the Baseline's t MLP
            assert not w.any(), pname
            g = torch.zeros_like(w)
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() + floor, pname
    stats = dict(port_model(ref, stats=ref["stats"]).named_buffers())
    for bname, b in m.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[bname].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=bname)


@pytest.mark.parametrize("name", INDOOR)
def test_variant_ssi_matches_jax(jref, name):
    check_ssi(jref[name], name)


@pytest.mark.parametrize("name", INDOOR)
def test_variant_train_step_matches_jax(jref, name):
    check_train_step(jref[name], name)
