"""Port model against the JAX package: SSI logits, the backbone's c output,
the plain segmentor and the weight bridge, on a tiny flagship-shaped config
with weights made with numpy from a seed and carried across. Also the
port's device and import rules."""

import ast
import copy
import os
import tempfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cdsegnet_tpu.models.builder import build_model as jbuild  # noqa: E402
from cdsegnet_tpu.models.segmentor import CNFSegmentor as JCNF  # noqa: E402
from cdsegnet_tpu.models.structure import make_point_batch as jmake  # noqa: E402
from cdsegnet_tpu.utils.params import adapt_backbone_params  # noqa: E402
from cdsegnet_torch.models.builder import build_model as tbuild  # noqa: E402
from cdsegnet_torch.models.structure import make_point_batch as tmake  # noqa: E402
from cdsegnet_torch.utils.device import resolve_device  # noqa: E402
from cdsegnet_torch.utils.synthetic import (  # noqa: E402
    synthetic_arrays, synthetic_point_batch)
from cdsegnet_torch.utils.weights import load_jax_variables  # noqa: E402
from helpers import synthetic_batch  # noqa: E402
from test_model import TINY_MODEL  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 256


def share_jax_compiles_across_the_run():
    """One persistent JAX compilation cache for the whole test run, shared
    by its xdist workers (`PYTEST_XDIST_TESTRUNUID`, under the run's
    temporary directory): a JAX reference that several files compile (the
    same function, shapes and constants) is compiled once. It keeps
    compiled code only; every reference still runs. Every worker imports
    this module while collecting, before any test compiles; a JAX test file
    collected earlier may already have compiled, hence the reset."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if run:
        from jax.experimental.compilation_cache import compilation_cache

        compilation_cache.set_cache_dir(
            os.path.join(tempfile.gettempdir(), f"cdseg_jax_compiles_{run}"))
        compilation_cache.reset_cache()


share_jax_compiles_across_the_run()


def tiny_cfg(dtype="float32", **backbone):
    """The tiny flagship-shaped model with two-block stages, so the scanned
    and fused parameter layouts have stacks and pairs to convert."""
    cfg = copy.deepcopy(TINY_MODEL)
    cfg["backbone"].update(n_enc_depths=(2, 1, 1, 2, 1), c_enc_depths=(2, 1, 1),
                           n_dec_depths=(2, 1, 1, 1), c_dec_depths=(1, 2),
                           dtype=dtype, **backbone)
    return cfg


def random_variables(model, point, *args, **init_kwargs):
    """The flax variable tree of ``model`` (scanned layout), filled with
    numpy draws from a seed: non-trivial norms and running statistics.
    ``args`` and ``init_kwargs`` go to ``model.init`` after the point
    (``train=False`` when none is given)."""
    rngs = {k: jax.random.PRNGKey(i) for i, k in
            enumerate(("params", "dropout", "shuffle", "diffusion"))}
    kwargs = init_kwargs or dict(train=False)
    shapes = jax.eval_shape(lambda p: model.init(rngs, p, *args, **kwargs), point)
    rng = np.random.RandomState(1)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['var']"):
            return (0.5 + rng.rand(*s.shape)).astype(np.float32)
        if name.endswith("['scale']"):
            return (1 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        fan = int(np.prod(s.shape[-3:-1])) if len(s.shape) >= 2 else 1
        return (rng.randn(*s.shape) / np.sqrt(max(fan, 1))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def as_numpy(tree):
    """A fresh copy of the variable tree as nested dicts of numpy arrays."""
    return jax.tree_util.tree_map(np.array, tree)


def batches():
    """An overflowing batch (sorted tables, gather stem) and a surface batch
    that fits (parity tables, blocked stem), both of N points."""
    over = synthetic_batch(np.random.RandomState(0), counts=(150, 90),
                           num_points=N, depth=6)
    a = synthetic_arrays(N, 2, depth=6, seed=3)
    fit = jmake(**{k: jnp.asarray(v) for k, v in a.items()}, depth=6, num_scenes=2)
    return {"overflow": over, "fit": fit}


def to_port(pt):
    return tmake(np.array(pt.coord), np.array(pt.feat), np.array(pt.grid_coord),
                 np.array(pt.batch), np.array(pt.mask), np.array(pt.segment),
                 depth=pt.depth, num_scenes=pt.num_scenes, device="cpu")


@pytest.fixture(scope="module")
def ref():
    """JAX outputs, one compile per function: SSI logits in f32 and bf16 and
    the backbone's (c, n) outputs in f32, on both batches."""
    pts = batches()
    jm32 = jbuild(tiny_cfg("float32"))
    jm16 = jbuild(tiny_cfg("bfloat16"))
    variables = random_variables(jm32, pts["fit"])
    noise = np.random.RandomState(2).randn(N, 6).astype(np.float32)
    ssi = lambda m: jax.jit(lambda v, p, nz: m.apply(
        v, p, nz, method=JCNF.inference)["seg_logits"])

    def both(mdl, p, nz):
        ts = jnp.full((p.num_scenes,), mdl.T - 1, jnp.int32)
        c_out, n_out = mdl.backbone(p, p.replace(feat=nz),
                                    t_emb=mdl._scene_t_emb(ts, p.batch))
        return c_out.feat, n_out.feat

    bb = jax.jit(lambda v, p, nz: jm32.apply(v, p, nz, method=both))
    geometry = jax.jit(lambda p: jm32.backbone.precompute_geometry(p))
    ssi32, ssi16 = ssi(jm32), ssi(jm16)
    out = {}
    for name, p in pts.items():
        out[name] = dict(
            f32=np.asarray(ssi32(variables, p, jnp.asarray(noise))),
            bf16=np.asarray(ssi16(variables, p, jnp.asarray(noise))),
            c=np.asarray(bb(variables, p, jnp.asarray(noise))[0]),
            dropped=[int(lv.dropped) for lv in geometry(p)[0][1:]],
        )
    return dict(points=pts, variables=variables, noise=noise, out=out,
                backbone=jm32.backbone)


def port_model(ref, dtype="float32", **backbone):
    m = tbuild(tiny_cfg(dtype, **backbone), device="cpu")
    load_jax_variables(m, as_numpy(ref["variables"]))
    return m


@pytest.mark.parametrize("batch", ["overflow", "fit"])
def test_ssi_f32_matches_jax(ref, batch):
    pt = ref["points"][batch]
    assert (sum(ref["out"][batch]["dropped"]) > 0) == (batch == "overflow")
    got = port_model(ref).inference(to_port(pt), noise=torch.from_numpy(
        ref["noise"]))["seg_logits"].numpy()
    want = ref["out"][batch]["f32"]
    valid = np.asarray(pt.mask)
    err = np.abs(got - want)[valid].max()
    assert err <= 1e-4 * np.abs(want[valid]).max() + 1e-5


@pytest.mark.parametrize("batch", ["overflow", "fit"])
def test_ssi_with_kernel_padding_rows_matches_jax(ref, batch, monkeypatch):
    """The CUDA kernel writes zeros on rows with no allowed key, where the
    plain and JAX versions give the uniform mean over the patch: valid
    logits must not depend on which."""
    from cdsegnet_torch.models import ptv3
    from cdsegnet_torch.ops.attention import patch_attention

    zeroed = []

    def zero_rows_without_keys(q, k, v, batch_sorted, valid_sorted, patch_size,
                               scale, upcast_softmax=True):
        out = patch_attention(q, k, v, batch_sorted, valid_sorted, patch_size,
                              scale, upcast_softmax=upcast_softmax)
        bp = batch_sorted.view(-1, patch_size)
        has = ((bp[:, :, None] == bp[:, None, :])
               & valid_sorted.view(-1, 1, patch_size)).any(-1).view(-1, 1, 1)
        zeroed.append(int((~has & (out != 0)).sum()))
        return torch.where(has, out, torch.zeros((), dtype=out.dtype))

    monkeypatch.setattr(ptv3, "attention_impl", lambda use_pallas: zero_rows_without_keys)
    pt = ref["points"][batch]
    got = port_model(ref).inference(to_port(pt), noise=torch.from_numpy(
        ref["noise"]))["seg_logits"].numpy()
    assert sum(zeroed) > 0
    want = ref["out"][batch]["f32"]
    valid = np.asarray(pt.mask)
    err = np.abs(got - want)[valid].max()
    assert err <= 1e-4 * np.abs(want[valid]).max() + 1e-5


def test_ssi_bf16_matches_jax(ref):
    # bf16 keeps 8 mantissa bits, and the two frameworks round at different
    # places (e.g. Dense bias before or after the cast) through some twenty
    # layers: on this input JAX's own bf16 result differs from its f32 one
    # by 2.4% of max|logits|, so the port is held to 10% and to the argmax
    pt = ref["points"]["fit"]
    got = port_model(ref, "bfloat16").inference(to_port(pt), noise=torch.from_numpy(
        ref["noise"]))["seg_logits"].numpy()
    want = ref["out"]["fit"]["bf16"]
    valid = np.asarray(pt.mask)
    assert np.abs(got - want)[valid].max() <= 0.1 * np.abs(want[valid]).max()
    assert (got.argmax(1) == want.argmax(1))[valid].mean() >= 0.95


@pytest.mark.parametrize("stem_mode", ["cond", "gather", "blocked"])
def test_backbone_c_output_matches_jax(ref, stem_mode):
    pt = ref["points"]["fit"]
    m = port_model(ref, stem_mode=stem_mode)
    tp = to_port(pt)
    noise = torch.from_numpy(ref["noise"])
    ts = torch.full((2,), m.T - 1, dtype=torch.int32)
    with torch.no_grad():
        c_out, _ = m.backbone(tp, noise, t_emb=m._scene_t_emb(ts, tp.batch))
    want = ref["out"]["fit"]["c"]
    valid = np.asarray(pt.mask)
    err = np.abs(c_out.numpy() - want)[valid].max()
    assert err <= 1e-4 * np.abs(want[valid]).max() + 1e-5


def test_plain_segmentor_matches_jax(ref):
    cfg = dict(type="DefaultSegmentor",
               backbone=dict(tiny_cfg()["backbone"], condition=False))
    jm = jbuild(copy.deepcopy(cfg))
    pt = ref["points"]["fit"]
    variables = random_variables(jm, pt)
    want = np.asarray(jax.jit(lambda v, p: jm.apply(v, p)["n_pred"])(variables, pt))
    m = tbuild(copy.deepcopy(cfg), device="cpu")
    load_jax_variables(m, as_numpy(variables))
    got = m(to_port(pt))["n_pred"].detach().numpy()  # the forward trains too
    valid = np.asarray(pt.mask)
    assert np.abs(got - want)[valid].max() <= 1e-4 * np.abs(want[valid]).max() + 1e-5


@pytest.mark.parametrize("scan,fused", [(False, False), (False, True), (True, True)])
def test_weight_layouts_load_the_same_state(ref, scan, fused):
    base = port_model(ref).state_dict()
    v = as_numpy(ref["variables"])
    v["params"]["backbone"] = adapt_backbone_params(
        v["params"]["backbone"], ref["backbone"], scan=scan, fused=fused)
    m = tbuild(tiny_cfg(), device="cpu")
    load_jax_variables(m, v)
    state = m.state_dict()
    assert state.keys() == base.keys()
    for k in base:
        assert torch.equal(state[k], base[k]), k


def test_weight_loading_is_strict(ref):
    m = tbuild(tiny_cfg(), device="cpu")
    v = as_numpy(ref["variables"])
    bb = v["params"]["backbone"]
    bb["n_head"].pop("bias")
    with pytest.raises(ValueError, match="not filled"):
        load_jax_variables(m, v)
    bb["n_head"]["bias"] = np.zeros(5, np.float32)
    bb["n_head"]["extra"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="no counterpart"):
        load_jax_variables(m, v)
    del bb["n_head"]["extra"]
    bb["n_head"]["bias"] = np.zeros(6, np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(m, v)


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbuild(tiny_cfg())
    a = synthetic_arrays(256, 1, depth=6, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmake(**a, depth=6)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synthetic_point_batch(256, 1, depth=6)
    assert resolve_device("cpu") == torch.device("cpu")
    assert synthetic_point_batch(256, 1, depth=6, device="cpu").mask.device.type == "cpu"
    # the training entry points, on a model the caller put on the CPU
    from cdsegnet_torch.engine.optimizer import build_optimizer
    from cdsegnet_torch.engine.state import make_train_step
    from cdsegnet_torch.models.builder import build_model_criteria

    m = tbuild(tiny_cfg(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_optimizer(dict(type="AdamW", lr=1e-3), m)
    opt = build_optimizer(dict(type="AdamW", lr=1e-3), m, device="cpu")
    crit = build_model_criteria(tiny_cfg())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(m, crit, opt)
    make_train_step(m, crit, opt, device="cpu")


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "cdsegnet_tpu")


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(REPO, "cdsegnet_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for module in ("engine/state.py", "engine/optimizer.py", "models/losses.py",
                   "tools/profile_train.py", "engine/test.py", "engine/checkpoint.py",
                   "engine/config.py", "data/transforms.py", "data/datasets.py",
                   "data/collate.py", "tools/test.py", "utils/registry.py",
                   "utils/logger.py", "utils/misc.py", "engine/train.py",
                   "engine/hooks.py", "engine/events.py", "data/loader.py",
                   "utils/tbwriter.py", "tools/train.py", "tools/test_time.py",
                   "parallel/dist.py", "models/ablation_segmentors.py", "models/ptv1.py",
                   "models/octformer.py", "models/stratified.py", "models/swin3d.py",
                   "ops/sparse_attention.py", "ops/pointops.py", "models/msc.py",
                   "models/ppt.py", "data/cache.py", "engine/profiling.py",
                   "models/structure.py", "utils/visualization.py", "tools/visualize.py",
                   "tools/preprocess_s3dis.py", "tools/preprocess_arkitscenes.py",
                   "tools/preprocess_structured3d.py", "tools/preprocess_scannet.py",
                   "tools/preprocess_nuscenes.py", "tools/preprocess_waymo.py",
                   "tools/fidelity_ablations.py"):
        assert os.path.join(REPO, "cdsegnet_torch", module) in files, module
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN + ("convert_jax_checkpoint",)]
    assert not bad, bad
    # the converter bridges the two: it imports orbax, and nothing of the
    # JAX package
    converter = list(_imports(os.path.join(REPO, "convert_jax_checkpoint.py")))
    assert "orbax.checkpoint" in converter
    assert not [m for m in converter if m.split(".")[0] == "cdsegnet_tpu"], converter
