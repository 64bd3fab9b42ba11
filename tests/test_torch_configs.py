"""Every shipped config in the port against the JAX package: each file
under `configs/{scannet,scannet200,nuscenes,modelnet40,shapenetpart,
semantic_kitti}/` loads through the port's `Config` as through JAX's, and
the models of the CDSegNet family, PTv2, the sparse-conv family, PTv1, the
window-attention family and MSC pretraining build at a test width with
JAX's parameter tree, name for name and shape for shape."""

import copy
import glob
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cdsegnet_tpu.engine.config import Config as JConfig  # noqa: E402
from cdsegnet_tpu.models.builder import build_model as jbuild  # noqa: E402
from cdsegnet_tpu.models.structure import make_point_batch as jmake  # noqa: E402
from cdsegnet_torch.engine.config import Config  # noqa: E402
from cdsegnet_torch.models.builder import build_model as tbuild  # noqa: E402
from cdsegnet_torch.models.segmentor import CNFSegmentor  # noqa: E402
from cdsegnet_torch.utils.weights import load_jax_variables  # noqa: E402
from test_torch_variants import CONFIGS, shrink  # noqa: E402

torch.set_num_threads(2)


def _config_files():
    return sorted(os.path.relpath(p, CONFIGS)
                  for d in ("scannet", "scannet200", "nuscenes", "modelnet40", "shapenetpart",
                            "semantic_kitti")
                  for p in glob.glob(os.path.join(CONFIGS, d, "*.py")))


PTV2_CONFIGS = ("scannet/ptv2.py", "modelnet40/cls_ptv2.py", "shapenetpart/partseg_ptv2.py")
PTV2_WIDTH = dict(patch_embed_channels=8, patch_embed_groups=2, enc_channels=(8, 16, 16, 16),
                  enc_groups=(2, 4, 4, 4), dec_channels=(8, 8, 16, 16),
                  dec_groups=(2, 2, 4, 4))


def _ptv2_builds_as_jax(model_cfg):
    """A PTv2 config's model at a test width (channels and groups cut,
    every other field as shipped): the port's has the JAX model's every
    parameter and running statistic, name for name and shape for shape
    (the strict weight bridge fills it from JAX's variable shapes), and its
    dtype. The classifier's backbone is in feature mode, which JAX's module
    cannot build (ROADMAP Queue 3): its JAX shapes come from the same model
    over a backbone with logits as wide as the features."""
    small = copy.deepcopy(dict(model_cfg))
    small["backbone"] = dict(small["backbone"], **PTV2_WIDTH)
    if small["type"] == "DefaultClassifier":
        small["backbone_embed_dim"] = PTV2_WIDTH["dec_channels"][0]
    m = tbuild(copy.deepcopy(small), device="cpu")
    jcfg = copy.deepcopy(small)
    if small["type"] == "DefaultClassifier":
        assert m.backbone.head is None and m.cls_fc1.weight.shape == (256, 8)
        with pytest.raises(ZeroDivisionError):
            jax.eval_shape(lambda p: jbuild(copy.deepcopy(jcfg)).init(
                jax.random.PRNGKey(0), p, train=False), _ptv2_point(small))
        jcfg["backbone"]["num_classes"] = 8
    jm = jbuild(jcfg)
    shapes = jax.eval_shape(lambda p: jm.init(jax.random.PRNGKey(0), p, train=False),
                            _ptv2_point(small))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    if small["type"] == "DefaultClassifier":  # the head a feature-mode backbone lacks
        tree["params"]["backbone"].pop("head")
    load_jax_variables(m, tree)
    assert m.backbone.dtype == {"bfloat16": torch.bfloat16}.get(
        small["backbone"].get("dtype"), torch.float32)
    assert m.backbone.grid_sizes == tuple(jm.backbone.grid_sizes)
    assert m.backbone.capacity_div == tuple(jm.backbone.capacity_div)


SPARSE_CONFIGS = ("scannet/spunet.py", "scannet/oacnns.py", "scannet/cac_spunet.py",
                  "scannet/insseg_pointgroup.py", "semantic_kitti/spvcnn.py")
SPARSE_WIDTH = {  # channels cut, depths and every other field as shipped
    "SpUNet-v1m1": dict(base_channels=8, channels=(8, 16, 16, 16, 16, 16, 8, 8)),
    "SPVCNN": dict(base_channels=8, channels=(8, 16, 16, 16, 16, 16, 8, 8)),
    "OACNNs": dict(embed_channels=8, enc_channels=(8, 8, 16, 16),
                   dec_channels=(8, 8, 16, 16)),
}


def _sparse_builds_as_jax(model_cfg):
    """A sparse-conv config's model at a test width: the port's has the JAX
    model's every parameter and running statistic, name for name and shape
    for shape (the strict weight bridge fills it from JAX's variable
    shapes), the backbone's dtype, depths and capacities, and the
    wrapper's fields."""
    small = copy.deepcopy(dict(model_cfg))
    bb = small["backbone"]
    bb.update(SPARSE_WIDTH[bb["type"]])
    if "backbone_out_channels" in small:
        small["backbone_out_channels"] = 8
    m = tbuild(copy.deepcopy(small), device="cpu")
    jm = jbuild(copy.deepcopy(small))
    shapes = jax.eval_shape(lambda p: jm.init(jax.random.PRNGKey(0), p, train=False),
                            _ptv2_point(small))
    load_jax_variables(m, jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32),
                                                 shapes))
    assert m.backbone.dtype == {"bfloat16": torch.bfloat16}.get(bb.get("dtype"),
                                                                torch.float32)
    assert m.backbone.capacity_div == tuple(jm.backbone.capacity_div)
    for f in ("layers", "enc_depth", "point_grid_size"):
        if hasattr(jm.backbone, f):
            assert getattr(m.backbone, f) == tuple(map(
                lambda x: tuple(x) if isinstance(x, (list, tuple)) else x,
                getattr(jm.backbone, f))), f
    for f in ("num_classes", "cos_temp", "cluster_radius", "cluster_nsample"):
        if hasattr(jm, f):
            assert getattr(m, f) == getattr(jm, f), f


WINDOW_CONFIGS = ("scannet/ptv1.py", "scannet/octformer.py", "scannet/stratified.py",
                  "scannet/swin3d.py")
WINDOW_WIDTH = {  # channels and heads cut, depths and every other field as shipped
    "PT-v1": dict(channels=(8, 8, 16, 16, 16)),
    "OctFormer-v1m1": dict(channels=(8, 8, 16, 16), num_heads=(2, 2, 2, 2), fpn_channels=8),
    "StratifiedTransformer": dict(channels=(8, 8, 16, 16), num_heads=(2, 2, 2, 2)),
    "Swin3D-v1m1": dict(channels=(8, 16, 16, 16, 16), num_heads=(2, 2, 2, 2, 2)),
}


def _window_builds_as_jax(model_cfg):
    """A PTv1 or window-attention config's model at a test width: the
    port's has the JAX model's every parameter and running statistic, name
    for name and shape for shape (the strict weight bridge fills it from
    JAX's variable shapes: RPE and cRSE tables, ``dw_weight``,
    ``kv_coarse``), and the backbone's dtype, depths and capacities."""
    small = copy.deepcopy(dict(model_cfg))
    bb = small["backbone"]
    bb.update(WINDOW_WIDTH[bb["type"]])
    m = tbuild(copy.deepcopy(small), device="cpu")
    jm = jbuild(copy.deepcopy(small))
    shapes = jax.eval_shape(lambda p: jm.init(jax.random.PRNGKey(0), p, train=False),
                            _ptv2_point(small))
    load_jax_variables(m, jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32),
                                                 shapes))
    assert m.backbone.dtype == {"bfloat16": torch.bfloat16}.get(bb.get("dtype"),
                                                                torch.float32)
    assert m.backbone.capacity_div == tuple(jm.backbone.capacity_div)
    for f in ("depths", "num_blocks"):
        if hasattr(jm.backbone, f):
            assert getattr(m.backbone, f) == tuple(getattr(jm.backbone, f)), f


MSC_CONFIG = "scannet/pretrain_msc.py"


def _msc_builds_as_jax(model_cfg):
    """MSC's model at a test width (its SpUNet's channels cut, every other
    field as shipped): the port's has the JAX model's every parameter and
    running statistic (the mask token and both reconstruction heads among
    them; JAX's shapes from an init with both views and their targets), and
    the wrapper's fields."""
    small = copy.deepcopy(dict(model_cfg))
    small["backbone"].update(SPARSE_WIDTH[small["backbone"]["type"]])
    small["backbone_out_channels"] = 8
    m = tbuild(copy.deepcopy(small), device="cpu")
    jm = jbuild(copy.deepcopy(small))
    pt = _ptv2_point(small)
    tgt = {k: jnp.zeros((pt.num_points, 3)) for k in ("color", "normal")}
    shapes = jax.eval_shape(lambda p: jm.init(jax.random.PRNGKey(0), p, p, p.coord, p.coord,
                                              tgt, tgt, train=False), pt)
    load_jax_variables(m, jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32),
                                                 shapes))
    for f in ("mask_grid_size", "mask_rate", "matching_max_radius", "matching_max_pair",
              "nce_t", "contrast_weight", "reconstruct_weight"):
        assert getattr(m, f) == getattr(jm, f), f
    assert m.mask_token.shape == (1, small["backbone_in_channels"])


def _ptv2_point(cfg, n=4096):
    """Shapes only: JAX's kNN needs every level at least k = 16 slots wide,
    and the coarsest holds n / 128."""
    c = cfg["backbone"]["in_channels"]
    return jmake(coord=jnp.zeros((n, 3)), feat=jnp.zeros((n, c)),
                 grid_coord=jnp.zeros((n, 3), jnp.int32), batch=jnp.zeros((n,), jnp.int32),
                 mask=jnp.ones((n,), bool), segment=jnp.zeros((n,), jnp.int32),
                 depth=12, num_scenes=1)


@pytest.mark.parametrize("name", _config_files())
def test_config_loads_and_builds(name):
    """The port's `Config` reads every file as JAX's does; a CDSegNet-family
    model builds (at a test width) with JAX's segmentor fields and betas,
    a PTv2 one (ScanNet, ModelNet40, ShapeNetPart), a sparse-conv one
    (SpUNet, OA-CNNs, CAC, PointGroup, SPVCNN), PTv1 or a window-attention
    one (OctFormer, Stratified, Swin3D) with JAX's parameters
    (`_ptv2_builds_as_jax`, `_sparse_builds_as_jax`, `_window_builds_as_jax`),
    and MSC pretraining's (`_msc_builds_as_jax`)."""
    path = os.path.join(CONFIGS, name)
    cfg, jcfg = Config.fromfile(path), JConfig.fromfile(path)
    assert cfg.model == dict(jcfg.model)
    assert {k: cfg[k] for k in cfg if k != "data"} == {
        k: jcfg[k] for k in jcfg if k != "data"}
    if name in PTV2_CONFIGS:
        _ptv2_builds_as_jax(cfg.model)
        return
    if name in SPARSE_CONFIGS:
        _sparse_builds_as_jax(cfg.model)
        return
    if name in WINDOW_CONFIGS:
        _window_builds_as_jax(cfg.model)
        return
    if name == MSC_CONFIG:
        _msc_builds_as_jax(cfg.model)
        return
    small = shrink(cfg.model)
    m, jm = tbuild(copy.deepcopy(small), device="cpu"), jbuild(copy.deepcopy(small))
    assert type(m).__name__ == type(jm).__name__
    bb = m.backbone
    assert bb.condition == jm.backbone.condition
    assert bb.n_enc_depths == jm.backbone.n_enc_depths
    assert bb.n_head.weight.shape[0] == jm.backbone.num_classes == cfg.data.num_classes
    assert bb.capacity_div == tuple(jm.backbone.capacity_div)
    if isinstance(m, CNFSegmentor):
        for f in ("num_classes", "T", "dm", "dm_target", "condition", "c_in_channels"):
            assert getattr(m, f) == getattr(jm, f), f
        if m.dm:
            from cdsegnet_tpu.models.diffusion import DiffusionSchedule as JSched

            want = JSched.create(jm.noise_schedule, jm.beta_start, jm.beta_end, jm.T)
            np.testing.assert_array_equal(m.schedule.betas, want.betas)
            np.testing.assert_array_equal(m.schedule.alpha_bar, want.alpha_bar)
        else:
            assert m.schedule is None
