"""Pointcept's published PT-v2m2 (``PT-v2m2-pointcept``) against its plain
reference, ``bench_h100/reference/ptv2.py``, on the CPU in float32: the
eval logits, the training loss, the first gradients with the stochastic
depth masks injected, the parameters after one AdamW step, the kNN tables,
and the weights' names; on the card, the pooled coordinates' bits. The
widths are narrowed; the neighbour counts (8 in the patch embed, 16
elsewhere), grid sizes, depths of the patch embed and decoders, and
stochastic depth are the published ones. No JAX: the model has no JAX
counterpart."""

from __future__ import annotations

import copy
import statistics

import numpy as np
import pytest
import torch

from bench_h100 import manifest, program, traffic, weights
from bench_h100.loops.train_buckets_coord import make as make_buckets
from bench_h100.reference.nn import Precision
from bench_h100.reference.optim import Optimizer
from bench_h100.reference.ptv2 import knn_table
from cdsegnet_torch.models import builder
from cdsegnet_torch.ops.pointops import knn

NARROW = dict(patch_embed_channels=8, patch_embed_groups=2, enc_depths=[1, 1, 2, 1],
              enc_channels=[8, 16, 16, 24], enc_groups=[2, 4, 4, 6], dec_channels=[8, 8, 16, 16],
              dec_groups=[2, 2, 4, 4], capacity_div=[1, 1, 2, 4, 8], dtype="float32")
# two rooms sampled at 4 cm, cropped to 400 points each; features coord, color, normal
MIX = dict(kind="train_buckets_coord", buckets=2, scenes_per_bucket=2, points_per_scene=400,
           cell=0.04, grid_size=0.04)
SEED = 2 ** 33 + 7
SCENES = MIX["scenes_per_bucket"]


@pytest.fixture(scope="module")
def case():
    torch.manual_seed(0)
    cfg = copy.deepcopy(manifest.cell("ptv2_scannet.train")["cfg"])
    cfg["model"]["backbone"].update(NARROW)
    cfg["dtype"] = "float32"
    R = manifest.reference(cfg)
    arch = R.Arch(cfg["model"])
    buckets = make_buckets(MIX, SEED)
    tb = [{k: torch.as_tensor(v) for k, v in b.items()} for b in buckets]
    W = weights.make(R.param_shapes(arch), traffic.derive(SEED, 10), "cpu")
    return dict(cfg=cfg, R=R, arch=arch, buckets=buckets, tb=tb, W=W)


def _model(case):
    return program.build_model(case["cfg"], {k: v.clone() for k, v in case["W"].items()}, "cpu")


def _params(case):
    return {k: v.clone().requires_grad_(not k.endswith((".mean", ".var")))
            for k, v in case["W"].items()}


def _point(case, i=0):
    return program.to_point(case["buckets"][i], case["cfg"]["serialization_depth"], SCENES, "cpu")


def test_the_pyramid_and_its_knn_tables_match_the_reference(case):
    """Slot for slot: the reference keeps only the cells of a pooled level,
    in the port's order, so its guard index is its own slot count."""
    model = _model(case)
    point = _point(case)
    levels, tables = model.backbone.precompute_geometry(point)
    ref = case["R"].pyramid(case["arch"], case["tb"][0], SCENES)
    assert [lv.dropped for lv in levels[1:]] == [lv["dropped"] for lv in ref[1:]] == [0] * 4
    guards = 0
    for lv, t, r in zip(levels, tables, ref):
        n = r["nbr"].shape[0]
        assert int(lv.point.mask.sum()) == int(r["mask"].sum()) == int(lv.point.mask[:n].sum())
        assert torch.equal(lv.point.coord[:n], r["coord"])  # sums in one order
        got = t[:n].long()
        got = torch.where(got >= n, n, got)
        assert torch.equal(got, r["nbr"])
        guards += int((r["nbr"][r["mask"]] == n).sum())
    assert guards > 0  # the coarsest levels hold scenes of fewer than 16 cells


def test_eval_logits_match_the_reference(case):
    """Running statistics as drawn (mean 0, var 1): float32 on both sides,
    the same operations in another order (the port's masked norms, gathers
    and pooling): 1e-5 of the logits' scale."""
    model = _model(case).eval()
    with torch.no_grad():
        got = model(_point(case))["n_pred"]
        R, arch = case["R"], case["arch"]
        levels = R.pyramid(arch, case["tb"][0], SCENES)
        want = R.logits(arch, case["W"], levels, case["tb"][0]["feat"], Precision("f32"),
                        train=False)
    mask = case["tb"][0]["mask"]
    scale = float(want[mask].abs().max())
    assert float((got[mask] - want[mask]).abs().max()) <= 1e-5 * scale


def _first_step(case):
    """The port's loss and gradients of one training forward and the
    reference's, with the reference's stochastic-depth masks injected."""
    R, arch = case["R"], case["arch"]
    draws = R.train_draws(arch, case["tb"][0], SCENES, traffic.derive(SEED, 20, 0))
    model = _model(case).train()
    criteria = builder.build_model_criteria(case["cfg"]["model"])
    out = model(_point(case), generators=dict(dropout=program.path_draws(draws["path_masks"])))
    loss = criteria(out, mode="train")
    loss.backward()
    P = _params(case)
    ref = R.train_loss(arch, P, case["tb"][0], draws, SCENES, 12, Precision("f32"))
    ref.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return float(loss.detach()), float(ref.detach()), grads, {n: P[n].grad for n in grads}


def test_training_loss_and_first_gradients_match_the_reference(case):
    """The loss to 1e-6 of itself (float32, sums in another order). Each
    leaf's gradient to 1e-4 of its norm or of the median leaf's, whichever
    is larger: the biases that a BatchNorm or the softmax cancels have an
    exact gradient of 0 and read round-off on both sides."""
    loss, ref, grads, want = _first_step(case)
    assert abs(loss - ref) <= 1e-6 * abs(ref)
    norms = {n: float(g.norm()) for n, g in want.items()}
    med = statistics.median(norms.values())
    assert med > 0
    for n, g in grads.items():
        assert float((g - want[n]).norm()) <= 1e-4 * max(norms[n], med), n


def test_the_masks_reach_every_block_with_stochastic_depth(case):
    """All 14 published sites with a rate above 0 (11 encoder blocks, 3
    decoder blocks) take their injected mask: the forward raises on a
    missing one and leaves none unread."""
    R, arch = case["R"], case["arch"]
    sites = arch.drop_sites()
    # narrowed encoder depths 1, 1, 2, 1: the first block of each half has rate 0
    assert [lv for lv, _ in sites] == [2, 3, 3, 4, 3, 2, 1]
    full = R.Arch(manifest.cell("ptv2_scannet.train")["cfg"]["model"])
    assert len(full.drop_sites()) == 14
    draws = R.train_draws(arch, case["tb"][0], SCENES, 5)
    gen = program.path_draws(draws["path_masks"])
    _model(case).train()(_point(case), generators=dict(dropout=gen))
    assert gen.path_masks == []


def test_one_adamw_step_matches_the_reference(case):
    """The port's `make_train_step` with its optimizer against the
    reference's AdamW and one-cycle schedule. Adam's first update is about
    ``lr * sign(g)``, so an element whose exact gradient is 0 moves by
    round-off's sign: elements whose reference gradient is at least 1e-3 of
    the median leaf's root mean square agree to 1e-3 of the step; every
    element stays within two steps."""
    cfg, R, arch = case["cfg"], case["R"], case["arch"]
    draws = R.train_draws(arch, case["tb"][0], SCENES, traffic.derive(SEED, 20, 0))
    model = _model(case)
    step, opt = program.train_step(cfg, model, 1, "cpu")
    step.generators["dropout"] = program.path_draws(draws["path_masks"])
    out = step(_point(case))
    assert np.isfinite(float(out["loss"]))
    names = [n for n, _ in model.named_parameters()]
    P = _params(case)
    loss = R.train_loss(arch, P, case["tb"][0], draws, SCENES, 12, Precision("f32"))
    loss.backward()
    grads = {n: P[n].grad for n in names}
    ref_opt = Optimizer(cfg, names)
    lr = ref_opt.lr(names[0])  # the first update's
    ref_opt.step({n: P[n].detach() for n in names}, grads)
    rms = torch.stack([g.square().mean().sqrt() for g in grads.values()])
    tau = 1e-3 * float(rms.median())
    for n, p in model.named_parameters():
        d = (p.detach() - P[n].detach()).abs()
        moving = grads[n].abs() >= tau
        assert float(d.max()) <= 2.0 * lr * 1.001 + 1e-7, n
        if moving.any():
            assert float(d[moving].max()) <= 1e-3 * lr, n


def test_the_patch_embed_table_is_the_first_columns_of_the_level_table():
    """`k_smallest` returns neighbours in ascending (distance, index) order,
    ties included (duplicated points), so 8 neighbours are the first 8 of
    16, in the port and in the reference."""
    rng = np.random.default_rng(3)
    coord = rng.random((500, 3)).astype(np.float32)
    coord[100:140] = coord[20:60]
    coord[300:310] = coord[300]
    batch = np.sort(rng.integers(0, 3, 500))
    mask = rng.random(500) > 0.1
    c, m, b = torch.from_numpy(coord), torch.from_numpy(mask), torch.from_numpy(batch)
    k16 = knn(c, c, 16, m, m, query_batch=b, ref_batch=b)[0]
    k8 = knn(c, c, 8, m, m, query_batch=b, ref_batch=b)[0]
    assert torch.equal(k8, k16[:, :8])
    r16 = knn_table(c, m, b, 16)
    assert torch.equal(knn_table(c, m, b, 8), r16[:, :8])
    assert torch.equal(k16.long(), r16)


def test_the_weights_cover_the_published_model_exactly():
    cfg = manifest.cell("ptv2_scannet.train")["cfg"]
    R = manifest.reference(cfg)
    shapes = R.param_shapes(R.Arch(cfg["model"]))
    with torch.device("meta"):
        model = builder._build(dict(cfg["model"]))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == shapes
    assert sum(v.numel() for v in model.parameters()) == 11_323_948
    assert sum(isinstance(m, torch.nn.Module) and type(m).__name__ == "PointceptGVA"
               for m in model.modules()) == 17


def test_the_registered_name_builds_and_trains_through_the_step():
    """``PT-v2m2-pointcept`` through `builder.build_model` (its own weight
    draw) and `make_train_step`: two steps, no level drops a point."""
    from cdsegnet_torch.engine.optimizer import build_optimizer
    from cdsegnet_torch.engine.state import make_train_step
    from cdsegnet_torch.utils.synthetic import synthetic_point_batch

    cfg = dict(type="DefaultSegmentor",
               backbone=dict(type="PT-v2m2-pointcept", in_channels=6, num_classes=5,
                             grid_sizes=(0.1, 0.2, 0.4, 0.8), **{
                                 k: v for k, v in NARROW.items() if k != "dtype"}),
               criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)])
    model = builder.build_model(cfg, device="cpu")
    opt = build_optimizer(dict(type="AdamW", lr=0.005, weight_decay=0.02), model,
                          dict(type="OneCycleLR", pct_start=0.05), total_steps=10,
                          param_dicts=[], device="cpu")
    step = make_train_step(model, builder.build_model_criteria(cfg), opt, seed=0, device="cpu")
    point = synthetic_point_batch(2048, 2, 8, seed=1, device="cpu")
    losses = []
    for _ in range(2):
        out = step(point)
        losses.append(float(out["loss"]))
        assert [int(out[f"dropped_l{i}"]) for i in range(1, 5)] == [0] * 4
    assert all(np.isfinite(losses)) and losses[0] != losses[1]


@pytest.mark.cuda
def test_the_metric_levels_mean_on_the_card_is_the_cpus_sum_in_order():
    """The pooled coordinates that the kNN tables rank are the same bits on
    the card as on the CPU, with a long run of padding rows among them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from cdsegnet_torch.ops import segments

    g = torch.Generator().manual_seed(0)
    v = torch.randn(200_000, 3, generator=g) * 3.0
    seg = torch.sort(torch.randint(0, 30_000, (200_000,), generator=g)).values
    valid = torch.arange(200_000) < 150_000
    seg = torch.where(valid, seg, 30_000)
    want = segments.segment_reduce(v, seg, 30_001, "mean", valid)
    for _ in range(2):
        got = segments.segment_reduce(v.cuda(), seg.cuda(), 30_001, "mean", valid.cuda())
        assert torch.equal(got.cpu(), want)
