"""The plain references against the port, in float32 on the CPU, at the
tests' size: one training step's loss and first gradients, and SSI's
probabilities."""

from __future__ import annotations

import statistics

import pytest
import torch

from bench_h100 import compare, manifest, program, traffic, weights
from bench_h100.loops.test_fragments import bucket_for, noise, reference_probs
from bench_h100.loops.train_buckets import reference_steps
from bench_h100.reference.nn import Precision
from bench_h100.tests import tiny

SEED = 3 ** 21


def _program_first_step(cell):
    cfg = cell["cfg"]
    R = manifest.reference(cfg)
    arch = R.Arch(cfg["model"])
    mix, buckets = traffic.make(cell["traffic"], SEED)
    scenes = mix["scenes_per_bucket"]
    tb = [{k: torch.as_tensor(v) for k, v in b.items()} for b in buckets]
    model = program.build_model(cfg, weights.make(R.param_shapes(arch), traffic.derive(SEED, 10),
                                                  "cpu"), "cpu")
    step, opt = program.train_step(cfg, model, 1, "cpu")
    draws = R.train_draws(arch, tb[0], scenes, traffic.derive(SEED, 20, 0))
    masks = draws.pop("path_masks", None)
    if masks is not None:
        step.generators["dropout"] = program.path_draws(masks)
    out = step(program.to_point(buckets[0], cfg["serialization_depth"], scenes, "cpu"), **draws)
    return float(out["loss"]), compare.leaf_norms(program.first_gradients(opt, cfg)), tb, scenes


@pytest.mark.parametrize("name", ["cdsegnet_scannet.train", "spunet_scannet.train"])
def test_the_first_step_agrees(name):
    cell = tiny.cell(name)
    loss, grad, tb, scenes = _program_first_step(cell)
    ref = reference_steps(cell, tb, scenes, SEED, Precision("f32"), "cpu")
    assert abs(loss - ref["losses"][0]) <= 1e-5 * abs(ref["losses"][0])
    med = statistics.median(ref["grad"].values())
    for n, r in ref["grad"].items():
        assert abs(grad[n] - r) <= 1e-3 * max(r, med), n


def test_ssi_agrees():
    cell = tiny.cell("cdsegnet_scannet.infer")
    cfg = cell["cfg"]
    R = manifest.reference(cfg)
    arch = R.Arch(cfg["model"])
    frags = traffic.make(cell["traffic"], SEED)[1]
    model = program.build_model(cfg, weights.make(R.param_shapes(arch), traffic.derive(SEED, 10),
                                                  "cpu"), "cpu").eval()
    tester = program.tester(cfg, model, "cpu")
    for i in (0, len(frags) - 1):
        got = tester.predict_fragment(frags[i], i, lambda j, b, c: noise(SEED, j, b, c, "cpu"))
        want = reference_probs(cell, frags, SEED, i, Precision("f32"), "cpu")
        assert bucket_for(cfg, len(frags[i]["coord"])) >= len(frags[i]["coord"])
        assert float((got - want).abs().max()) < 1e-4


def test_weights_cover_the_port_exactly():
    for name in ("cdsegnet_scannet", "spunet_scannet"):
        cfg = manifest.cell(f"{name}.train")["cfg"]
        R = manifest.reference(cfg)
        shapes = R.param_shapes(R.Arch(cfg["model"]))
        from cdsegnet_torch.models import builder

        with torch.device("meta"):
            model = builder._build(dict(cfg["model"]))
        have = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert have == shapes
        if name == "cdsegnet_scannet":
            assert sum(v.numel() for v in model.parameters()) == 101_387_354
