"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven on the
CPU at the tests' size, against each cell's own limits. One chip holds
every cell, so no fault of an exchange between chips applies."""

from __future__ import annotations

import time

import pytest

from bench_h100 import compare, manifest
from bench_h100.tests import tiny

SEED = 2 ** 40 + 3


def _run(name, seconds, **kw):
    cell = tiny.cell(name)
    drive = manifest.loop(manifest.traffic_kind(cell["traffic"]))
    run = drive.run(cell, SEED, seconds, False, "cpu", time.perf_counter(), **kw)
    return compare.judge(run["numbers"], cell["limits"])[0], run


@pytest.mark.parametrize("name", ["cdsegnet_scannet.train", "spunet_scannet.train"])
@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
def test_a_broken_step_is_not_correct(name, fault):
    correct, run = _run(name, 0.5, fault=fault)
    assert not correct, run["numbers"]


def test_an_altered_answer_is_not_correct():
    correct, run = _run("cdsegnet_scannet.infer", 4.0, fault="altered")
    assert run["pairs"] and not correct, run["numbers"]


def test_the_sound_path_is_correct():
    for name, seconds in (("cdsegnet_scannet.train", 0.5), ("cdsegnet_scannet.infer", 4.0)):
        correct, run = _run(name, seconds)
        assert correct, (name, run["numbers"])


def test_the_bf16_control_is_not_correct():
    """fp8 in the reference's products, for the bf16 configuration (the
    float32 one's control, TF32, exists only on the card)."""
    correct, run = _run("cdsegnet_scannet.train", 0.5, control=True)
    assert not correct, run["numbers"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cdsegnet_scannet.train", "spunet_scannet.train",
                                  "cdsegnet_scannet.infer"])
def test_the_control_is_not_correct_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = tiny.cell(name)
    drive = manifest.loop(manifest.traffic_kind(cell["traffic"]))
    run = drive.run(cell, SEED, 1.0, False, "cuda", time.perf_counter(), control=True)
    assert not compare.judge(run["numbers"], cell["limits"])[0], run["numbers"]
