"""The traffic generator: a mix is a JSON file of parameters under
``bench_h100/traffic/``, found by its name. Its ``kind`` names the module
``loops/<kind>.py`` whose ``make(mix, seed)`` turns the mix and a seed into
the cell's inputs, and whose ``run`` drives them through the program; a new
kind of mix adds such a module and edits no file.

Every room and every random pick comes from the seed: the same seed gives
the same inputs. This module holds what every kind shares: loading a mix
and the seeds derived from the run's seed.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from bench_h100 import manifest

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str) -> Dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, *salt]))


def derive(seed: int, *salt: int) -> int:
    """A 62-bit seed for one use of the run's ``seed``, named by ``salt``."""
    return int(rng(seed, *salt).integers(0, 2 ** 62))


def room_seed(seed: int, i: int) -> int:
    return int(rng(seed, 1, i).integers(0, 2 ** 31))


def make(name, seed: int):
    """``(mix, inputs)`` of the mix named ``name`` (or given as a dict)."""
    mix = load(name) if isinstance(name, str) else name
    return mix, manifest.loop(mix["kind"]).make(mix, seed)
