"""Random weights from a seed, made on the device in one draw.

Every parameter and BatchNorm statistic of a configuration, by the names its
reference gives (those of the measured port): matrices and conv kernels
normal with variance 1 / fan-in, norm scales 1 + N(0, 0.1^2), biases
N(0, 0.05^2), running means 0 and variances 1. Both sides of a comparison
load the same dict.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def make(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    sizes = [math.prod(s) for s in shapes.values()]
    g = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out = {}
    for (name, shape), part in zip(shapes.items(), torch.split(flat, sizes)):
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "mean":
            part = torch.zeros_like(part)
        elif leaf == "var":
            part = torch.ones_like(part)
        elif leaf == "scale":
            part = 1.0 + 0.1 * part
        elif len(shape) == 1:
            part = 0.05 * part
        else:
            part = part / math.sqrt(math.prod(shape[:-1]) if len(shape) == 3 else shape[1])
        out[name] = part.reshape(shape)
    return out
