"""Metric helpers: AverageMeter and intersection/union histograms, on the
host (numpy) and on the device (torch).

Own copy of `cdsegnet_tpu/utils/misc.py` (reference
`pointcept/utils/misc.py:10-65`); `intersection_and_union_torch` is the
counterpart of its `intersection_and_union_jnp`.
"""

from __future__ import annotations

import numpy as np
import torch


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)


def intersection_and_union(
    output: np.ndarray, target: np.ndarray, K: int, ignore_index: int = -1
):
    """Per-class intersection/union/target histograms (numpy)."""
    output = output.reshape(-1).copy()
    target = target.reshape(-1)
    output[np.where(target == ignore_index)[0]] = ignore_index
    intersection = output[np.where(output == target)[0]]
    area_i, _ = np.histogram(intersection, bins=np.arange(K + 1))
    area_o, _ = np.histogram(output, bins=np.arange(K + 1))
    area_t, _ = np.histogram(target, bins=np.arange(K + 1))
    return area_i, area_o + area_t - area_i, area_t


def intersection_and_union_torch(pred: torch.Tensor, target: torch.Tensor, K: int,
                                 valid: torch.Tensor):
    """Per-class intersection/union/target histograms (int64, on the
    tensors' device) of the points that are ``valid`` and labelled
    (``target >= 0``); the others go to the sink class ``K``, dropped."""
    v = valid & (target >= 0)
    sink = torch.full_like(pred, K)
    p1 = torch.where(v, pred, sink).long()
    t1 = torch.where(v, target.to(pred.dtype), sink).long()
    inter = torch.where(p1 == t1, p1, K)
    area_i = torch.bincount(inter, minlength=K + 1)[:K]
    area_p = torch.bincount(p1, minlength=K + 1)[:K]
    area_t = torch.bincount(t1, minlength=K + 1)[:K]
    return area_i, area_p + area_t - area_i, area_t
