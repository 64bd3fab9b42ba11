"""The numbers that decide ``correct``, each held to its limit.

Training (the first three steps that set-up drives through the timed step):

- ``loss_gap``: the largest gap of a step's loss from the reference's, over
  the reference's;
- ``grad_gap``: by the worst leaf, the gap between the norms of the first
  gradient as the optimizer took it (program: from its state after one
  update) and the reference's, over the reference leaf's norm or the median
  leaf's, whichever is larger;
- ``grad_median_gap``: the median of those gaps over the leaves, which
  rounding in small leaves moves less (it separates the bf16 program from
  its fp8 control where the worst leaf does not);
- ``update_gap``: the worst leaf's gap for the parameters' change after three updates,
  over the leaves whose reference gradient is at least a thousandth of the
  median leaf's, and within them over the elements whose reference gradient
  is at least a thousandth of the median leaf's root mean square (the
  others, such as a bias that BatchNorm cancels or the key bias under the
  softmax, move under Adam by round-off alone).

Inference (a sample of the window's answers, drawn from the seed):

- ``prob_gap``: the largest gap of a probability from the reference's;
- ``prob_rel``: the largest relative L2 gap of one answer's probabilities.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

import torch


def _leaf_gaps(prog: Dict[str, Optional[float]], ref: Dict[str, float], keep=None) -> List[float]:
    """Per leaf, the gap between the program's norm (0 where it kept none)
    and the reference's, over the reference leaf's norm or the median
    leaf's, whichever is larger."""
    names = [n for n in ref if keep is None or keep(n)]
    med = statistics.median(ref[n] for n in names)
    gaps = []
    for n in names:
        gap = abs((prog.get(n) or 0.0) - ref[n]) / max(ref[n], med, 1e-30)
        gaps.append(gap if math.isfinite(gap) else math.inf)
    return gaps


def _leaf_gap(prog: Dict[str, Optional[float]], ref: Dict[str, float], keep=None) -> float:
    return max(_leaf_gaps(prog, ref, keep))


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref`` each hold ``losses`` (three floats), ``grad``
    and ``update`` (leaf name -> norm; None where the program kept none)."""
    loss = max(abs(p - r) / max(abs(r), 1e-30) if math.isfinite(p) else math.inf
               for p, r in zip(prog["losses"], ref["losses"]))
    med = statistics.median(ref["grad"].values())
    moved = lambda n: ref["grad"][n] >= 1e-3 * med
    return dict(loss_gap=loss, grad_gap=_leaf_gap(prog["grad"], ref["grad"]),
                grad_median_gap=statistics.median(_leaf_gaps(prog["grad"], ref["grad"])),
                update_gap=_leaf_gap(prog["update"], ref["update"], moved))


def worst_leaves(prog: Dict, ref: Dict, key: str, top: int = 4) -> List:
    """The leaves that read the largest gaps on ``key`` (``grad`` or
    ``update``): name, program norm, reference norm, reference gradient."""
    med = statistics.median(ref[key].values())
    gmed = statistics.median(ref["grad"].values())
    gaps = sorted(((abs((prog[key].get(n) or 0.0) - r) / max(r, med, 1e-30), n)
                   for n, r in ref[key].items()
                   if key == "grad" or ref["grad"][n] >= 1e-3 * gmed), reverse=True)[:top]
    return [[n, g, prog[key].get(n), ref[key][n], ref["grad"][n]] for g, n in gaps]


def prob_numbers(pairs: List) -> Dict[str, float]:
    """``pairs`` of (program probabilities, reference probabilities) over
    one answer's points each."""
    gap = rel = 0.0
    for p, r in pairs:
        d = (p.float() - r.float())
        g = float(d.abs().max())
        gap = max(gap, g if math.isfinite(g) else math.inf)
        q = float(d.norm() / r.float().norm().clamp(min=1e-30))
        rel = max(rel, q if math.isfinite(q) else math.inf)
    return dict(prob_gap=gap, prob_rel=rel)


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """``(correct, checks)``: every number at or under its limit;
    ``checks`` maps each to its value and limit."""
    checks = {k: dict(value=numbers[k], limit=limits[k]) for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def moving_elements(first: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per leaf, the elements whose first reference gradient is at least a
    thousandth of the median leaf's root mean square."""
    rms = torch.stack([g.float().square().mean().sqrt() for g in first.values()])
    tau = 1e-3 * float(rms.median())
    return {n: g.abs() >= tau for n, g in first.items()}


def masked_norms(delta: Dict[str, torch.Tensor], keep: Dict[str, torch.Tensor]):
    return leaf_norms({n: torch.where(keep[n], d, torch.zeros_like(d)) for n, d in delta.items()})


def leaf_norms(tensors: Dict[str, Optional[torch.Tensor]]) -> Dict[str, Optional[float]]:
    names = list(tensors)
    vals = [tensors[n] for n in names]
    present = [v for v in vals if v is not None]
    norms = iter(torch.stack([v.float().norm() for v in present]).tolist()) if present else iter(())
    return {n: (next(norms) if v is not None else None) for n, v in zip(names, vals)}
