"""Arithmetic shared by the metric readers in ``metrics/``: each reader
takes a run's record (see `run.py`) and gives its number, or None where the
run has nothing for it to read. A roofline or peak share is never made up:
without kernels in the trace, or with a launch count that disagrees with the
port's counters, it is None.
"""

from __future__ import annotations

import math
import statistics
from typing import Callable, Optional

from bench_h100.counts import PEAK_FLOPS


def rate(run, key: str = "points") -> float:
    w = run["window"]
    return w[key] / w["seconds"]


def percentile_ms(values, q: float) -> Optional[float]:
    """The ``q`` quantile by nearest rank, in milliseconds."""
    if not values:
        return None
    s = sorted(values)
    return 1e3 * s[max(math.ceil(q * len(s)) - 1, 0)]


def idle_share(run) -> Optional[float]:
    tr = run.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def family_ms(run, family: str) -> Optional[float]:
    """Device milliseconds per step (or request) of one kernel family."""
    tr = run.get("trace")
    if tr is None:
        return None
    sec = tr.family_seconds().get(family)
    return None if sec is None else 1e3 * sec / run["stretch"]["steps"]


def host_range_ms(run, prefix: str) -> Optional[float]:
    """Device milliseconds per step launched inside host ranges named
    ``prefix...`` (from the stretch traced with the host's operators)."""
    tr = run.get("host_trace")
    sec = None if tr is None else tr.seconds_under(prefix)
    return None if not sec else 1e3 * sec / run["stretch"]["host_steps"]


def mfu(run, per: str) -> Optional[float]:
    """The untraced window's needed FLOPs over its time, against the
    configuration's peak, in percent: ``per`` is ``per_bucket`` or
    ``per_fragment``, indexed by ``run["order"]``."""
    if per not in run:
        return None
    flops = sum(run[per][i]["flops"] for i in run["order"])
    return 100.0 * flops / run["window"]["seconds"] / PEAK_FLOPS[run["cfg"]["dtype"]]


def roofline(run, per: str, bound_key: str, match: Callable[[str], bool],
             launch_keys) -> Optional[float]:
    """Summed bound seconds of the stretch's attention launches over their
    summed device time, in percent."""
    tr = run.get("trace")
    if tr is None or per not in run:
        return None
    units = run["stretch"].get("buckets") or run["stretch"].get("fragments")
    bound = sum(run[per][i]["attention"][bound_key] for i in units)
    sec, count = tr.kernel_seconds(match)
    launched = sum(run["stretch"]["launches"][k] for k in launch_keys)
    if count == 0 or count != launched:
        return None
    return 100.0 * bound / sec


def mean_ms(values) -> Optional[float]:
    return 1e3 * statistics.fmean(values) if values else None
