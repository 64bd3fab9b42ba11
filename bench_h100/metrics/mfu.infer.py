"""Needed FLOPs of the untraced window's SSI forwards over its time,
against the peak of the configuration's dtype."""
from bench_h100.layers import mfu


def read(run):
    return mfu(run, "per_fragment")
