"""Needed FLOPs of the untraced window's steps (forward, and backward at
twice the forward) over its time, against the peak of the configuration's
dtype."""
from bench_h100.layers import mfu


def read(run):
    return mfu(run, "per_bucket")
