"""Bound seconds of the stretch's forward attention launches over their
device time (patch_attention_fwd kernels)."""
from bench_h100.layers import roofline


def read(run):
    return roofline(run, "per_bucket", "fwd", lambda n: "patch_attention_fwd" in n, ("fwd",))
