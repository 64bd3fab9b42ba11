"""Bound seconds of the stretch's attention backward over the device time
of its dq and dk/dv kernels."""
from bench_h100.layers import roofline


def read(run):
    return roofline(run, "per_bucket", "bwd", lambda n: "patch_attention_bwd" in n,
                    ("dq", "dkdv"))
