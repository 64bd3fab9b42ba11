"""Device ms per step launched inside the port's ``ptv2.attention`` spans:
the grouped vector attention's forward (its backward runs on autograd's
thread, outside them)."""
from bench_h100.layers import host_range_ms


def read(run):
    return host_range_ms(run, "ptv2.attention")
