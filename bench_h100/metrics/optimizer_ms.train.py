"""Device ms per step launched inside torch's Optimizer.step range."""
from bench_h100.layers import host_range_ms


def read(run):
    return host_range_ms(run, "Optimizer.step#")
