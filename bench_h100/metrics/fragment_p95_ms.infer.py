"""The 95th percentile of the latency of every request in the window, from
hand-over to probabilities ready after a synchronize (host clock)."""
from bench_h100.layers import percentile_ms


def read(run):
    return percentile_ms(run["window"]["latencies"], 0.95)
