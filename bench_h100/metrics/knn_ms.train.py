"""Device ms per step launched inside the port's ``pointops.knn`` spans
(marked as profiler ranges while the profiler runs): the kNN tables."""
from bench_h100.layers import host_range_ms


def read(run):
    return host_range_ms(run, "pointops.knn")
