"""Host ms of the geometry build (precompute_geometry) per request of the
stretch, with a synchronize on each side."""
from bench_h100.layers import mean_ms


def read(run):
    return mean_ms(run.get("stretch", {}).get("geometry_s"))
