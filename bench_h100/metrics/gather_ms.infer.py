"""Device ms per request of the gather/scatter kernel family."""
from bench_h100.layers import family_ms


def read(run):
    return family_ms(run, "gather/scatter")
