"""Valid points of every training step completed in the window, over the
window (host clock, ending in a synchronize)."""
from bench_h100.layers import rate


def read(run):
    return rate(run)
