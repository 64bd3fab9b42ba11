"""Valid points of every fragment segmented in the window (probabilities on
the card), over the window (host clock)."""
from bench_h100.layers import rate


def read(run):
    return rate(run)
