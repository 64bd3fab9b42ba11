"""The share of the traced stretch in which no device operation ran."""
from bench_h100.layers import idle_share


def read(run):
    return idle_share(run)
