"""The share of the profiled sub-window in which no kernel, copy or set
ran on the card (training cells; rank 0's card)."""

from benchmark.metrics_common import idle_share


def read(rec):
    return idle_share(rec, "train")
