"""Kernels launched under the program's `fbanet.register` span (online
registration), a batch, over the traced sub-window's `fbanet.register`
spans (`benchmark/spans.py`)."""

from benchmark import spans


def read(rec):
    return spans.per_unit(rec, "serve", "fbanet.register", "fbanet.register",
                          "launches")
