"""Online registration (translation ECC, 3 x 25, eps 1e-5, a host read
each iteration): CUDA events around `online_register`, the mean over the
traced run's batches before its profiled sub-window, in ms."""

from benchmark.judge import untraced


def read(rec):
    units, _ = untraced(rec)
    times = rec.align_s[:units]
    if rec.kind != "serve" or not times:
        return None
    return 1e3 * sum(times) / len(times)
