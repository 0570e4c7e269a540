"""The serving step's share of the card's bf16 peak: the closed-form
forward FLOPs of a batch (registration not counted), over the seconds a
batch takes in the traced run's window before its profiled sub-window."""

from benchmark import flops
from benchmark.judge import untraced


def read(rec):
    units, seconds = untraced(rec)
    if rec.kind != "serve" or seconds <= 0 or units <= 0:
        return None
    work = flops.model_flops(rec.model, rec.batch) * units
    return 100.0 * work / seconds / flops.PEAK_BF16
