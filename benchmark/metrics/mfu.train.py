"""The whole training step's share of the cards' bf16 peak: 3 x the
closed-form forward FLOPs of the global batch a step, over the seconds a
step takes in the traced run's window before its profiled sub-window,
over the cell's chips."""

from benchmark import flops
from benchmark.judge import untraced


def read(rec):
    units, seconds = untraced(rec)
    if rec.kind != "train" or seconds <= 0 or units <= 0:
        return None
    work = 3.0 * flops.model_flops(rec.model, rec.batch) * units
    return 100.0 * work / seconds / (flops.PEAK_BF16 * rec.chips)
