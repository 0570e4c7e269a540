"""Device ms a training step spends in kernels launched under the
program's `fbanet.forward` span, over the traced sub-window's whole
`fbanet.train_step` spans (`benchmark/spans.py`)."""

from benchmark import spans


def read(rec):
    s = spans.per_unit(rec, "train", "fbanet.forward", "fbanet.train_step",
                       "device_s")
    return None if s is None else 1e3 * s
