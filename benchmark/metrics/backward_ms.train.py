"""Device ms a training step spends in kernels launched under the
program's `fbanet.backward` span, over the traced sub-window's whole
`fbanet.train_step` spans (`benchmark/spans.py`)."""

from benchmark import spans


def read(rec):
    s = spans.per_unit(rec, "train", "fbanet.backward", "fbanet.train_step",
                       "device_s")
    return None if s is None else 1e3 * s
