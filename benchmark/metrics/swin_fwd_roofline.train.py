"""The Swin operators' forward (fused window attention and LeFF) in the
training step against its roofline: the bound of the configuration's
SwinLayer shapes for each profiled step over the device seconds of the
kernels `kernels/*.json` map to `swin_fwd`."""

from benchmark.metrics_common import roofline


def read(rec):
    return roofline(rec, "train", "swin_fwd", backward=False)
