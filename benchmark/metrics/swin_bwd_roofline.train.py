"""The Swin operators' backward (fused window attention and LeFF with
their weight-gradient sums) against its roofline: the bound of the
configuration's SwinLayer shapes for each profiled step over the device
seconds of the kernels `kernels/*.json` map to `swin_bwd`."""

from benchmark.metrics_common import roofline


def read(rec):
    return roofline(rec, "train", "swin_bwd", backward=True)
