"""The Swin operators' forward in the serving step against its roofline
(as `swin_fwd_roofline.train`, for each profiled batch)."""

from benchmark.metrics_common import roofline


def read(rec):
    return roofline(rec, "serve", "swin_fwd", backward=False)
