"""Arithmetic that several metric readers share."""

from __future__ import annotations

from benchmark import flops


def roofline(rec, kind: str, op: str, backward: bool):
    """100 x (bound of `op` at the configuration's SwinLayer shapes for each
    profiled step) / (device seconds of `op`'s kernels), or None where the
    trace holds none of them."""
    if rec.kind != kind or rec.trace is None or not rec.trace.steps:
        return None
    spent = rec.trace.op_s(rec.kernel_tables.get(op, ()))
    if spent <= 0:
        return None
    bound = flops.swin_bound_s(rec.model, rec.local_batch, backward)
    return 100.0 * bound * rec.trace.steps / spent


def idle_share(rec, kind: str):
    if rec.kind != kind or rec.trace is None or rec.trace.span_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.span_s)

