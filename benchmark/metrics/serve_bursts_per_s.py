"""Serving throughput: bursts of all batches completed in the window over
the window's seconds (host clock)."""


def read(rec):
    if rec.kind != "serve" or rec.window_s <= 0:
        return None
    return rec.units * rec.batch / rec.window_s
