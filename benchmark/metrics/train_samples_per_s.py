"""Training throughput: samples of all steps completed in the window over
the window's seconds (host clock, the window ending at a synchronise)."""


def read(rec):
    if rec.kind != "train" or rec.window_s <= 0:
        return None
    return rec.units * rec.batch / rec.window_s
