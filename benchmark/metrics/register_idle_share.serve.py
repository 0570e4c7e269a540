"""The share of the program's `fbanet.register` spans' host intervals
(online registration) in which no kernel, copy or set ran on the card, in
the traced sub-window (`benchmark/spans.py`)."""

from benchmark import spans


def read(rec):
    got = spans.of(rec) if rec.kind == "serve" else None
    reg = (got or {}).get("fbanet.register")
    if reg is None or reg.host_s <= 0:
        return None
    return 100.0 * reg.idle_s / reg.host_s
