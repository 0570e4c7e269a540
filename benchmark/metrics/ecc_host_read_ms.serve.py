"""Host ms a batch spends in ECC's per-iteration host read (the
program's `fbanet.ecc.host_read` span, inside `fbanet.register`), over
the traced sub-window's `fbanet.register` spans (`benchmark/spans.py`).
Read with the profiler on, which lengthens the launches around it more
than the read itself."""

from benchmark import spans


def read(rec):
    s = spans.per_unit(rec, "serve", "fbanet.ecc.host_read",
                       "fbanet.register", "host_s")
    return None if s is None else 1e3 * s
