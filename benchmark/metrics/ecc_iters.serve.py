"""ECC's batched iterations a served batch, summed over the pyramid
levels: the program's counter `ecc_align.iterations` over its
`online_register.calls`, both as the run left them (every batch the
process registered: set-up's and the window's). A work count: a change
that keeps ECC's results leaves it as it is. None where the run did not
import the registration module or the program has no such counters."""

import sys


def read(rec):
    mod = sys.modules.get("fbanet_tpu_torch.ops.registration")
    iters = getattr(getattr(mod, "ecc_align", None), "iterations", None)
    calls = getattr(getattr(mod, "online_register", None), "calls", None)
    if rec.kind != "serve" or iters is None or not calls:
        return None
    return iters / calls
