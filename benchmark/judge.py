"""What a run hands the result line, and the comparisons that decide
`correct`.

Training (`train_numbers`): the first step's prediction and loss, the
first gradient as the optimizer holds it after step 1, and each
parameter's change after the checked steps, of the program against the
reference. A leaf's gap is
the gap between the program's norm of it and the reference's, over the
reference's norm of that leaf or of the median leaf, whichever is larger.
Elements whose reference gradient is under a thousandth of the median
leaf's (a key's bias under softmax) move under Adam by round-off alone
and are left out of the change.

Serving (`serve_numbers`): on the sampled batches, the worst burst's RMS
gap between the program's prediction (registered, predicted, clamped) and
the reference's. The gaps of PSNR and SSIM are not compared: the control
moves them by less than three times the program's own gaps (the bilinear
base, computed alike on both sides, sets most of either metric).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Record:
    """One run as the result line and the metric readers see it."""

    kind: str            # "train" or "serve"
    cell: str
    model: dict
    batch: int           # global rows a step (or bursts a batch)
    local_batch: int     # rows on one chip
    chips: int
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0       # steps or batches completed in the window
    # in a traced run: (units complete, seconds) when profiling began
    before_trace: tuple | None = None
    latencies_s: list = field(default_factory=list)
    align_s: list = field(default_factory=list)
    trace: object = None           # tracing.Trace of rank 0
    busy_s: list = field(default_factory=list)   # per rank
    span_s: list = field(default_factory=list)
    peak_bytes: int = 0
    peak_window_bytes: int = 0
    numbers: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    kernel_tables: dict = field(default_factory=dict)


def untraced(rec: Record) -> tuple[int, float]:
    """(units, seconds) of the window outside the profiler's overhead: its
    part before the profiled sub-window where there is one."""
    if rec.before_trace is not None and rec.before_trace[0] > 0:
        return rec.before_trace
    return rec.units, rec.window_s


def _median(values):
    return float(np.median(np.asarray(values, np.float64)))


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """{leaf: gap} of per-leaf norms {name: norm}: |prog - ref| over the
    reference's norm of the leaf or of the median leaf, the larger."""
    med = _median(list(ref.values()))
    out = {}
    for n, r in ref.items():
        gap = abs(prog[n] - r) / max(r, med, 1e-30)
        out[n] = gap if math.isfinite(gap) else math.inf
    return out


def change_gaps(delta, ref: dict) -> dict:
    """{leaf: gap} of the change norms over the elements that move: those
    whose reference first gradient is at least a thousandth of the median
    leaf's (RMS over its elements). Elements under it, such as a key's bias
    under softmax, move under Adam by round-off alone. Leaves with no such
    element are left out."""
    g, layout = ref["grad_flat"], ref["layout"]
    sizes = [n for _, n in layout]
    rms = [float(x.norm()) / math.sqrt(x.numel()) for x in g.split(sizes)]
    moving = g.abs() >= 1e-3 * _median(rms)

    def norms(d):
        return {name: float(x[m].norm())
                for (name, _), x, m in zip(layout, d.to(g.device).split(sizes),
                                           moving.split(sizes))
                if bool(m.any())}

    return leaf_gaps(norms(delta), norms(ref["delta"]))


def _worst(gaps: dict) -> tuple[float, str]:
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def train_numbers(prog: dict, ref: dict, where: dict | None = None) -> dict:
    """{name: value} of the program's readings against the reference's.
    The program's side: {"losses": [...], "grad": {leaf: norm} (or one such
    dict a rank), "delta": the flat change (or one a rank)}; the
    reference's: `kinds/train.py::reference`'s.

    - pred_rms_gap: step 1's prediction, the worst row's RMS gap;
    - loss_gap: step 1's loss (later steps follow Adam's first step, a sign
      step whose part on elements with gradients under bf16's rounding is
      noise in either precision);
    - grad_worst_gap: the worst leaf's gap of the first gradient;
    - grad_gap: the median leaf's, for cells whose worst leaf swings from
      seed to seed (a scalar slope summed over whole maps, all
      cancellation);
    - change_gap: the worst leaf's gap of the change after the checked
      steps, over the elements that move;
    and, printed by the control script for the look in PERF.md,
    loss_all_gap (every checked step). A cell compares those its limits
    name. `where` gets the losses and the worst leaves."""
    def ranks(x):
        return x if isinstance(x, list) else [x]

    losses = [(abs(a - b) / abs(b) if math.isfinite(a) else math.inf)
              for a, b in zip(prog["losses"], ref["losses"])]
    grads = [leaf_gaps(g, ref["grad"]) for g in ranks(prog["grad"])]
    changes = [change_gaps(d, ref) for d in ranks(prog["delta"])]
    grad_worst, grad_at = max(_worst(g) for g in grads)
    change, change_at = max(_worst(c) for c in changes)
    if where is not None:
        where.update(losses=prog["losses"], ref_losses=ref["losses"],
                     grad_leaf=grad_at, change_leaf=change_at)
    return {"pred_rms_gap": _rms_gap(prog["pred"], ref["pred"]),
            "loss_gap": losses[0], "grad_gap":
            max(_median(list(g.values())) for g in grads),
            "change_gap": change, "loss_all_gap": max(losses),
            "grad_worst_gap": grad_worst}


def _rms_gap(prog, ref) -> float:
    """The worst row's RMS gap of two predictions [B, H, W, C] (infinite
    where rows are missing)."""
    if prog.shape != ref.shape:
        return math.inf
    d = (prog.float().to(ref.device) - ref).reshape(ref.shape[0], -1)
    return _finite(d.pow(2).mean(-1).sqrt().max().item())


def serve_numbers(prog: list, ref: list) -> dict:
    """The worst sampled burst's RMS gap between the program's prediction
    and the reference's. Each side: per sampled batch (pred [B, H, W, C]
    float32 on any device, ...)."""
    return {"pred_rms_gap": max(_rms_gap(p[0], r[0])
                                for p, r in zip(prog, ref))}


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number that has a limit within it (a limit without its
    number fails)."""
    return all(k in numbers and math.isfinite(numbers[k])
               and numbers[k] <= limits[k] for k in limits)
