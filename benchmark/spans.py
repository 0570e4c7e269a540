"""The program's own spans in a traced run.

The port opens `fbanet.*` spans (`fbanet_tpu_torch/utils/profiling.py`)
where its work happens; with the profiler on they are events of the same
Chrome trace as the card's kernels. `reduce_spans` reads the trace that
`tracing.SubWindow` wrote and gives, for each `fbanet.*` name:

- `count`: its spans within the sub-window, `host_s` their host seconds;
- `device_s`, `launches`: the device seconds and the count of the kernels
  whose launch (`cudaLaunchKernel`, `cudaLaunchKernelExC`, `cuLaunchKernel`,
  `cuLaunchKernelEx`), matched to the kernel by the trace's `correlation`,
  lies inside one of its spans on any thread (autograd launches the
  backward from its own thread). A span's figures hold those of the spans
  inside it. Attribution is by launch, never by device-time overlap: under
  the one-deep loss pipeline a step's kernels run while the host is in
  the next step;
- `idle_s`: the seconds within its spans' host intervals in which no
  kernel, copy or set ran on the card.

Two more entries: `NO_SPAN`, kernels launched in the trace under no
`fbanet.*` span, and `NO_LAUNCH`, kernels whose launch the trace does not
hold (the step or batch in flight when the profiler started).

Per step or batch means over the count of the spans of the step or
batch (`fbanet.train_step`, `fbanet.register`), not `Trace.steps`: the
first profiled step was queued before the profiler started.
"""

from __future__ import annotations

import bisect
import functools
import json
import os
from dataclasses import dataclass

from benchmark import tracing

PREFIX = "fbanet."
NO_SPAN = "(no span)"
NO_LAUNCH = "(no launch)"
_SPAN_CATS = ("user_annotation", "cpu_op")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Span:
    """What one `fbanet.*` name holds in the sub-window (seconds)."""

    count: int = 0
    host_s: float = 0.0
    device_s: float = 0.0
    launches: int = 0
    idle_s: float = 0.0


class _Covered:
    """Length of a sorted, disjoint union of intervals within [a, b]."""

    def __init__(self, union):
        self.starts = [a for a, _ in union]
        self.ends = [b for _, b in union]
        self.cum = [0.0]
        for a, b in union:
            self.cum.append(self.cum[-1] + b - a)

    def _upto(self, x):
        i = bisect.bisect_right(self.starts, x)
        if i == 0:
            return 0.0
        return self.cum[i - 1] + min(x, self.ends[i - 1]) - self.starts[i - 1]

    def within(self, a, b):
        return self._upto(b) - self._upto(a)


def reduce_spans(path: str) -> dict[str, Span] | None:
    """{name: Span} of the Chrome trace at `path` (`NO_SPAN` and
    `NO_LAUNCH` among them), or None where it holds no sub-window."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    window = [e for e in events if e.get("name") == tracing.SPAN
              and e.get("cat") in _SPAN_CATS]
    if not window:
        return None
    t0 = min(float(e["ts"]) for e in window)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in window)

    def corr(e):
        return (e.get("args") or {}).get("correlation")

    launch_ts = {corr(e): float(e["ts"]) for e in events
                 if e.get("cat") in _LAUNCH_CATS
                 and "LaunchKernel" in e.get("name", "")
                 and corr(e) is not None}
    spans: dict[str, list] = {}
    for e in events:
        name = e.get("name", "")
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if (name.startswith(PREFIX) and e.get("cat") in _SPAN_CATS
                and t0 <= a and b <= t1):
            spans.setdefault(name, []).append((a, b))
    out = {name: Span() for name in [*spans, NO_SPAN, NO_LAUNCH]}
    for ivs in spans.values():
        ivs.sort()
    starts = {name: [a for a, _ in ivs] for name, ivs in spans.items()}
    busy = []
    for e in events:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        a = max(t0, float(e["ts"]))
        b = min(t1, float(e["ts"]) + float(e["dur"]))
        if b <= a:
            continue
        busy.append((a, b))
        if e.get("cat") != "kernel":
            continue
        ts = launch_ts.get(corr(e))
        if ts is None:
            under = [NO_LAUNCH]
        else:
            under = []
            for name, ivs in spans.items():
                i = bisect.bisect_right(starts[name], ts) - 1
                if i >= 0 and ts <= ivs[i][1]:
                    under.append(name)
            under = under or [NO_SPAN]
        for name in under:
            out[name].device_s += (b - a) / 1e6
            out[name].launches += 1
    covered = _Covered(tracing._union(busy))
    for name, ivs in spans.items():
        s = out[name]
        s.count = len(ivs)
        s.host_s = sum(b - a for a, b in ivs) / 1e6
        s.idle_s = sum((b - a) - covered.within(a, b)
                       for a, b in tracing._union(ivs)) / 1e6
    return out


@functools.lru_cache(maxsize=1)
def _reduced(path: str, mtime_ns: int):
    return reduce_spans(path)


def of(rec) -> dict[str, Span] | None:
    """The spans of `rec`'s traced sub-window (rank 0's), or None where
    the run was not traced."""
    if rec.trace is None:
        return None
    for tag in (f"{rec.cell}_r0", rec.cell):
        path = tracing.SubWindow(tag).path
        if os.path.exists(path):
            return _reduced(path, os.stat(path).st_mtime_ns)
    return None


def per_unit(rec, kind: str, name: str, unit_span: str, field: str):
    """`field` of span `name` over the count of `unit_span` spans (the
    step's or the batch's), or None where either is absent."""
    if rec.kind != kind:
        return None
    got = of(rec)
    if not got or name not in got or not got.get(unit_span, Span()).count:
        return None
    return getattr(got[name], field) / got[unit_span].count

