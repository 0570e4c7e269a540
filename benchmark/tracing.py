"""The traced sub-window: torch.profiler over the last steps (or batches)
of a `--trace 1` run, its Chrome trace written under the run's TMPDIR,
and the reduction of that trace to what the per-layer metrics read.

Device activity is every kernel, copy and set on the card. Within the
sub-window's span (the `bench.subwindow` annotation, closed after a
synchronise):

- busy: the union of the device intervals; idle is the rest of the span;
- kernel seconds by name, and the device seconds of an operator: the
  kernels whose names hold one of the operator's patterns
  (`kernels/*.json`);
- exposed collective time: NCCL kernel time that no other kernel covers
  (the benchmark's own step agreement left out);
- the longest idle gaps, each named by the innermost host operation
  running at its middle (under the benchmark's own annotation, if any).
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass, field

import torch

SPAN = "bench.subwindow"
# the ranks' agreement on the window (`benchmark/kinds/train.py::window`)
# is the one integer all-reduce of a step; it is the benchmark's, not DDP's
_OWN_COLLECTIVE = "AllReduce_Sum_u32"
_ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
               torch.profiler.ProfilerActivity.CUDA]
_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
_HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _length(union):
    return sum(b - a for a, b in union)


def _overlap(union, a, b):
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in union)


def short_name(name: str, limit: int = 160) -> str:
    """A kernel's name without `void `, anonymous namespaces and its
    parameter list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:limit]


@dataclass
class Trace:
    """The reduction of one sub-window's trace (seconds)."""

    span_s: float
    busy_s: float
    steps: int
    kernel_s: dict = field(default_factory=dict)
    nccl_exposed_s: float = 0.0
    idle_gaps: list = field(default_factory=list)

    def op_s(self, patterns) -> float:
        return sum(s for name, s in self.kernel_s.items()
                   if any(p in name for p in patterns))

    def device_ops(self, n: int = 10) -> list:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]
        return [[short_name(k), v] for k, v in top]


def reduce_trace(path: str, steps: int) -> Trace | None:
    """The Trace of the Chrome trace at `path`, or None where it holds no
    sub-window span or no device activity."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in events if e.get("name") == SPAN
             and e.get("cat") in ("user_annotation", "cpu_op")]
    if not spans:
        return None
    t0 = min(float(e["ts"]) for e in spans)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    dev, kernels = [], {}
    for e in events:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        a = max(t0, float(e["ts"]))
        b = min(t1, float(e["ts"]) + float(e["dur"]))
        if b <= a:
            continue
        dev.append((a, b, e.get("cat"), e.get("name", "")))
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0.0) + (b - a) / 1e6
    if not dev:
        return None
    busy = _union([(a, b) for a, b, _, _ in dev])
    nccl = _union([(a, b) for a, b, c, n in dev
                   if c == "kernel" and "nccl" in n.lower()
                   and _OWN_COLLECTIVE not in n])
    other = _union([(a, b) for a, b, c, n in dev
                    if c == "kernel" and "nccl" not in n.lower()])
    exposed = sum((b - a) - _overlap(other, a, b) for a, b in nccl)
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        gaps.append((prev, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in events if e.get("cat") in _HOST_CATS
            and e.get("name") != SPAN]
    named = []
    for a, b in gaps[:10]:
        mid = (a + b) / 2
        cover = [e for e in host
                 if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        inner = min(cover, key=lambda e: float(e["dur"]), default=None)
        ours = [e for e in cover if e["name"].startswith("bench.")]
        label = inner["name"] if inner is not None else "(no host op)"
        if ours and (inner is None or inner["name"] != ours[0]["name"]):
            label = f"{ours[0]['name']} > {label}"
        named.append([label[:160], (b - a) / 1e6])
    return Trace(span_s=(t1 - t0) / 1e6, busy_s=_length(busy) / 1e6,
                 steps=steps, kernel_s=kernels,
                 nccl_exposed_s=exposed / 1e6, idle_gaps=named)


class SubWindow:
    """Profile the steps between `start()` and `stop()`; `stop` returns
    the reduced trace (None where the profiler saw no device activity).
    The profiler is not started before (not even to warm it up): once it
    has run, every launch in the process pays for it, which slows the
    host-bound serving loop by a third."""

    def __init__(self, tag: str):
        self.path = os.path.join(tempfile.gettempdir(),
                                 f"bench_trace_{tag}.json")
        self.prof = self.span = None
        self.steps = 0
        self.before = None  # (units complete, seconds) when profiling began

    def start(self, units: int, seconds: float) -> None:
        self.before = (units, seconds)
        self.prof = torch.profiler.profile(activities=_ACTIVITIES)
        self.prof.__enter__()
        self.span = torch.profiler.record_function(SPAN)
        self.span.__enter__()

    @property
    def active(self) -> bool:
        return self.prof is not None

    def stop(self) -> Trace | None:
        torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        return reduce_trace(self.path, self.steps)
