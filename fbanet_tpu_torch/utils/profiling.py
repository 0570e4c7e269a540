"""Tracing and profiling hooks: the counterpart of
fbanet_tpu/utils/profiling.py.

- `StepTimer`: steady-state per-step timing with the first steps left out
  and a percentile summary (the same API and summary as the JAX package's);
- `trace`: a context manager around `torch.profiler` that writes a Chrome
  trace (`chrome://tracing`, Perfetto) of the host and, on the card, the
  device's kernels and copies;
- `annotate`: a named span inside a trace. With the profiler on it is a
  `torch.profiler.record_function`, an event in the same trace as the
  card's kernels and on its clock; with the profiler off, a shared no-op
  (a bare `record_function` costs ~10 us on the host even then).

StepTimer reads the host clock: around card work, end each step with
`torch.cuda.synchronize()` (or a host read of a result), or it times the
launches only.

The program's spans, all `fbanet.*`:

- `fbanet.train_step` (`train.make_train_step`): the whole step, which
  holds `fbanet.forward` (each microbatch's loss: mixup, online
  registration, the model, the loss), `fbanet.backward` (each
  `.backward()`, DDP's all-reduce included) and `fbanet.update` (the
  gradients' reset at the start; the loss mean, the zero-fill of unused
  gradients, clipping, the learning rate and the optimizer step at the
  end). Every kernel of a step is launched under exactly one of the three.
- `fbanet.register` (`ops/registration.online_register`): online
  registration of a batch; inside it `fbanet.ecc.host_read`, the host
  read of the loop condition that ECC's plain version makes once an
  iteration (the CUDA kernel `ecc_translation` makes none).

Counters are always on: an integer attribute of the function that does
the work, raised where the work runs (`fn.launches += 1` in the kernel
wrappers). `ops/registration.ecc_align.iterations` counts ECC's batched
iterations, summed over the pyramid levels (the kernel's once a later call
finds its launch finished); `online_register.calls` the batches
registered.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch


@dataclass
class StepTimer:
    """Collects per-step wall times; call `.step()` around each iteration.

    `data_wait()` wraps the host-side wait for the next batch, so the
    summary separates the step from input-pipeline starvation.
    """

    skip_first: int = 1  # warm-up steps to exclude from stats
    times: list[float] = field(default_factory=list)
    waits: list[float] = field(default_factory=list)

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    @contextlib.contextmanager
    def data_wait(self):
        t0 = time.perf_counter()
        yield
        self.waits.append(time.perf_counter() - t0)

    def summary(self) -> dict[str, float]:
        steady = self.times[self.skip_first:] or self.times
        arr = np.asarray(steady)
        out = {
            "steps": len(self.times),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "min_s": float(arr.min()),
            "steps_per_sec": float(1.0 / max(arr.mean(), 1e-12)),
        }
        if self.waits:
            w = np.asarray(self.waits[self.skip_first:] or self.waits)
            out["data_wait_mean_s"] = float(w.mean())
            # fraction of the step cadence spent starved for input
            out["data_wait_frac"] = float(
                w.mean() / max(w.mean() + arr.mean(), 1e-12))
        return out

    def report(self, prefix: str = "") -> str:
        s = self.summary()
        msg = (f"{prefix}steps={s['steps']} mean={s['mean_s'] * 1e3:.1f}ms "
               f"p50={s['p50_s'] * 1e3:.1f}ms p95={s['p95_s'] * 1e3:.1f}ms "
               f"({s['steps_per_sec']:.2f} steps/s)")
        if "data_wait_mean_s" in s:
            msg += (f" data_wait={s['data_wait_mean_s'] * 1e3:.1f}ms "
                    f"({100 * s['data_wait_frac']:.1f}%)")
        return msg


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler (host ops, and the card's
    kernels when there is one) and write `<log_dir>/trace.json`, a Chrome
    trace. Yields the profiler, whose `key_averages()` sums the same events
    by name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """Named span inside a `trace` capture; a shared no-op when no profiler
    is on."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN
