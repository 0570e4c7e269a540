"""The serving mixes (kind `serve`): a closed loop, one batch in flight, through the
program's `evaluate.eval_step` with online registration, over a pool of
distinct batches, and its check.

A batch is timed from its dispatch until its prediction (into pinned host
memory), per-image PSNR and SSIM are on the host. In a `--trace 1` run
the registration is its own call (`metrics.to_unit_f32`, then
`ops.registration.online_register`, then `eval_step(...,
online_align="none")`, the same work), timed by CUDA events around it.

A few batches of the window, drawn from the seed by reservoir sampling,
keep their prediction on the device; after the window the reference
(float32, TF32 off: ECC, the model, the clamp) computes the same pool
batches in blocks of rows.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from benchmark import device, inputs, judge, kinds, tracing
from benchmark.reference import ecc
from benchmark.reference.model import FBANet as RefModel
from benchmark.reference.precision import F32, Precision

_SAMPLE_KEY = 0x5A3


def pool(cell, seed: int, dev) -> list:
    mix, m = cell.mix, cell.model
    return [inputs.bursts(seed, i, mix["batch"], m["num_frames"],
                          m["img_size"], m["in_channels"], mix["shift_px"],
                          dev) for i in range(mix["pool"])]


class Program:
    """The program's model with weights from the seed, serving the pool."""

    def __init__(self, cell, seed: int, dev, batches: list,
                 fault: str | None = None):
        from fbanet_tpu_torch.config import ModelConfig
        from fbanet_tpu_torch.models.fbanet import FBANet

        m = cell.model
        mcfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in m.items()})
        with torch.device(dev):
            model = FBANet(mcfg)
        model.to(dev).eval()
        model.load_state_dict(inputs.make_weights(
            inputs.parameter_shapes(model), seed, dev), strict=True)
        if fault == "altered":  # one answer altered where it is produced
            forward = model.forward

            def altered(*a, **k):
                out = forward(*a, **k).clone()
                out[0] += 0.05
                return out
            model.forward = altered
        self.model, self.pool = model, batches
        self.align, self.bi = cell.mix["online_align"], \
            cell.config["eval"]["boundary_ignore"]
        lr, hr = batches[0]
        b = lr.shape[0]
        self.host_pred = torch.empty(hr.shape, dtype=torch.float32,
                                     pin_memory=device.is_cuda(dev))
        self.batches = 0
        self.rows = b if fault != "half" else b // 2
        self.sample_batches = cell.mix["sample_batches"]
        self.profile_steps = cell.mix["profile_steps"]
        self.device = dev

    def batch(self, split: bool):
        """Serve the next pool batch; returns (pool index, prediction on
        the device, PSNR and SSIM on the host, align seconds or None)."""
        from fbanet_tpu_torch.evaluate import eval_step
        from fbanet_tpu_torch.metrics import to_unit_f32
        from fbanet_tpu_torch.ops.registration import online_register

        i = self.batches % len(self.pool)
        lr, hr = self.pool[i]
        lr, hr = lr[:self.rows], hr[:self.rows]
        align_s, ev = None, None
        span = torch.profiler.record_function
        if split and self.align != "none" and device.is_cuda(self.device):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            with span("bench.register"):
                lr = online_register(to_unit_f32(lr), self.align)
            ev[1].record()
            with span("bench.eval_step"):
                pred, p, s, _ = eval_step(self.model, lr, hr,
                                          online_align="none",
                                          boundary_ignore=self.bi)
        else:
            with span("bench.eval_step"):
                pred, p, s, _ = eval_step(self.model, lr, hr,
                                          online_align=self.align,
                                          boundary_ignore=self.bi)
        if self.rows < self.host_pred.shape[0]:  # rows left out: no answer
            n = self.host_pred.shape[0] - self.rows
            pred = torch.cat([pred, pred.new_zeros((n,) + pred.shape[1:])])
            p = torch.cat([p, p.new_full((n,), math.nan)])
            s = torch.cat([s, s.new_full((n,), math.nan)])
        with span("bench.to_host"):
            self.host_pred.copy_(pred, non_blocking=True)
            p, s = p.cpu(), s.cpu()
            device.sync(self.device)
        if ev is not None:
            align_s = ev[0].elapsed_time(ev[1]) / 1e3
        self.batches += 1
        return i, pred, p, s, align_s

    def free(self):
        del self.model, self.host_pred
        gc.collect()
        device.empty_cache()


class Reservoir:
    """`k` of the window's batches, uniformly, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, np.random.default_rng([seed, _SAMPLE_KEY])
        self.kept: list = []
        self.seen = 0

    def offer(self, item) -> None:
        j = self.seen
        self.seen += 1
        if j < self.k:
            self.kept.append(self._own(item))
            return
        r = int(self.rng.integers(0, j + 1))
        if r < self.k:
            self.kept[r] = self._own(item)

    @staticmethod
    def _own(item):
        i, pred, p, s, _ = item
        return i, pred.clone(), p.clone(), s.clone()


def warm(prog: Program, split: bool) -> None:
    """Serve the first pool batches through each call the window uses."""
    prog.batch(split=False)
    prog.batch(split=split)


def window(prog: Program, seconds: float, seed: int, sub=None) -> dict:
    """Batches until `seconds` have passed; with `sub`
    (tracing.SubWindow) the last `profile_steps` batches are profiled,
    the window running on until they are done."""
    res = Reservoir(prog.sample_batches, seed)
    lat, align, failed = [], [], 0
    device.sync(prog.device)
    t0 = time.perf_counter()
    while True:
        td = time.perf_counter()
        item = prog.batch(split=sub is not None)
        lat.append(time.perf_counter() - td)
        res.offer(item)
        failed += int((~torch.isfinite(item[2])).sum())
        if item[4] is not None:
            align.append(item[4])
        if sub is not None and sub.active:
            sub.steps += 1
        el = time.perf_counter() - t0
        n = len(lat)
        if (sub is not None and not sub.active
                and el + prog.profile_steps * el / n >= seconds):
            sub.start(n, el)
        elif el >= seconds and (sub is None
                                or sub.steps >= prog.profile_steps):
            break
    device.sync(prog.device)
    return {"seconds": time.perf_counter() - t0, "batches": len(lat),
            "latencies": lat, "align": align, "sample": res.kept,
            "failed": failed}


@torch.no_grad()
def reference(cell, seed: int, dev, sample: list, batches: list,
              prec: Precision = F32) -> list:
    """(prediction,) of the reference on each sampled pool batch: the
    registration, the model and the clamp, in blocks of rows."""
    m, mix = cell.model, cell.mix
    ref = RefModel(m).to(dev).eval()
    ref.load_state_dict(inputs.make_weights(inputs.parameter_shapes(ref),
                                            seed, dev), strict=True)
    out = []
    for i, *_ in sample:
        lr = batches[i][0]
        preds = []
        for a in range(0, lr.shape[0], mix["ref_rows"]):
            x = lr[a:a + mix["ref_rows"]].float() / 255.0
            if mix["online_align"] == "ecc":
                x = ecc.register(x)
            preds.append(torch.clamp(ref(x, prec), 0.0, 1.0))
        out.append((torch.cat(preds),))
    del ref
    gc.collect()
    return out


def execute(cell, seed: int, seconds: float, trace: bool, dev,
            fault: str | None = None, t_start: float = 0.0):
    """One run of a serving cell (`benchmark.kinds`)."""
    batches = pool(cell, seed, dev)
    prog = Program(cell, seed, dev, batches, fault)
    warm(prog, split=trace)
    sub = tracing.SubWindow(cell.name) if trace else None
    device.sync(dev)
    setup_s = time.perf_counter() - t_start
    peak_setup = device.peak(dev)
    device.reset_peak(dev)
    w = window(prog, seconds, seed, sub)
    tr = sub.stop() if sub is not None and sub.active else None
    peak_window = device.peak(dev)
    prog.free()
    rec = kinds.record(cell, "serve", cell.mix["batch"])
    rec.setup_s, rec.window_s, rec.units = setup_s, w["seconds"], w["batches"]
    rec.latencies_s, rec.align_s = w["latencies"], w["align"]
    rec.attempted = w["batches"] * cell.mix["batch"]
    rec.failed = w["failed"]
    rec.trace = tr
    rec.before_trace = sub.before if sub is not None else None
    rec.peak_bytes = max(peak_setup, peak_window)
    rec.peak_window_bytes = peak_window
    if tr is not None:
        rec.busy_s, rec.span_s = [tr.busy_s], [tr.span_s]
    device.reference_precision()
    prog_out = [(pred, p, s) for _, pred, p, s in w["sample"]]
    ref = reference(cell, seed, dev, w["sample"], batches)
    rec.numbers = judge.serve_numbers(prog_out, ref)
    return rec


_CONTROL_SECONDS = 2.0


def readings(cell, seeds, control_seeds, faults, dev, emit, witness=()):
    """The readings of `benchmark.control` (`benchmark.kinds`): a short
    window's sample on every seed, the control (the reference with float8
    products) and each fault on `control_seeds`. No witness is read."""
    from benchmark.reference.precision import FP8

    for seed in sorted(set(seeds) | set(control_seeds)):
        batches = pool(cell, seed, dev)
        # a control seed serves the program too: its sample is compared
        runs = [None] + (list(faults) if seed in control_seeds else [])
        got = {}
        for fault in runs:
            device.program_precision()
            prog = Program(cell, seed, dev, batches, fault)
            warm(prog, split=False)
            got[fault] = window(prog, _CONTROL_SECONDS, seed)["sample"]
            prog.free()
        device.reference_precision()
        cache = {}

        def ref_of(sample, prec=None):
            out = []
            for item in sample:
                key = (item[0], prec)
                if key not in cache:
                    kw = {} if prec is None else {"prec": prec}
                    cache[key] = reference(cell, seed, dev, [item],
                                           batches, **kw)[0]
                out.append(cache[key])
            return out

        for fault, sample in got.items():
            out = [(p, a, s) for _, p, a, s in sample]
            emit(seed, fault or "program",
                 judge.serve_numbers(out, ref_of(sample)))
        if seed in control_seeds:
            emit(seed, "control", judge.serve_numbers(
                ref_of(got[None], FP8), ref_of(got[None])))
        del cache
        device.empty_cache()
