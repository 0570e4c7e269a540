"""The reduction of the program's own spans (`benchmark/spans.py`) on
hand-made Chrome traces, and the readers of the metrics built on them and
on the program's counters."""

from __future__ import annotations

import json
import sys
import tempfile

import pytest

from benchmark import judge, manifest, spans, tracing

SPAN_METRICS = ("forward_ms.train", "backward_ms.train", "update_ms.train",
                "register_launches.serve", "register_idle_share.serve",
                "ecc_host_read_ms.serve")


def _event(name, cat, ts, dur, **args):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": 1}
    if args:
        e["args"] = args
    return e


def _launch(ts, corr, name="cudaLaunchKernel", cat="cuda_runtime", tid=1):
    return dict(_event(name, cat, ts, 5, correlation=corr), tid=tid)


def _kernel(ts, dur, corr):
    return _event(f"kernel{corr}", "kernel", ts, dur, correlation=corr)


def _span(name, ts, dur):
    return _event(name, "user_annotation", ts, dur)


# one training step (us): update [10, 50], forward [50, 200], backward
# [200, 400] launching from autograd's thread, update [400, 500]
TRAIN = [
    _span(tracing.SPAN, 0, 1000),
    _span("fbanet.train_step", 10, 490),
    _span("fbanet.update", 10, 40),
    _span("fbanet.forward", 50, 150),
    _span("fbanet.backward", 200, 200),
    _span("fbanet.update", 400, 100),
    # the device's view of a span is not a host span
    _event("fbanet.forward", "gpu_user_annotation", 100, 50),
    _launch(60, 1),
    _kernel(100, 50, 1),
    # launched in the backward, run after its span has closed
    _launch(250, 2, "cudaLaunchKernelExC", tid=2),
    _kernel(420, 100, 2),
    _launch(450, 3, "cuLaunchKernelEx", "cuda_driver"),
    _kernel(530, 30, 3),
    _launch(700, 4),  # under no span of the program
    _kernel(710, 10, 4),
    _kernel(-20, 60, 5),  # launched before the profiler started
    _event("Memcpy DtoH", "gpu_memcpy", 600, 10, correlation=6),
]

# two served batches, ECC's host reads inside the first's registration
SERVE = [
    _span(tracing.SPAN, 0, 1000),
    _span("fbanet.register", 100, 200),
    _span("fbanet.ecc.host_read", 150, 50),
    _span("fbanet.register", 500, 100),
    _launch(110, 1), _kernel(120, 40, 1),
    _launch(160, 2), _kernel(190, 20, 2),  # under the host read
    _launch(510, 3), _kernel(520, 30, 3),
    _launch(700, 4), _kernel(710, 200, 4),  # the model, after registration
]


def _write(path, events):
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_spans_attribute_kernels_by_their_launch(tmp_path):
    got = spans.reduce_spans(_write(tmp_path / "t.json", TRAIN))
    us = pytest.approx

    def check(name, count, host, device, launches, idle):
        s = got[name]
        assert (s.count, s.launches) == (count, launches), name
        assert (s.host_s, s.device_s, s.idle_s) == (
            us(host * 1e-6), us(device * 1e-6), us(idle * 1e-6)), name

    # busy: [0, 40], [100, 150], [420, 520], [530, 560], [600, 610],
    # [710, 720]
    check("fbanet.forward", 1, 150, 50, 1, 100)
    check("fbanet.backward", 1, 200, 100, 1, 200)
    check("fbanet.update", 2, 140, 30, 1, 10 + 20)
    check("fbanet.train_step", 1, 490, 180, 3, 490 - 30 - 50 - 80)
    check(spans.NO_SPAN, 0, 0, 10, 1, 0)
    check(spans.NO_LAUNCH, 0, 0, 40, 1, 0)


def test_spans_hold_the_spans_inside_them(tmp_path):
    got = spans.reduce_spans(_write(tmp_path / "t.json", SERVE))
    reg, read = got["fbanet.register"], got["fbanet.ecc.host_read"]
    assert (reg.count, reg.launches, read.count, read.launches) == (2, 3, 1, 1)
    assert reg.device_s == pytest.approx(90e-6)
    # busy within [100, 300] and [500, 600]: [120, 160], [190, 210],
    # [520, 550]
    assert reg.idle_s == pytest.approx((300 - 90) * 1e-6)
    assert got[spans.NO_SPAN].launches == 1


def test_spans_need_the_sub_window(tmp_path):
    assert spans.reduce_spans(_write(tmp_path / "t.json", TRAIN[1:])) is None


def _record(kind, cell, traced=True):
    rec = judge.Record(kind=kind, cell=cell, model={}, batch=16,
                       local_batch=16, chips=1)
    if traced:
        rec.trace = tracing.Trace(span_s=1e-3, busy_s=5e-4, steps=2)
    return rec


@pytest.fixture
def trace_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def test_readers_of_the_spans(trace_dir):
    _write(trace_dir / "bench_trace_t_r0.json", TRAIN)
    _write(trace_dir / "bench_trace_s.json", SERVE)
    train, serve = _record("train", "t"), _record("serve", "s")
    read = {m: manifest.reader(m) for m in SPAN_METRICS}
    assert read["forward_ms.train"](train) == pytest.approx(0.05)
    assert read["backward_ms.train"](train) == pytest.approx(0.1)
    assert read["update_ms.train"](train) == pytest.approx(0.03)
    assert read["register_launches.serve"](serve) == pytest.approx(1.5)
    assert read["register_idle_share.serve"](serve) == pytest.approx(70.0)
    assert read["ecc_host_read_ms.serve"](serve) == pytest.approx(0.025)
    for m in SPAN_METRICS:  # the other kind of cell reads nothing
        assert read[m](train if m.endswith(".serve") else serve) is None


def test_span_readers_find_nothing_where_nothing_ran(trace_dir):
    """No traced run, a trace without the program's spans (a program that
    opens none), or no trace file: no reading, and nothing raised."""
    bare = [e for e in TRAIN + SERVE if not e["name"].startswith("fbanet.")]
    _write(trace_dir / "bench_trace_t_r0.json", bare)
    _write(trace_dir / "bench_trace_s.json", bare)
    for rec in (_record("train", "t"), _record("serve", "s"),
                _record("train", "t", traced=False),
                _record("serve", "missing")):
        for m in SPAN_METRICS:
            assert manifest.reader(m)(rec) is None


def test_ecc_iterations_reader(monkeypatch):
    from fbanet_tpu_torch.ops import registration as reg

    read = manifest.reader("ecc_iters.serve")
    monkeypatch.setattr(reg.ecc_align, "iterations", 120)
    monkeypatch.setattr(reg.online_register, "calls", 4)
    assert read(_record("serve", "s")) == 30.0
    assert read(_record("train", "t")) is None
    monkeypatch.setattr(reg.online_register, "calls", 0)
    assert read(_record("serve", "s")) is None
    monkeypatch.delattr(reg.ecc_align, "iterations")  # a program without it
    monkeypatch.setattr(reg.online_register, "calls", 4)
    assert read(_record("serve", "s")) is None
    monkeypatch.delitem(sys.modules, reg.__name__)
    assert read(_record("serve", "s")) is None
