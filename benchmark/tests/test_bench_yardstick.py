"""The yardstick's arithmetic: the copied FLOP counts, the Swin work
counts without recomputation, the kernel-name tables against the kernels'
sources, and the trace reduction on a hand-made trace."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from benchmark import flops, judge, manifest, tracing

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "fbanet_tpu_torch" / "csrc"
# the sources of K1-K4 and R1/R2 (the ablation and variant kernels, and the
# warps, are not the Swin operators' main path)
SWIN_SOURCES = ("attention.cu", "attention_wgmma.cuh", "attention_bwd.cuh",
                "attention_bwd_wgmma.cuh", "leff.cu", "leff.cuh",
                "leff_wgmma.cuh", "leff_bwd.cu", "reduce.cu")


def _model(name):
    return manifest.cell({"fbanet64": "fbanet64-train-b16",
                          "fbanet32": "fbanet32-train-b32"}[name]).model


@pytest.mark.parametrize("embed,gflop", [(64, 3319.7), (32, 865.0)])
def test_forward_flops_equal_the_port_tool(embed, gflop):
    from fbanet_tpu_torch.tools.flops_accounting import forward_flops

    mine = flops.forward_flops(8, 160, 14, embed)
    theirs = forward_flops(8, 160, 14, embed)
    assert mine == theirs
    assert round(sum(mine.values()) / 1e9, 1) == gflop
    m = _model("fbanet64" if embed == 64 else "fbanet32")
    assert flops.model_flops(m, 8) == sum(mine.values())


@pytest.mark.parametrize("name", ["fbanet64", "fbanet32"])
def test_swin_layers_are_the_models_twenty(name):
    layers = flops.swin_layers(_model(name), 16)
    assert len(layers) == 20
    assert sum(masked for *_, masked in layers) == 10


@pytest.mark.parametrize("name", ["fbanet64", "fbanet32"])
def test_backward_counts_hold_no_recomputation(name):
    """Each forward product has two gradient products: the backward's
    tensor-core FLOPs are twice the forward's, where the port's tools
    (which count the kernels' recomputed forward) read more."""
    from fbanet_tpu_torch.tools import measure_attention_bwd, measure_leff_bwd

    for b, h, c, heads, ws, masked in flops.swin_layers(_model(name), 8):
        fwd = flops.attention_work(b, h, c, heads, ws, masked, False)
        bwd = flops.attention_work(b, h, c, heads, ws, masked, True)
        assert bwd[0] == 2 * fwd[0] and bwd[1] == fwd[1]
        tool = measure_attention_bwd.work(b, h, c, heads, masked)
        recompute = 6 * b * h * h * c * c + 4 * b * h * h * ws * ws * c
        assert tool[0] - bwd[0] == recompute
        assert bwd[2] == tool[2]  # bytes: inputs and outputs once each
        lf = flops.leff_work(b, h, c, 4.0, False)
        lb = flops.leff_work(b, h, c, 4.0, True)
        assert lb[0] == 2 * lf[0] and lb[1] == 2 * lf[1]
        tool = measure_leff_bwd.work(b, h, c)
        assert tool[0] - lb[0] == 2 * b * h * h * c * 4 * c  # dense1 again
        assert lb[2] == tool[2]


def _globals() -> set[str]:
    names = set()
    for src in SWIN_SOURCES:
        text = (CSRC / src).read_text()
        for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__\s*"
                             r"\([^)]*\)\s*)?(\w+)\s*\(", text):
            names.add(m.group(1))
    return names


def test_kernel_tables_match_the_kernels_sources():
    kernels = _globals()
    assert {"attention_wgmma_kernel", "attention_bwd_wgmma_kernel",
            "leff_wgmma_kernel", "leff_bwd_wgmma_kernel",
            "token_matmul_bf16_kernel", "column_sum_kernel"} <= kernels
    tables = manifest.kernel_tables()
    assert set(tables) == {"swin_fwd", "swin_bwd"}
    for op, patterns in tables.items():
        for p in patterns:
            assert any(p in k for k in kernels), (op, p)
    bf16 = {k for k in kernels if "f32" not in k}
    for k in bf16:
        ops = [op for op, pats in tables.items() if any(p in k for p in pats)]
        assert len(ops) == 1, (k, ops)
    fwd = {k for k in bf16 if any(p in k for p in tables["swin_fwd"])}
    assert fwd == {"attention_wgmma_kernel", "window_attention_bf16_kernel",
                   "leff_wgmma_kernel", "leff_bf16_kernel"}


def _event(name, cat, ts, dur, **kw):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, **kw}


def test_trace_reduction(tmp_path):
    ev = [_event(tracing.SPAN, "user_annotation", 0, 1000),
          _event("void leff_wgmma_kernel<64, 16>(float*)", "kernel", 100, 200),
          _event("attention_bwd_wgmma_kernel<64>", "kernel", 250, 150),
          _event("ncclDevKernel_AllReduce", "kernel", 350, 300),
          _event("Memcpy DtoH", "gpu_memcpy", 800, 50),
          _event("aten::item", "cpu_op", 640, 160),
          _event("bench.step", "user_annotation", 600, 300),
          _event("late kernel", "kernel", 990, 100),
          _event("ncclDevKernel_AllReduce_Sum_u32_RING_LL", "kernel", 700,
                 50)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    t = tracing.reduce_trace(str(path), steps=2)
    assert t.span_s == pytest.approx(1e-3)
    # busy: [100, 650] + [700, 750] + [800, 850] + [990, 1000]
    assert t.busy_s == pytest.approx(660e-6)
    # NCCL [350, 650] under other kernels up to 400: 250 us exposed; the
    # benchmark's own integer agreement at [700, 750] is not DDP's
    assert t.nccl_exposed_s == pytest.approx(250e-6)
    assert t.op_s(["leff_wgmma"]) == pytest.approx(200e-6)
    assert t.device_ops()[0] == ["ncclDevKernel_AllReduce", 300e-6]
    assert t.device_ops()[1][0] == "leff_wgmma_kernel<64, 16>"
    # gaps [0, 100], [650, 700], [750, 800], [850, 990], longest first
    assert t.idle_gaps == [["(no host op)", pytest.approx(140e-6)],
                           ["(no host op)", pytest.approx(100e-6)],
                           ["bench.step > aten::item", pytest.approx(50e-6)],
                           ["bench.step > aten::item", pytest.approx(50e-6)]]


def _record(**kw):
    rec = judge.Record(kind="train", cell="c", model=_model("fbanet64"),
                       batch=16, local_batch=16, chips=1,
                       kernel_tables=manifest.kernel_tables())
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


def test_rooflines_and_readers_find_nothing_where_nothing_ran():
    rec = _record(window_s=10.0, units=40)
    assert manifest.reader("swin_bwd_roofline.train")(rec) is None
    assert manifest.reader("align_ms.serve")(rec) is None
    assert manifest.reader("mfu.serve")(rec) is None
    mfu = manifest.reader("mfu.train")(rec)
    assert mfu == pytest.approx(100 * 3 * 6639.4259456e9 * 4 / 989e12)
    t = tracing.Trace(span_s=1.0, busy_s=0.9, steps=4,
                      kernel_s={"leff_bwd_wgmma_kernel<64>": 0.2})
    rec = _record(window_s=10.0, units=40, trace=t)
    share = manifest.reader("swin_bwd_roofline.train")(rec)
    bound = flops.swin_bound_s(rec.model, 16, True)
    assert share == pytest.approx(100 * bound * 4 / 0.2)
    assert manifest.reader("swin_fwd_roofline.train")(rec) is None
    assert manifest.reader("idle_share.train")(rec) == pytest.approx(10.0)


def test_verdict_wants_every_number_within_its_limit():
    assert judge.verdict({"a": 1.0, "b": 0.5}, {"a": 1.0, "b": 1.0})
    assert not judge.verdict({"a": 1.5, "b": 0.5}, {"a": 1.0, "b": 1.0})
    assert not judge.verdict({"a": float("nan")}, {"a": 1.0})
    assert not judge.verdict({"a": 0.1}, {"a": 1.0, "b": 1.0})
    assert judge.verdict({"a": 0.1, "c": 9.0}, {"a": 1.0})
