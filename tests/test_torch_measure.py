"""The measurement slice of the port against the JAX package's tools:
the plain versions of the ablation kernels K9 and K10
(fbanet_tpu_torch.tools.measure_swin_rates.abl_attention / abl_leff) and K11
(fbanet_tpu_torch.tools.measure_bwd.abl_backward) against the scripts'
Pallas ablation kernels in interpret mode (scripts/measure_swin_rates.py,
scripts/measure_bwd.py, loaded from their paths with B = 1), every variant
the tools run, at C = 32, 16 px, 2 heads (4 windows of 64 tokens); the
tools' inputs against the scripts'; `utils.profiling` against the JAX
package's; and a CPU run of each tool's `main` at a tiny group.

Each variant is compared twice: with the scripts' compute dtype set to f32
(the same math: 1e-5 absolute; the backward 1e-5 absolute + 1e-4 relative,
test_torch_attention_bwd.py's limits) and in bf16 (3e-2 of max(1, max |out|)
for outputs and dx, of each parameter gradient's max |grad| for the rest:
both versions round at the same points, and a sum in another order can flip
a rounded intermediate by one ulp; the forward's softmax is normalised
before the AV product in both, as the scripts do).
"""

import contextlib
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, t

from fbanet_tpu.utils import profiling as jax_profiling
from fbanet_tpu_torch.tools import measure_bwd, measure_swin_rates
from fbanet_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
C, RES, HEADS = 32, 16, 2
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.B = 1
    return mod


@pytest.fixture(scope="module")
def rates():
    return _load_script("measure_swin_rates")


@pytest.fixture(scope="module")
def bwd():
    return _load_script("measure_bwd")


def _to_torch(arrays, linear=(), conv=()):
    """JAX-layout arrays -> torch: [in, out] dense kernels transposed to
    Linear layouts, HWIO depthwise kernels to [ch, 1, 3, 3]."""
    out = []
    for i, a in enumerate(arrays):
        a = np.asarray(jnp.asarray(a, jnp.float32))
        if i in linear:
            a = a.T
        elif i in conv:
            a = a.transpose(3, 2, 0, 1)
        out.append(t(np.ascontiguousarray(a)))
    return out


def _close(got, ref, dtype):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    err = np.abs(n(got) - ref).max()
    assert err <= TOL[dtype] * (1.0 if dtype == "float32"
                                else max(1.0, np.abs(ref).max())), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", [v for v, _ in
                                     measure_swin_rates.ATTN_ABLATIONS])
def test_k9_plain_matches_script_kernel(rates, variant, dtype):
    kw = dict(measure_swin_rates.ATTN_ABLATIONS)[variant]
    rates.CDTYPE = jnp.dtype(dtype)
    args = rates._attn_args(C, RES, HEADS)
    ref = rates.abl_attention(C, RES, HEADS, **kw)(*args)
    x, *params = _to_torch(args, linear=(3, 5, 7))
    got = measure_swin_rates.abl_attention(C, RES, HEADS, **kw)(
        x.to(getattr(torch, dtype)), *params)
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", [v for v, _ in
                                     measure_swin_rates.LEFF_ABLATIONS])
def test_k10_plain_matches_script_kernel(rates, variant, dtype):
    kw = dict(measure_swin_rates.LEFF_ABLATIONS)[variant]
    rates.CDTYPE = jnp.dtype(dtype)
    args = rates._leff_args(C, RES)
    ref = rates.abl_leff(C, RES, **kw)(*args)
    x, *params = _to_torch(args, linear=(3, 7), conv=(5,))
    got = measure_swin_rates.abl_leff(C, RES, **kw)(
        x.to(getattr(torch, dtype)), *params)
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", [v for v, _ in measure_bwd.BWD_ABLATIONS])
def test_k11_plain_matches_script_kernel(bwd, variant, dtype):
    kw = dict(measure_bwd.BWD_ABLATIONS)[variant]
    bwd.CDTYPE = jnp.dtype(dtype)
    args = bwd._win_args(C, RES, HEADS)
    fn, _gb = bwd.abl_backward(C, RES, HEADS, **kw)
    ref = fn(*args)
    x, g, *params = _to_torch(args, linear=(4, 6, 8))
    td = getattr(torch, dtype)
    got = measure_bwd.abl_backward(C, RES, HEADS, **kw)(
        x.to(td), g.to(td), *params)
    assert len(got) == len(ref) == 10
    for name, a, b in zip(measure_bwd.NAMES, got, ref):
        b = np.asarray(jnp.asarray(b, jnp.float32))
        if name in ("dwq", "dwkv", "dwproj"):  # JAX [in, out] vs Linear
            b = b.T
        a = n(a)
        assert a.shape == b.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4,
                                       err_msg=name)
        else:
            scale = max(1.0, np.abs(b).max()) if name == "dx" \
                else np.abs(b).max()
            assert np.abs(a - b).max() <= 3e-2 * max(scale, 1e-30), name


def test_tool_inputs_are_the_scripts(rates, bwd):
    """Both tools draw the scripts' numbers (weights transposed to torch
    layouts), so the card and the TPU measure the same inputs."""
    rates.CDTYPE = bwd.CDTYPE = jnp.bfloat16
    for mine, theirs, linear, conv in (
            (measure_swin_rates._attn_args(C, RES, HEADS, batch=1,
                                           device="cpu"),
             rates._attn_args(C, RES, HEADS), (3, 5, 7), ()),
            (measure_swin_rates._leff_args(C, RES, batch=1, device="cpu"),
             rates._leff_args(C, RES), (3, 7), (5,)),
            (measure_bwd._win_args(C, RES, HEADS, batch=1, device="cpu"),
             bwd._win_args(C, RES, HEADS), (4, 6, 8), ())):
        assert len(mine) == len(theirs)
        for a, b in zip(mine, _to_torch(theirs, linear, conv)):
            assert a.shape == b.shape
            assert torch.equal(a.float(), b)


def test_step_timer_matches_jax():
    times = [0.5, 0.012, 0.010, 0.011, 0.013, 0.0105]
    waits = [0.2, 0.001, 0.002, 0.0015, 0.001, 0.003]
    mine = profiling.StepTimer(skip_first=1, times=list(times),
                               waits=list(waits))
    theirs = jax_profiling.StepTimer(skip_first=1, times=list(times),
                                     waits=list(waits))
    assert mine.summary().keys() == theirs.summary().keys()
    for k, v in theirs.summary().items():
        assert mine.summary()[k] == pytest.approx(v, rel=1e-12), k
    assert mine.report("x: ") == theirs.report("x: ")
    timer = profiling.StepTimer(skip_first=0)
    with timer.step():
        with timer.data_wait():
            pass
    assert len(timer.times) == len(timer.waits) == 1


def test_trace_writes_a_chrome_trace_with_spans(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("port-span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "port-span" for e in events)


def test_annotate_reaches_the_profiler_only_when_it_is_on(monkeypatch):
    """With the profiler off a span is the shared no-op and never builds
    a `record_function` (~10 us on the host each); with it on, it does."""
    made = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name) or real(name))
    with profiling.annotate("off"):
        pass
    assert made == []
    assert profiling.annotate("a") is profiling.annotate("b")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("on"):
            pass
    assert made == ["on"]


def _spans(events, name):
    return [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("name") == name]


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_spans_and_bit_equal_steps(tmp_path, grad_accum):
    """Two train steps of a tiny model under `profiling.trace` write
    `fbanet.forward`, `fbanet.backward` and `fbanet.update` inside
    `fbanet.train_step`, with every host operation of the step inside one
    of the three; losses and parameters equal bit for bit those of the
    same steps with the profiler off."""
    from fbanet_tpu_torch import train
    from fbanet_tpu_torch.config import ModelConfig, TrainConfig
    from fbanet_tpu_torch.models import create_model

    mcfg = ModelConfig(num_frames=2, img_size=16, embed_dim=8, window_size=8,
                       heads=(1, 1, 2, 2, 2, 2, 1, 1, 1), dtype="float32")
    tcfg = TrainConfig(batch_size=grad_accum, grad_accum=grad_accum,
                       grad_clip_norm=0.1)
    r = np.random.default_rng(5)
    bursts = [torch.from_numpy(r.uniform(0, 1, (1, 2, 16, 16, 3))
                               .astype(np.float32)) for _ in range(2)]
    hrs = [torch.from_numpy(r.uniform(0, 1, (1, 64, 64, 3))
                            .astype(np.float32)) for _ in range(2)]

    def run(profiled):
        model = create_model(mcfg, device="cpu", seed=3)
        step = train.make_train_step(
            model, train.make_optimizer(model.parameters(), tcfg), tcfg)
        ctx = profiling.trace(str(tmp_path)) if profiled else \
            contextlib.nullcontext()
        losses = []
        with ctx:
            for k in range(2):
                lb, h = ((bursts[0], hrs[0]) if grad_accum == 1
                         else (tuple(bursts), tuple(hrs)))
                losses.append(step(lb, h, torch.Generator().manual_seed(k),
                                   1e-3))
        return losses, [p.detach().clone() for p in model.parameters()]

    loss_on, params_on = run(True)
    loss_off, params_off = run(False)
    assert all(torch.equal(a, b) for a, b in zip(loss_on, loss_off))
    assert all(torch.equal(a, b) for a, b in zip(params_on, params_off))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    steps = _spans(events, "fbanet.train_step")
    phases = {k: _spans(events, f"fbanet.{k}")
              for k in ("forward", "backward", "update")}
    assert len(steps) == 2
    assert len(phases["forward"]) == len(phases["backward"]) == 2 * grad_accum
    assert len(phases["update"]) == 4
    inside = lambda ts, ivs: any(a <= ts <= b for a, b in ivs)  # noqa: E731
    for ivs in phases.values():
        assert all(inside(a, steps) and inside(b, steps) for a, b in ivs)
    held = sum(phases.values(), [])
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "cpu_op" and inside(e["ts"], steps)]
    assert ops and [e["name"] for e in ops if not inside(e["ts"], held)] == []


@pytest.fixture
def tiny_tools(monkeypatch):
    for mod in (measure_swin_rates, measure_bwd):
        monkeypatch.setattr(mod, "B", 1)
        monkeypatch.setattr(mod, "GROUPS",
                            [("enc0", 32, 16, 2), ("dec0", 32, 16, 2)])
    monkeypatch.setattr(measure_swin_rates, "WARMUP", 1)
    monkeypatch.setattr(measure_swin_rates, "ITERS", 2)


def test_rates_tool_runs_on_the_cpu(tiny_tools, capsys):
    ms = measure_swin_rates.main(["attn", "leff", "ablate", "--device",
                                  "cpu", "--only=enc0"])
    out = capsys.readouterr().out
    assert out.startswith("backend=cpu B=1 dtype=bfloat16")
    assert sorted(ms) == sorted(
        ["attn/enc0_c32@16h2", "leff/enc0_c32@16"]
        + [f"{prefix}/enc0 {v}" for prefix in ("abl-attn", "abl-attn-base")
           for v, _ in measure_swin_rates.ATTN_ABLATIONS]
        + [f"{prefix}/enc0 {v}" for prefix in ("abl-leff", "abl-leff-base")
           for v, _ in measure_swin_rates.LEFF_ABLATIONS])
    assert all(np.isfinite(v) and v > 0 for v in ms.values())
    assert "full - nocore:" in out and "full - nodw:" in out
    assert measure_swin_rates.ablation_attention.launches == 0


def test_bwd_tool_runs_on_the_cpu(tiny_tools, capsys):
    ms = measure_bwd.main(["check", "groups", "plainref", "leffabl", "merged",
                           "ablate", "blocks", "--device=cpu"])
    out = capsys.readouterr().out
    assert out.count("vs production rel-err 0.00e+00  OK") == 10
    assert "| kernel | group | fwd ms | f+b ms | bwd ms | bwd GF | " \
           "bwd TF/s | bwd ms @bound |" in out
    assert "mrgbwd/enc0 parity max-rel 0.00e+00" in out
    for name in ("enc0", "dec0"):
        for v, _ in measure_bwd.BWD_ABLATIONS:
            assert f"ablbwd/{name} {v}" in ms
    assert "leffabl/dec0 noconv" in ms and "leffabl/enc0 full" not in ms
    assert all(np.isfinite(v) and v > 0 for v in ms.values())
    assert measure_bwd.ablation_backward.launches == 0


def test_ablation_wrappers_take_one_stage_off_at_a_time():
    x = torch.zeros(1, 16, 16, 32)
    with pytest.raises(ValueError, match="one stage"):
        measure_swin_rates.ablation_attention(
            x, *[None] * 9, heads=2, softmax=False, perhead=False)
    with pytest.raises(ValueError, match="one stage"):
        measure_bwd.ablation_backward(x, x, *[None] * 8, heads=2,
                                      core=False, dxchain=False)
