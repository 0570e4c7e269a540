"""R1 (`token_matmul`) and R2 (`column_sum`) at the shapes of the B=8 train
step, and that step itself, on the card.

    python fbanet_tpu_torch/tools/measure_reduce.py [shapes] [plans] [step]
        [--batch 8] [--size 160] [--tree DIR] [--device cpu]

- shapes: R1 at the 25 (group, product) shapes of a train step (per
  SwinLayer, K3's dWq (C, C), dWkv (2C, C), dWproj (C, C) and K4's dW1
  (4C, C), dW2 (C, 4C), as (M, N) of `token_matmul(a [T, M], b [T, N])`,
  T = batch x H x W of the group) and R2 at K3's and K4's per-block
  partials of the five groups, plus 800 x 6016 and 800 x 5760. Per shape:
  the kernel's ms (CUDA events), the one-call library counterpart's
  (`torch.mm(a.t(), b, out_dtype=torch.float32)`, `torch.sum(p, 0)`), the
  plain version's, the bound, the error relative to the plain output's
  max, and whether two calls agree bitwise; on the card also the device
  ms of the kernel and of the library call (torch.profiler: no host time,
  no launch gaps). Raises if a relative error exceeds 1e-4 or a repeat
  differs.
- plans (card only): R1's device ms at every train-step shape under each
  candidate plan (64/128-wide tiles x three slice counts), the one
  `token_matmul` picks marked, beside the library call's.
- step: the chip_smoke train configuration (FBANet-64, 14 frames, 160 px,
  bf16, drop_path 0.1, AdamW) at B=`--batch`: ms per step (host clock
  around synchronised steps, median of the last 4 of 5), the device ms of
  R1 and R2 and of the whole step in a torch.profiler trace of one step,
  and the serving forward's ms (no gradient, median of 5 after one).

`--tree DIR` imports `fbanet_tpu_torch` from the checkout at DIR (its
kernels build there), so that one call can alternate two trees: run this
file by its path for that, not with `-m`. `--device cpu` runs the plain
versions on the host (host-clock times; a CPU number is no device time).
Inputs are drawn on the device from fixed seeds. Prints one line per shape
and a JSON line of the results; `main` returns them.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch



def groups(embed: int = 64) -> tuple:
    """(name, H = W of the group at 160 px, C, heads) of the five
    SwinGroups at `embed` with the published heads: FBANet-64's, or at
    embed 32 (the configuration's default) head size 8 at bott, dec0 and
    dec1."""
    return (("enc0", 160, embed, 1), ("enc1", 80, 2 * embed, 2),
            ("bott", 40, 4 * embed, 16), ("dec0", 80, 4 * embed, 16),
            ("dec1", 160, 2 * embed, 8))


GROUPS = groups(64)
WS = 8
# H100 SXM at 700 W (NVIDIA data sheet, dense): bf16 tensor cores, f32 on
# the CUDA cores, device memory
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
REL_TOL = 1e-4  # f32 sums of the same products in another order


def log(msg: str) -> None:
    print(msg, flush=True)


def r1_shapes(batch: int = 8, size: int = 160,
              groups: tuple = GROUPS) -> list[tuple]:
    """(group, product, T, M, N) of every token_matmul of a train step."""
    out = []
    for name, h, c, _heads in groups:
        t = batch * (h * size // 160) ** 2
        for prod, m, n in (("dWq", c, c), ("dWkv", 2 * c, c),
                           ("dWproj", c, c), ("dW1", 4 * c, c),
                           ("dW2", c, 4 * c)):
            out.append((name, prod, t, m, n))
    return out


def r2_shapes(batch: int = 8, size: int = 160,
              groups: tuple = GROUPS) -> list[tuple]:
    """(group, source, R, M) of K3's per-block and K4's per-tile partials
    (the main path's column_sum inputs besides R1's slices; the blocks and
    tiles are their plans'), and two earlier yardsticks: the 8 x 8-tile
    K4's dec1 partial at B=2 (800 x 6016) and 800 x 5760."""
    from fbanet_tpu_torch.ops.attention import (
        _attention_bwd_plan,
        _partial_rows,
    )
    from fbanet_tpu_torch.ops.leff import _leff_bwd_plan

    out = []
    for name, h, c, heads in groups:
        hh = h * size // 160
        out.append((name, "K3", _partial_rows(
            batch * (hh // WS) ** 2, _attention_bwd_plan(batch, hh, hh, c,
                                                         heads)),
                    6 * c + heads * WS ** 4))
        th, tw, _kc, _splits = _leff_bwd_plan(batch, hh, hh, c, 4 * c)
        out.append((name, "K4", batch * (hh // (th or 8)) * (hh // (tw or 8)),
                    3 * c + 11 * 4 * c))
    out.append(("dec1-B2", "K4", 800, 3 * 128 + 11 * 512))
    out.append(("named", "-", 800, 5760))
    return out


def bound_ms(tc_flops: float, f32_flops: float, nbytes: float) -> tuple:
    """(least ms, "operations" or "bytes"): the larger of the operations
    over the peak rate for their type and the bytes over the memory rate."""
    ops = (tc_flops / PEAK_BF16 + f32_flops / PEAK_F32) * 1e3
    mem = nbytes / PEAK_BYTES * 1e3
    return max(ops, mem), "operations" if ops >= mem else "bytes"


def rel_errors(got, ref) -> list[float]:
    """Per output: the first (dx, or a forward's output) relative to
    max(1, max |ref|), every other to its own max |ref| (chip_smoke.py's
    limits for the fused kernels)."""
    out = []
    for i, (a, b) in enumerate(zip(got, ref)):
        scale = float(b.float().abs().max())
        scale = max(1.0, scale) if i == 0 else (scale or 1.0)
        out.append(float((a.float() - b.float()).abs().max()) / scale)
    return out


def shape_sums(kernel: str, rows: list[dict], batch: int) -> dict:
    """ms, device_ms, plain_ms and bound_ms of a fused kernel's per-group
    `rows`, summed (logged)."""
    sums = {k: sum(r[k] for r in rows)
            for k in ("ms", "device_ms", "plain_ms", "bound_ms")}
    sums["bound_by"] = "operations"
    log(f"{kernel} summed over the {len(rows)} groups at B={batch}: {sums}")
    return sums


def time_ms(fn, device: str, iters: int = 10, repeats: int = 3) -> float:
    """Median ms per call over `repeats` runs of `iters` calls after one
    warm-up: CUDA events on the card, the host clock on the CPU."""
    fn()
    per = []
    for _ in range(repeats):
        if device == "cuda":
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            per.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            per.append((time.perf_counter() - t0) * 1e3 / iters)
    return statistics.median(per)


def device_ms(fn, iters: int = 10, keys: tuple = (),
              traces: int = 1) -> float:
    """Device ms per call of `fn`: the kernels' own time in a torch.profiler
    trace of `iters` calls after one warm-up (no launch gaps, no host);
    with `keys`, only the kernels whose name holds one of them. With
    `traces` > 1 the median over that many traces: now and then a trace
    comes back missing some of its kernels, which reads low."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    per, attempts = [], traces + 6
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0.0)
                 for e in prof.key_averages() if "CUDA" in str(e.device_type)
                 and not getattr(e, "is_user_annotation", False)
                 and (not keys or any(k in e.key for k in keys)))
        if us > 0:
            per.append(us / iters / 1e3)
        else:  # now and then a trace has no kernels, a few in a row
            time.sleep(0.1 * (attempt + 1))
        if len(per) == traces:
            return statistics.median(per)
    raise RuntimeError(f"torch.profiler recorded kernels in {len(per)} of "
                       f"{attempts} traces")


def _library_mm(a, b):
    try:
        return torch.mm(a.t(), b, out_dtype=torch.float32)
    except (TypeError, RuntimeError):  # no out_dtype here
        return None


def _row(kind, label, fn, plain, lib, work, device):
    got, again, ref = fn(), fn(), plain()
    err = float((got - ref).abs().max())
    rel = err / max(float(ref.abs().max()), 1e-30)
    repeat = bool(torch.equal(got, again))
    bound, by = bound_ms(*work)
    has_lib = lib() is not None
    row = dict(kernel=kind, shape=label, max_abs_err=err, rel_err=rel,
               bitwise_repeat=repeat,
               ms=time_ms(fn, device), plain_ms=time_ms(plain, device),
               library_ms=time_ms(lib, device) if has_lib else None,
               bound_ms=bound, bound_by=by)
    if device == "cuda":
        row.update(device_ms=device_ms(fn),
                   library_device_ms=device_ms(lib) if has_lib else None)
    log(f"{kind} {label}: " + " ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in row.items() if k not in ("kernel", "shape")))
    return row


def shapes(batch: int = 8, size: int = 160, device: str = "cuda",
           groups: tuple = GROUPS) -> dict:
    """Every R1 and R2 shape of a train step at B=`batch` (of the model
    whose SwinGroups are `groups`): {"R1": rows,
    "R2": rows, "sums": {kernel: {ms, plain_ms, library_ms, bound_ms,
    bound_by}}} (bound_by: what bounds most of the summed bound).
    Raises if a kernel disagrees with its plain version or does not
    repeat."""
    from fbanet_tpu_torch.ops.reduce import column_sum, token_matmul

    gen = torch.Generator(device=device).manual_seed(700)
    res = {"R1": [], "R2": []}
    for group, prod, t, m, n in r1_shapes(batch, size, groups):
        a = torch.randn(t, m, generator=gen, device=device).bfloat16()
        b = torch.randn(t, n, generator=gen, device=device).bfloat16()
        res["R1"].append(_row(
            "R1", f"{group} {prod} T={t} M={m} N={n}",
            lambda: token_matmul(a, b), lambda: a.float().t() @ b.float(),
            lambda: _library_mm(a, b),
            (2 * t * m * n, 0, 2 * t * (m + n) + 4 * m * n), device))
        del a, b
    for group, src, r, m in r2_shapes(batch, size, groups):
        p = torch.randn(r, m, generator=gen, device=device)
        res["R2"].append(_row(
            "R2", f"{group} {src} {r} x {m}", lambda: column_sum(p),
            lambda: p.sum(0), lambda: torch.sum(p, 0),
            (0, r * m, 4 * (r * m + m)), device))
        del p
    bad = [f"{r['kernel']} {r['shape']}" for k in ("R1", "R2") for r in res[k]
           if not (r["rel_err"] <= REL_TOL and r["bitwise_repeat"])]
    res["sums"] = {}
    for k in ("R1", "R2"):
        rows = res[k]
        libs = [r["library_ms"] for r in rows]
        bound = sum(r["bound_ms"] for r in rows)
        by_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
        res["sums"][k] = dict(
            ms=sum(r["ms"] for r in rows),
            plain_ms=sum(r["plain_ms"] for r in rows),
            library_ms=None if None in libs else sum(libs), bound_ms=bound,
            bound_by="bytes" if by_bytes >= bound / 2 else "operations")
        if device == "cuda":
            dev_libs = [r["library_device_ms"] for r in rows]
            res["sums"][k].update(
                device_ms=sum(r["device_ms"] for r in rows),
                library_device_ms=None if None in dev_libs else sum(dev_libs))
        log(f"{k} summed over its {len(rows)} shapes: {res['sums'][k]}")
    if bad:
        raise AssertionError(f"disagrees with its plain version beyond "
                             f"{REL_TOL} or does not repeat: {bad}")
    return res


def plans(batch: int = 8, size: int = 160) -> list[dict]:
    """R1's device ms at every train-step shape under each candidate plan:
    64- and 128-wide tiles, and as many token slices as fill the SMs once,
    half and a quarter of that; the plan `token_matmul` picks is marked.
    Each candidate's error relative to the plain output's max is kept and
    printed where it exceeds 1e-4 (a slice of ~10^5 tokens in one wgmma
    accumulator can)."""
    from fbanet_tpu_torch.ops import reduce

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(701)
    out = []
    for group, prod, t, m, n in r1_shapes(batch, size, groups):
        a = torch.randn(t, m, generator=gen, device="cuda").bfloat16()
        b = torch.randn(t, n, generator=gen, device="cuda").bfloat16()
        ref = a.float().t() @ b.float()
        chosen = reduce._token_matmul_plan(t, m, n, True, sms)
        stages = -(-t // reduce._STAGE)
        rows = []
        for bm in (128, 64):
            for bn in (128, 64):
                if m % bm or n % bn:
                    continue
                most = max(1, sms // ((m // bm) * (n // bn)))
                for s in sorted({most, max(1, most // 2), max(1, most // 4)},
                                reverse=True):
                    chunk = -(-stages // s) * reduce._STAGE
                    plan = (bm, bn, chunk, -(-t // chunk))
                    got = reduce.token_matmul(a, b, plan=plan)
                    rel = float((got - ref).abs().max() / ref.abs().max())
                    rows.append(dict(plan=plan, chosen=plan == chosen,
                                     rel_err=rel,
                                     device_ms=device_ms(
                                         lambda p=plan: reduce.token_matmul(
                                             a, b, plan=p))))
        rows.sort(key=lambda r: r["device_ms"])
        lib = device_ms(lambda: _library_mm(a, b))
        out.append(dict(shape=f"{group} {prod} T={t} M={m} N={n}",
                        library_device_ms=lib, plans=rows))
        log(f"R1 plans {out[-1]['shape']}: library {lib:.4f}; " + "; ".join(
            f"{r['plan']}{'*' if r['chosen'] else ''} {r['device_ms']:.4f}"
            + ("" if r["rel_err"] <= REL_TOL
               else f" (rel err {r['rel_err']:.1e})") for r in rows))
        del a, b, ref
    best = sum(o["plans"][0]["device_ms"] for o in out)
    chosen = sum(r["device_ms"] for o in out for r in o["plans"]
                 if r["chosen"])
    log(f"R1 plans summed over {len(out)} shapes: best {best:.4f}, chosen "
        f"{chosen:.4f}, library {sum(o['library_device_ms'] for o in out):.4f}"
        f" device ms")
    return out


def step(batch: int = 8, device: str = "cuda") -> dict:
    """The B=`batch` train step and serving forward of chip_smoke's
    configuration: {step_ms, step_device_ms, r1_device_ms, r2_device_ms,
    forward_ms}."""
    from fbanet_tpu_torch.config import TrainConfig
    from fbanet_tpu_torch.models import ModelConfig, create_model
    from fbanet_tpu_torch.train import make_optimizer, make_train_step
    from fbanet_tpu_torch.utils.weights import random_state_dict

    cfg = ModelConfig(num_frames=14, img_size=160, embed_dim=64,
                      window_size=8, dtype="bfloat16", drop_path_rate=0.1)
    tcfg = TrainConfig(batch_size=batch, lr_initial=1e-4, optimizer="adamw")
    model = create_model(cfg, device=device, seed=0)
    model.load_state_dict(random_state_dict(model, seed=2), strict=True)
    opt = make_optimizer(model.parameters(), tcfg)
    train_step = make_train_step(model, opt, tcfg)
    gen = torch.Generator(device=device).manual_seed(30)
    lr = torch.rand(batch, 14, 160, 160, 3, generator=gen, device=device)
    hr = torch.rand(batch, 640, 640, 3, generator=gen, device=device)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    times = []
    for _ in range(5):
        sync()
        t0 = time.perf_counter()
        float(train_step(lr, hr, gen, tcfg.lr_initial))
        times.append((time.perf_counter() - t0) * 1e3)
    out = {"step_ms": statistics.median(times[1:])}
    if device == "cuda":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            float(train_step(lr, hr, gen, tcfg.lr_initial))
        total = r1 = r2 = 0.0
        for e in prof.key_averages():
            # kernels only: a user annotation's span (torch's
            # `Optimizer.step#AdamW.step`) covers kernels counted apart
            if "CUDA" not in str(e.device_type) or getattr(
                    e, "is_user_annotation", False):
                continue
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            total += us
            r1 += us * ("token_matmul" in e.key)
            r2 += us * ("column_sum" in e.key)
        out.update(step_device_ms=total / 1e3, r1_device_ms=r1 / 1e3,
                   r2_device_ms=r2 / 1e3)
    fwd = []
    with torch.no_grad():
        for _ in range(6):
            sync()
            t0 = time.perf_counter()
            model(lr)
            sync()
            fwd.append((time.perf_counter() - t0) * 1e3)
    out["forward_ms"] = statistics.median(fwd[1:])
    log(f"step B={batch}: {out}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("modes", nargs="*", default=["shapes", "step"],
                    choices=["shapes", "plans", "step"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=160,
                    help="image size the group resolutions scale with "
                         "(shapes only)")
    ap.add_argument("--tree", default=None,
                    help="import fbanet_tpu_torch from this checkout "
                         "(default: the one holding this file)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.tree and "fbanet_tpu_torch" in sys.modules:
        raise SystemExit("--tree needs this file run by its path, before "
                         "fbanet_tpu_torch is imported")
    if "fbanet_tpu_torch" not in sys.modules:
        sys.path.insert(0, args.tree
                        or str(Path(__file__).resolve().parents[2]))
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("measure_reduce: no CUDA device (--device cpu runs "
                         "the plain versions)")
    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 plain products
    res = {}
    if "shapes" in args.modes:
        res["shapes"] = shapes(args.batch, args.size, args.device)
    if "plans" in args.modes:
        res["plans"] = plans(args.batch, args.size)
    if "step" in args.modes:
        res["step"] = step(args.batch, args.device)
    if args.device == "cuda":
        res["device"] = torch.cuda.get_device_name(0)
    log(json.dumps({k: v for k, v in res.items()}))
    return res


if __name__ == "__main__":
    main()
