#!/usr/bin/env python3
"""Drive the PyTorch port (fbanet_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printed as it runs; any failure raises and the exit code is
non-zero:

1. device: requires CUDA; prints the card's name and power limit.
2. build: compiles the CUDA kernels from fbanet_tpu_torch/csrc with nvcc
   (into build/fbanet_tpu_torch/, at first use) and prints the seconds.
3. kernels: K1 (fused window attention) and K2 (fused LeFF) against their
   plain PyTorch versions on the card at the five SwinGroup shapes of the
   published model (B=2), f32 and bf16, K1 masked and unmasked, with the
   residual. Prints the max abs error and the median times (CUDA events).
4. slice: FBANet-64, 14 frames, 160 px, bf16 compute, every parameter drawn
   from a seed, serves 3 batches of 4 bursts through `eval_step` (ECC
   registration + forward + clamp + PSNR/SSIM). Checks finite [0, 1]
   outputs of shape [4, 640, 640, 3], K1 and K2 launch counts of exactly 20
   per forward, and agreement with the same slice on the plain versions.
   Then times align and forward at B=8 and prints a torch.profiler table
   of one such step by device time.

The line before the last is a JSON object {"kernels": [...]}, preceded by
the nvidia-smi name/power-limit line; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# (H, C, heads) of enc0, enc1, bottleneck, dec0, dec1 at embed 64 / 160 px
MAIN_SHAPES = [(160, 64, 1), (80, 128, 2), (40, 256, 16), (80, 256, 16),
               (160, 128, 8)]
WS = 8
# kernel vs plain limits, relative to max(1, max |plain output|):
# f32 — the same f32 math with sums in another order (~1e-6 observed on
# CPU), 1e-4 leaves room for long reductions; bf16 — both round at the
# same points, so a differing sum order flips an occasional intermediate by
# one bf16 ulp (2^-8 relative), and 3e-2 allows several such flips.
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
SLICE_PSNR_MIN = 40.0  # dB between kernel-path and plain-path predictions


def log(msg: str) -> None:
    print(msg, flush=True)


def make_realistic_bursts(batch, frames, size, seed=0, hr_scale=0):
    """[B, F, S, S, 3] photographic-like bursts in [0, 1] (a copy of
    bench.py:make_realistic_bursts, numpy only): smooth multi-frequency
    sinusoid fields, per-frame subpixel shifts (frame 0 unshifted), sensor
    noise. With `hr_scale` it also returns the noise-free frame-0 field
    sampled on the x`hr_scale` grid, [B, S*s, S*s, 3]: the HR target."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(size, dtype=np.float32),
                         np.arange(size, dtype=np.float32), indexing="ij")
    k = 16
    out = np.empty((batch, frames, size, size, 3), np.float32)
    fields = []
    for b in range(batch):
        freq = rng.uniform(-0.35, 0.35, size=(k, 2)).astype(np.float32)
        phase = rng.uniform(0, 2 * np.pi, size=(k, 3)).astype(np.float32)
        amp = (rng.uniform(0.3, 1.0, size=(k,)) * (2.0 / k)).astype(
            np.float32)
        shifts = rng.uniform(-3.0, 3.0, size=(frames, 2)).astype(np.float32)
        shifts[0] = 0.0
        fields.append((freq, phase, amp))
        for f in range(frames):
            arg = (freq[:, 0, None, None] * (yy + shifts[f, 0])[None]
                   + freq[:, 1, None, None] * (xx + shifts[f, 1])[None])
            for c in range(3):
                field = np.einsum(
                    "k,kij->ij", amp, np.sin(arg + phase[:, c, None, None]))
                out[b, f, :, :, c] = field
    norm = max(1.0, np.abs(out).max())
    out = 0.5 + 0.45 * out / norm
    out += rng.normal(scale=0.01, size=out.shape).astype(np.float32)
    lr = np.clip(out, 0.0, 1.0, dtype=np.float32)
    if not hr_scale:
        return lr
    # HR pixel centres in LR coordinates (half-pixel convention)
    g = (np.arange(size * hr_scale, dtype=np.float32) + 0.5) / hr_scale - 0.5
    hy, hx = np.meshgrid(g, g, indexing="ij")
    hr = np.empty((batch, size * hr_scale, size * hr_scale, 3), np.float32)
    for b, (freq, phase, amp) in enumerate(fields):
        arg = freq[:, 0, None, None] * hy[None] + freq[:, 1, None, None] * hx[None]
        for c in range(3):
            hr[b, :, :, c] = np.einsum(
                "k,kij->ij", amp, np.sin(arg + phase[:, c, None, None]))
    hr = np.clip(0.5 + 0.45 * hr / norm, 0.0, 1.0, dtype=np.float32)
    return lr, hr


def time_ms(fn, iters: int = 10, repeats: int = 3) -> float:
    """Median ms per call of `fn` over `repeats` runs of `iters` calls,
    timed with CUDA events after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / iters)
    return statistics.median(per)


def rel_err(got, ref) -> tuple[float, float]:
    """(max abs error, that error relative to max(1, max |ref|))."""
    err = float((got.float() - ref.float()).abs().max())
    return err, err / max(1.0, float(ref.float().abs().max()))


def _normal_fn(seed: int):
    """nrm(shape, scale): N(0, scale^2) f32 on the card from a seeded numpy
    generator."""
    import numpy as np
    import torch

    r = np.random.default_rng(seed)
    return lambda shape, s: torch.from_numpy(
        (s * r.standard_normal(shape)).astype(np.float32)).cuda()


def attention_case(h, c, heads, dtype, masked, gen_seed):
    """Inputs of one K1 call at a main-path shape, B=2, on the card."""
    import torch

    from fbanet_tpu_torch.models.layers import shift_attention_mask

    nrm = _normal_fn(gen_seed)
    n = WS * WS
    x = nrm((2, h, h, c), 1.0).to(dtype)
    args = dict(ln_scale=1 + nrm((c,), 0.1), ln_bias=nrm((c,), 0.1),
                wq=nrm((c, c), c ** -0.5), bq=nrm((c,), 0.1),
                wkv=nrm((2 * c, c), c ** -0.5), bkv=nrm((2 * c,), 0.1),
                wproj=nrm((c, c), c ** -0.5), bproj=nrm((c,), 0.1),
                bias=nrm((heads, n, n), 0.5),
                mask=(torch.from_numpy(shift_attention_mask(h, h, WS, WS // 2)).cuda()
                      if masked else None))
    return x, args


def leff_case(h, c, dtype, gen_seed):
    """Inputs of one K2 call at a main-path shape, B=2, on the card."""
    nrm = _normal_fn(gen_seed)
    ch = 4 * c
    x = nrm((2, h, h, c), 1.0).to(dtype)
    args = dict(ln_scale=1 + nrm((c,), 0.1), ln_bias=nrm((c,), 0.1),
                w1=nrm((ch, c), c ** -0.5), b1=nrm((ch,), 0.1),
                wdw=nrm((ch, 1, 3, 3), 1 / 3), bdw=nrm((ch,), 0.1),
                w2=nrm((c, ch), ch ** -0.5), b2=nrm((c,), 0.1))
    return x, args


def phase_kernels(shapes) -> dict:
    """Each kernel against its plain version on the card. Returns per-kernel
    {max_abs_err, ms, plain_ms} (times summed over the shapes, bf16)."""
    import torch

    from fbanet_tpu_torch.ops.attention import fused_window_attention_2d
    from fbanet_tpu_torch.ops.leff import fused_leff

    res = {"K1": dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0),
           "K2": dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)}
    failures = []
    for i, (h, c, heads) in enumerate(shapes):
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            for masked in (False, True):
                x, a = attention_case(h, c, heads, dtype, masked, 100 + i)

                def k1(plain=False, x=x, a=a, heads=heads):
                    return fused_window_attention_2d(
                        x, **a, heads=heads, window_size=WS, residual=True,
                        plain=plain)

                got, ref = k1(), k1(plain=True)
                torch.cuda.synchronize()
                err, rel = rel_err(got, ref)
                res["K1"]["max_abs_err"] = max(res["K1"]["max_abs_err"], err)
                line = (f"K1 attention H={h} C={c} heads={heads} {dname} "
                        f"masked={masked}: max_abs_err={err:.3e} rel={rel:.3e}")
                if dname == "bfloat16" and masked:
                    ms, pms = time_ms(k1), time_ms(lambda: k1(plain=True))
                    res["K1"]["ms"] += ms
                    res["K1"]["plain_ms"] += pms
                    line += f" kernel_ms={ms:.4f} plain_ms={pms:.4f}"
                log(line)
                if not (rel <= TOL[dname]) or not torch.isfinite(got).all():
                    failures.append(line)
            x, a = leff_case(h, c, dtype, 200 + i)

            def k2(plain=False, x=x, a=a):
                return fused_leff(x, **a, residual=True, plain=plain)

            got, ref = k2(), k2(plain=True)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            res["K2"]["max_abs_err"] = max(res["K2"]["max_abs_err"], err)
            line = (f"K2 leff H={h} C={c} Ch={4 * c} {dname}: "
                    f"max_abs_err={err:.3e} rel={rel:.3e}")
            if dname == "bfloat16":
                ms, pms = time_ms(k2), time_ms(lambda: k2(plain=True))
                res["K2"]["ms"] += ms
                res["K2"]["plain_ms"] += pms
                line += f" kernel_ms={ms:.4f} plain_ms={pms:.4f}"
            log(line)
            if not (rel <= TOL[dname]) or not torch.isfinite(got).all():
                failures.append(line)
    if failures:
        raise AssertionError("kernel disagrees with its plain version:\n"
                             + "\n".join(failures))
    return res


def phase_slice(card: str) -> dict:
    """The serving path at the published width; ends with a torch.profiler
    table of one B=8 align + forward step by device time. Returns the launch
    counts of the served run."""
    import torch

    from fbanet_tpu_torch.evaluate import eval_step
    from fbanet_tpu_torch.metrics import finite_average, psnr
    from fbanet_tpu_torch.models import ModelConfig, create_model
    from fbanet_tpu_torch.ops.attention import fused_window_attention_2d
    from fbanet_tpu_torch.ops.leff import fused_leff
    from fbanet_tpu_torch.ops.registration import online_register
    from fbanet_tpu_torch.utils.weights import random_state_dict

    cfg = ModelConfig(num_frames=14, img_size=160, embed_dim=64,
                      window_size=8, dtype="bfloat16")
    model = create_model(cfg, device="cuda", seed=0)
    model.load_state_dict(random_state_dict(model, seed=1), strict=True)
    layers = sum(cfg.depths[i] for i in (0, 1, 4, 5, 6)) * 2  # two hourglasses
    requests = []
    for i in range(3):
        lr, hr = make_realistic_bursts(4, 14, 160, seed=10 + i, hr_scale=4)
        requests.append((torch.from_numpy(lr).cuda(), torch.from_numpy(hr).cuda()))
    torch.cuda.synchronize()

    fused_window_attention_2d.launches = 0
    fused_leff.launches = 0
    t0 = time.perf_counter()
    served = [eval_step(model, lr, hr) for lr, hr in requests]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": fused_window_attention_2d.launches,
                "K2": fused_leff.launches}
    log(f"slice: served {len(served)} batches of 4 in {wall:.3f} s "
        f"(first call included); launches {launches}")
    for name, count in launches.items():
        if count != layers * len(served):
            raise AssertionError(f"{name}: {count} launches, expected "
                                 f"{layers} per forward x {len(served)}")

    psnrs, ssims = [], []
    for pred, p, s, _ in served:
        if tuple(pred.shape) != (4, 640, 640, 3):
            raise AssertionError(f"output shape {tuple(pred.shape)}")
        if not torch.isfinite(pred).all() or pred.min() < 0 or pred.max() > 1:
            raise AssertionError("output not finite or outside [0, 1]")
        psnrs += p.tolist()
        ssims += s.tolist()
    log(f"slice: PSNR {finite_average(psnrs):.4f} dB, SSIM "
        f"{finite_average(ssims):.4f} (random weights: a smoke number)")

    # the same first batch through the plain versions on the card
    lr, hr = requests[0]
    pred_plain = eval_step(model, lr, hr, plain=True)[0]
    agree = float(psnr(served[0][0], pred_plain).min())
    with torch.no_grad():
        aligned = online_register(lr)
        raw_k, feat_k = model.forward_with_features(aligned)
        raw_p, feat_p = model.forward_with_features(aligned, plain=True)
    ferr = float((feat_k.float() - feat_p.float()).abs().max()
                 / feat_p.float().abs().max())
    oerr = float((raw_k - raw_p).abs().max())
    sat = float(((raw_p <= 0) | (raw_p >= 1)).float().mean())
    log(f"slice: kernel vs plain path: PSNR {agree:.2f} dB (min over the "
        f"batch, limit {SLICE_PSNR_MIN}); HG2 features max rel err "
        f"{ferr:.3e}; raw output max abs err {oerr:.3e}; "
        f"{100 * sat:.1f}% of plain outputs outside (0, 1)")
    if not agree >= SLICE_PSNR_MIN:
        raise AssertionError(f"kernel path vs plain path PSNR {agree:.2f} dB "
                             f"< {SLICE_PSNR_MIN}")

    # throughput at B=8: align and forward timed apart (host clock around
    # synchronised work; align has one host read per ECC iteration)
    lr8 = torch.from_numpy(make_realistic_bursts(8, 14, 160, seed=20)).cuda()

    def step(plain=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aligned = online_register(lr8)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            out = model(aligned, plain=plain)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if not torch.isfinite(out).all():
            raise AssertionError("non-finite B=8 output")
        return (t1 - t0) * 1e3, (t2 - t1) * 1e3

    step()
    torch.cuda.reset_peak_memory_stats()
    runs = [step() for _ in range(3)]
    align_ms = statistics.median(r[0] for r in runs)
    fwd_ms = statistics.median(r[1] for r in runs)
    peak = torch.cuda.max_memory_allocated() / 2**30
    plain_fwd_ms = statistics.median(step(plain=True)[1] for _ in range(2))
    log(f"slice B=8 on {card}: align {align_ms:.2f} ms/batch, forward "
        f"{fwd_ms:.2f} ms/batch (plain versions {plain_fwd_ms:.2f} ms), "
        f"{8e3 / (align_ms + fwd_ms):.3f} bursts/s align+SR, peak "
        f"{peak:.2f} GiB")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25,
                                  max_name_column_width=60))
    return launches


def main() -> None:
    if not (ROOT / "fbanet_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke.py: fbanet_tpu_torch/ not found next to "
                         "this script; run it from a checkout of the repo")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} x{torch.cuda.device_count()}; {card}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")

    from fbanet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc at first use, then "
        f"cached) -> {lib_path.relative_to(ROOT)}")
    log((lib_path.parent / "build.log").read_text())

    kres = phase_kernels(MAIN_SHAPES)
    launches = phase_slice(card)
    kernels = [
        {"name": "K1 fused window attention", "route": "cuda",
         "source": "fbanet_tpu_torch/csrc/attention.cu",
         "replaces": "fbanet_tpu/ops/attention_pallas.py:250",
         "launches": launches["K1"], **kres["K1"]},
        {"name": "K2 fused LeFF", "route": "cuda",
         "source": "fbanet_tpu_torch/csrc/leff.cu",
         "replaces": "fbanet_tpu/ops/leff_pallas.py:172",
         "launches": launches["K2"], **kres["K2"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
