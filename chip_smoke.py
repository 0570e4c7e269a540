#!/usr/bin/env python3
"""Drive the PyTorch port (fbanet_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printed as it runs; any failure raises and the exit code is
non-zero:

1. device: requires CUDA; prints the card's name and power limit.
2. build: compiles the CUDA kernels from fbanet_tpu_torch/csrc with nvcc
   (one process per source, in parallel, into build/fbanet_tpu_torch/, at
   first use) and prints the seconds and nvcc's register/spill report.
3. kernels: K1 (fused window attention) and K2 (fused LeFF) against their
   plain PyTorch versions on the card at the five SwinGroup shapes of the
   published model (B=2), f32 and bf16, K1 masked and unmasked, with the
   residual. Prints the max abs error and the median times (CUDA events).
4. backward: K3 (attention backward) and K4 (LeFF backward), each with the
   fixed-order sums of ops/reduce.py, against their plain backwards at the
   same shapes, f32 and bf16, K3 masked and unmasked, residual on and off:
   every gradient within its limit, and bitwise equal over two runs (K4's
   plan splits the hidden channels at the B=2 bottleneck, so the split
   path is among them; K4 in bf16 also under the WMMA form, which the plan
   keeps for shapes the wgmma form does not take). Then K4 at B=8 at the
   five shapes under its plan (tools/measure_leff_bwd.py): the same
   limits, ms, device ms, bound and the share of it; and the Python model
   of K4's shared memory, which the CPU tests plan with, against the
   kernel's.
5. reduce: the two reduction kernels against their plain versions at
   every shape of the B=8 train step (R1 at its 25 weight-gradient shapes,
   R2 at the K3/K4 partials, 800 x 6016 and 800 x 5760): relative error
   <= 1e-4 and a bitwise repeat at each, kernel / library / plain ms and
   the bound per shape and summed (tools/measure_reduce.py).
6. registration: K5 (homography warp) and K6 (dense-coords warp) against
   their plain versions on the published burst, B=8 x 13 non-reference
   frames of 160 x 160 x 3 f32, nearest and constant mode (K6 at the three
   ECC pyramid sizes, and its general kernel at one channel at 40 px),
   timed beside one grid_sample call each, per call (CUDA events) and on
   the device (torch.profiler). Then
   `align_burst(motion="homography")` at B=8, 3 levels x 25 iterations, on
   bursts made at known homographies: frame 0 bit-identical, corners
   within 0.35 px of the truth and 2e-3 px of the plain path, 1 launch of
   K5 and 75 of K6. Then the alignment CLI's card path, `align_stream`,
   over 4 of those bursts held in memory (no PNG work): each handed back
   in order and overlapped, equal to `align_burst` on it alone, 1 K5 and
   75 K6 launches per burst, ms per burst overlapped and serial. Then
   align ms at B=8 for euclidean, affine and homography (plain path too),
   and a torch.profiler table of one homography align.
7. slice: FBANet-64, 14 frames, 160 px, bf16 compute, every parameter drawn
   from a seed, serves 3 batches of 4 bursts through `eval_step` (ECC
   registration + forward + clamp + PSNR/SSIM). Checks finite [0, 1]
   outputs of shape [4, 640, 640, 3], K1 and K2 launch counts of exactly 20
   per forward, and agreement with the same slice on the plain versions.
   Then times align and forward at B=8 and prints a torch.profiler table
   of one such step by device time.
8. train: the same model with drop_path 0.1 takes 5 AdamW steps at B=8
   through `train.make_train_step` (Charbonnier + 3 GW loss). Checks finite
   losses, that every parameter moved, 20 launches per step of each of
   K1-K4, and every f32 parameter gradient of one B=2 step against the
   plain versions; times the B=8 step against the plain versions and
   prints a torch.profiler table of one step.
9. measure: K1b (window attention on [G, N, C] windows) against its plain
   version at the five shapes (B=2, f32 and bf16, masked and not) and
   bitwise against K1 on the partitioned map; its backward (K3's windowed
   entry) against the plain backward on every gradient plus a bitwise
   repeat. K9, K10 and K11, every variant, against their plain versions on
   the tools' B=8 inputs (bf16, 3e-2 of max(1, |out|)), each `full`
   bitwise against the production K1 / K2 / K3 launch on the same inputs.
   Then the slice's main path: both kernel-measurement tools at B=8
   (`measure_swin_rates attn leff ablate`, `measure_bwd check groups
   plainref leffabl merged ablate`, their tables printed) and K1b forward +
   backward through autograd at the five shapes.
10. variants: K7 (K1's function with its head stage rewritten: loop,
   loop_ln, stack3d, stack3d_ln, lanepack, ln+qkv1, ln+nr2) and K8 (K2's
   with packed-bf16 depthwise and/or GELUs), every variant against its
   plain version on the tool's B=8 inputs at the five shapes (bf16, 3e-2
   of max(1, |out|)), K7 loop_ln bitwise against K1 and K8 with no flag
   bitwise against K2, each K7 core's heads per stage as the kernel
   reports it. Then the slice's main path: `measure_swin_variants check time`
   at B=8 and `profile_components` over every component at the published
   sizes (their tables printed); then mfu_forward / mfu_train
   (`flops_accounting.mfu_fields`) from the slice's forward and the train
   phase's step times.

Each kernel wrapper counts its launches; the counts are set to 0 just
before the registration, the CLI stream, the serving, the training, the
measurement and the variant runs and read just after. The line before the
last is a JSON object {"kernels": [...]} (launches on those runs; error,
times and bound from phases 3-6, 9 and 10; K7 and K9-K11 also per
variant), preceded by the
nvidia-smi name/power-limit line; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
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
# f32 train step, kernels vs plain versions: each parameter gradient within
# 1e-3 of its tensor's max |grad|. The same f32 math with sums in another
# order (the kernels' own limit is 1e-4), carried through 20 layers and the
# convolutions around them, and the loss's clamp, whose gradient switches
# off where a prediction crosses 0 or 1.
TRAIN_GRAD_TOL = 1e-3
# published peaks of one H100 SXM at 700 W (NVIDIA data sheet, dense):
# bf16 tensor cores, f32 on the CUDA cores, device memory
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12


class Bound:
    """The least time the card could take for some calls: per call the
    larger of (tensor-core flops / bf16 peak + CUDA-core flops / f32 peak)
    and (bytes that must move / memory rate), summed over calls."""

    def __init__(self):
        self.ms = self.ops_ms = self.bytes_ms = 0.0

    def add(self, tc_flops: float, f32_flops: float, nbytes: float) -> None:
        t_ops = (tc_flops / PEAK_BF16 + f32_flops / PEAK_F32) * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        self.ms += max(t_ops, t_bytes)
        self.ops_ms += t_ops
        self.bytes_ms += t_bytes

    def fields(self) -> dict:
        return {"bound_ms": self.ms, "bound_by": "operations"
                if self.ops_ms >= self.bytes_ms else "bytes"}


def attention_work(h, c, heads, masked, backward=False, batch=2):
    """(tensor-core flops, CUDA-core flops, bytes) of one K1 (or K3) call
    at B=2, bf16 activations, f32 parameters: each input read once, each
    output written once. Forward: Q, K, V, proj 8 T C^2, logits and AV
    4 T n C. Backward: recompute 6 T C^2 + 4 T n C, do 2 T C^2, dv, dp, dq,
    dk 8 T n C, dy 6 T C^2, dWq, dWkv, dWproj 8 T C^2."""
    t, n = batch * h * h, WS * WS
    params = 4 * (4 * c * c + 6 * c + heads * n * n
                  + (h // WS) ** 2 * n * n * masked)
    if not backward:
        return 8 * t * c * c + 4 * t * n * c, 5 * t * n * heads, \
            4 * t * c + params
    return 22 * t * c * c + 12 * t * n * c, 10 * t * n * heads, \
        6 * t * c + params + 4 * (4 * c * c + 6 * c + heads * n * n)


def leff_work(h, c, backward=False, batch=2):
    """(tensor-core flops, CUDA-core flops, bytes) of one K2 (or K4) call at
    B=2: dense1 and dense2 4 T C Ch, depthwise 18 T Ch; the backward is
    tools/measure_leff_bwd.py's `work`."""
    if backward:
        from fbanet_tpu_torch.tools.measure_leff_bwd import work

        return work(batch, h, c)
    t, ch = batch * h * h, 4 * c
    params = 4 * (2 * c * ch + 11 * ch + 3 * c)
    return 4 * t * c * ch, 18 * t * ch, 4 * t * c + params


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


def make_homography_bursts(batch, frames, size, seed=0, shift=3.0,
                           degrees=0.5, perspective=1e-5):
    """[B, F, S, S, 3] bursts in [0, 1] whose frame f shows the scene of
    frame 0 through a known homography T_f (T_0 = I): pixel (x, y) of frame
    f is make_realistic_bursts' sinusoid field evaluated at T_f (x, y, 1),
    then sensor noise, so no resampling blurs the truth. T_f rotates by up
    to `degrees` about the centre, shifts by up to `shift` px and has
    perspective terms of up to `perspective`. Returns (bursts, T [B, F, 3, 3]); the matrix that aligns
    frame f to frame 0 is inv(T_f)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(size, dtype=np.float64),
                         np.arange(size, dtype=np.float64), indexing="ij")
    pts = np.stack([xx.ravel(), yy.ravel(), np.ones(size * size)])
    c = (size - 1) / 2.0
    k = 16
    out = np.empty((batch, frames, size, size, 3), np.float32)
    truth = np.tile(np.eye(3), (batch, frames, 1, 1))
    for b in range(batch):
        freq = rng.uniform(-0.35, 0.35, size=(k, 2))
        phase = rng.uniform(0, 2 * np.pi, size=(k, 3))
        amp = rng.uniform(0.3, 1.0, size=(k,)) * (2.0 / k)
        for f in range(1, frames):
            th = np.deg2rad(rng.uniform(-degrees, degrees))
            tx, ty = rng.uniform(-shift, shift, size=2)
            co, si = np.cos(th), np.sin(th)
            truth[b, f] = [[co, -si, c - co * c + si * c + tx],
                           [si, co, c - si * c - co * c + ty],
                           [*rng.uniform(-perspective, perspective, size=2),
                            1.0]]
        for f in range(frames):
            q = truth[b, f] @ pts
            qx, qy = (q[0] / q[2]).reshape(size, size), (q[1] / q[2]).reshape(
                size, size)
            arg = freq[:, 0, None, None] * qy[None] + freq[:, 1, None, None] * qx[None]
            for ch in range(3):
                out[b, f, :, :, ch] = np.einsum(
                    "k,kij->ij", amp, np.sin(arg + phase[:, ch, None, None]))
    out = 0.5 + 0.45 * out / max(1.0, np.abs(out).max())
    out += rng.normal(scale=0.01, size=out.shape).astype(np.float32)
    return np.clip(out, 0.0, 1.0, dtype=np.float32), truth.astype(np.float32)


def corner_error(mats, truth, size) -> float:
    """Max px distance between where `mats` and inv(`truth`) [..., 3, 3]
    send the four corners of a size x size frame."""
    import numpy as np

    pts = np.array([[0, 0, 1], [size - 1, 0, 1], [0, size - 1, 1],
                    [size - 1, size - 1, 1]], np.float64).T
    ours = np.asarray(mats, np.float64) @ pts
    ref = np.linalg.inv(np.asarray(truth, np.float64)) @ pts
    return float(np.abs(ours[..., :2, :] / ours[..., 2:, :]
                        - ref[..., :2, :] / ref[..., 2:, :]).max())


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
    bounds = {"K1": Bound(), "K2": Bound()}
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
                    bounds["K1"].add(*attention_work(h, c, heads, masked))
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
                bounds["K2"].add(*leff_work(h, c))
                line += f" kernel_ms={ms:.4f} plain_ms={pms:.4f}"
            log(line)
            if not (rel <= TOL[dname]) or not torch.isfinite(got).all():
                failures.append(line)
    if failures:
        raise AssertionError("kernel disagrees with its plain version:\n"
                             + "\n".join(failures))
    for k in res:
        res[k].update(bounds[k].fields(), library_ms=None)
    return res


# backward (K3, K4) vs plain limits: dx relative to max(1, max |plain dx|),
# each parameter gradient relative to its own max |plain grad|. f32: the
# same f32 math in another sum order (the weight gradients sum 2 x 10^4 to
# 2 x 10^5 token products), 1e-4 as for the forwards. bf16: both versions
# round at the same points (y, q, k, v, p, do, dlogits, dq, dk, dv, dz1,
# h2), so a differing sum order can flip a rounded intermediate by one ulp
# (2^-8 relative), which then moves the sums built on it; 3e-2 as for the
# forwards.
BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _grad_errors(got, ref) -> list[float]:
    """Per-output errors: dx relative to max(1, max |ref|), the rest
    relative to their own max |ref|."""
    errs = [rel_err(got[0], ref[0])[1]]
    for a, b in zip(got[1:], ref[1:]):
        scale = float(b.float().abs().max())
        errs.append(float((a.float() - b.float()).abs().max())
                    / (scale if scale > 0 else 1.0))
    return errs


def phase_backward(shapes) -> dict:
    """K3 and K4 (each followed by the fixed-order sums of ops.reduce)
    against their plain backwards on the card at the five SwinGroup shapes,
    B=2, f32 and bf16, K3 masked and unmasked, residual on and off, K4 in
    bf16 under its plan and under the WMMA form; every gradient, plus
    bitwise repeatability (two kernel runs on the same inputs). Returns per-kernel {max_abs_err, ms, plain_ms} (times summed
    over the shapes: bf16, K3 masked, residual on)."""
    import torch

    from fbanet_tpu_torch.ops import attention, leff

    res = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
           for k in ("K3", "K4")}
    bounds = {"K3": Bound(), "K4": Bound()}
    failures = []
    # K4 plans on the card with the kernel's shared-memory function; the
    # CPU tests plan with its Python model, which must agree with it
    for c in (64, 128, 256):
        for th, tw, kc in leff._K4_FORMS:
            ours = leff._leff_bwd_smem(c, th, tw, kc)
            theirs = leff._kernel_smem(c, th, tw, kc)
            if ours != theirs:
                failures.append(f"K4 shared memory C={c} {th}x{tw} chunk "
                                f"{kc}: kernel {theirs}, plan {ours}")

    def check(name, line, got, again, ref, dname):
        errs = _grad_errors(got, ref)
        abs_err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got, ref))
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], abs_err)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        line += (f": max rel err {max(errs):.3e} (dx {errs[0]:.3e}) "
                 f"max_abs_err {abs_err:.3e} bitwise_repeat={same}")
        if not (max(errs) <= BWD_TOL[dname]) or not same or not finite:
            failures.append(line + f" errs={[f'{e:.2e}' for e in errs]}")
        return line

    for i, (h, c, heads) in enumerate(shapes):
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            for masked in (False, True):
                x, a = attention_case(h, c, heads, dtype, masked, 300 + i)
                g = _normal_fn(400 + i)((2, h, h, c), 1.0).to(dtype)
                p = {k: v for k, v in a.items() if k != "bproj"}
                for residual in (False, True):
                    def k3(x=x, g=g, p=p, heads=heads, residual=residual):
                        return attention.window_attention_bwd(
                            x, g, **p, heads=heads, window_size=WS,
                            residual=residual)

                    def k3_plain(x=x, g=g, p=p, heads=heads,
                                 residual=residual):
                        return attention._plain_bwd_2d(
                            x, g, *p.values(), heads, WS, residual)

                    got, again, ref = k3(), k3(), k3_plain()
                    torch.cuda.synchronize()
                    line = check("K3", f"K3 attention bwd H={h} C={c} "
                                 f"heads={heads} {dname} masked={masked} "
                                 f"residual={residual}", got, again, ref,
                                 dname)
                    if dname == "bfloat16" and masked and residual:
                        ms, pms = time_ms(k3), time_ms(k3_plain)
                        res["K3"]["ms"] += ms
                        res["K3"]["plain_ms"] += pms
                        bounds["K3"].add(*attention_work(
                            h, c, heads, masked, backward=True))
                        line += f" kernel_ms={ms:.4f} plain_ms={pms:.4f}"
                    log(line)
            x, a = leff_case(h, c, dtype, 500 + i)
            g = _normal_fn(600 + i)((2, h, h, c), 1.0).to(dtype)
            p = {k: v for k, v in a.items() if k != "b2"}
            plan = leff._leff_bwd_plan(2, h, h, c, 4 * c,
                                       dname == "bfloat16",
                                       smem=leff._kernel_smem)
            for residual in (False, True):
                def k4(x=x, g=g, p=p, residual=residual):
                    return leff.leff_bwd(x, g, **p, residual=residual)

                def k4_plain(x=x, g=g, p=p, residual=residual):
                    dx, *rest = leff.leff_bwd_reference(x, g, **p)
                    return (dx + g if residual else dx, *rest)

                got, again, ref = k4(), k4(), k4_plain()
                torch.cuda.synchronize()
                line = check("K4", f"K4 leff bwd H={h} C={c} Ch={4 * c} "
                             f"{dname} residual={residual} plan {plan}",
                             got, again, ref, dname)
                if dname == "bfloat16" and residual:
                    ms, pms = time_ms(k4), time_ms(k4_plain)
                    res["K4"]["ms"] += ms
                    res["K4"]["plain_ms"] += pms
                    bounds["K4"].add(*leff_work(h, c, backward=True))
                    line += f" kernel_ms={ms:.4f} plain_ms={pms:.4f}"
                log(line)
                if dname == "bfloat16":
                    # the WMMA form in bf16, which the plan keeps for bf16
                    # shapes the wgmma form does not take
                    def k4_wmma(x=x, g=g, p=p, residual=residual):
                        return leff._leff_bwd_launch(
                            x, g, *p.values(), residual, leff._WMMA_PLAN)

                    got, again = k4_wmma(), k4_wmma()
                    torch.cuda.synchronize()
                    log(check("K4", f"K4 leff bwd H={h} C={c} Ch={4 * c} "
                              f"{dname} residual={residual} plan "
                              f"{leff._WMMA_PLAN} (WMMA form)", got, again,
                              ref, dname))
    if failures:
        raise AssertionError("backward kernel disagrees with its plain "
                             "version or does not repeat:\n"
                             + "\n".join(failures))
    for k in res:
        res[k].update(bounds[k].fields(), library_ms=None)
    # K4 at B=8, each shape under its plan: the same limits, ms, device ms,
    # bound and the share of it (tools/measure_leff_bwd.py)
    from fbanet_tpu_torch.tools import measure_leff_bwd

    b8 = measure_leff_bwd.shapes(batch=8)
    res["K4"]["b8"] = {r["group"]: {k: r[k] for k in (
        "plan", "ms", "device_ms", "bound_ms", "share_of_bound",
        "max_rel_err")} for r in b8["rows"]}
    res["K4"]["b8_sums"] = b8["sums"]
    return res


def phase_reduce() -> dict:
    """The two reduction kernels against their plain versions at every
    main-path shape of the B=8 train step (tools/measure_reduce.py): R1 at
    the 25 (group, product) weight-gradient shapes, bf16, and R2 at K3's
    and K4's per-block partials of the five groups, 800 x 6016 and 800 x
    5760, f32.
    Each shape within 1e-4 of the plain output's max and bitwise equal on
    a repeat (the tool raises otherwise), timed beside the one-call library
    counterpart (torch.mm with an f32 output, torch.sum). Times and bounds
    are summed over each kernel's shapes."""
    from fbanet_tpu_torch.tools import measure_reduce

    got = measure_reduce.shapes(batch=8)
    res = {}
    for name in ("R1", "R2"):
        res[name] = dict(max_abs_err=max(r["max_abs_err"] for r in got[name]),
                         **got["sums"][name])
        log(f"{name} over its {len(got[name])} B=8 shapes: {res[name]}")
    return res


# the registration slice: K5/K6 against their plain versions at the
# published burst (B=8 x 13 non-reference frames of 160 x 160 x 3), K6 at
# the three ECC pyramid sizes; the whole homography align_burst against
# the known truth (corner error <= 0.35 px, tests/test_registration.py's
# limit) and against the plain path (<= 2e-3 px at the corners and on the
# aligned pixels: the same f32 math with sums in another order, carried
# through 75 ECC iterations).
REG_B, REG_F, REG_SIZE, REG_LEVELS, REG_ITERS = 8, 14, 160, 3, 25
REG_TRUTH_PX, REG_PLAIN_PX = 0.35, 2e-3


def warp_matrices(count, size, seed):
    """[count, 3, 3] near-identity inverse-map homographies: shifts of up to
    4 px, rotations of up to 1 degree about the centre, perspective terms of
    ~1e-5; across the frames some positions fall outside every side."""
    import numpy as np

    r = np.random.default_rng(seed)
    th = np.deg2rad(r.uniform(-1.0, 1.0, count))
    t = r.uniform(-4.0, 4.0, (count, 2))
    c = (size - 1) / 2.0
    m = np.zeros((count, 3, 3))
    m[:, 0, 0] = m[:, 1, 1] = np.cos(th)
    m[:, 0, 1], m[:, 1, 0] = -np.sin(th), np.sin(th)
    m[:, 0, 2] = c - np.cos(th) * c + np.sin(th) * c + t[:, 0]
    m[:, 1, 2] = c - np.sin(th) * c - np.cos(th) * c + t[:, 1]
    m[:, 2, :2] = r.uniform(-1e-5, 1e-5, (count, 2))
    m[:, 2, 2] = 1.0
    return m.astype(np.float32)


def _grid(cy, cx, h, w):
    """grid_sample's [-1, 1] (x, y) grid of pixel positions, corners
    aligned."""
    import torch

    return torch.stack([2 * cx / (w - 1) - 1, 2 * cy / (h - 1) - 1], -1)


def phase_registration(card: str) -> tuple[dict, dict]:
    """K5 and K6 against their plain versions, then the non-translation
    align_burst at the published width. Returns (per-kernel results, the
    launch counts of the homography align_burst on the kernel path)."""
    import numpy as np
    import torch
    import torch.nn.functional as tf

    from fbanet_tpu_torch.metrics import psnr
    from fbanet_tpu_torch.ops import warp_kernels as wk
    from fbanet_tpu_torch.ops.registration import _scale_matrix, align_burst
    from fbanet_tpu_torch.ops.warp import homography_coords
    from fbanet_tpu_torch.tools.measure_reduce import device_ms

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("ECC's normal equations need full f32 matrix "
                             "products; allow_tf32 is on")
    frames = torch.from_numpy(make_realistic_bursts(
        REG_B, REG_F, REG_SIZE, seed=50)[:, 1:].reshape(
            -1, REG_SIZE, REG_SIZE, 3).copy()).cuda()
    n = frames.shape[0]
    mats = torch.from_numpy(warp_matrices(n, REG_SIZE, seed=51)).cuda()
    res = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                   device_ms=0.0, library_device_ms=0.0)
           for k in ("K5", "K6")}
    bounds = {"K5": Bound(), "K6": Bound()}
    failures = []

    def compare(name, line, fn):
        got, ref = fn(False), fn(True)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        line += f": max_abs_err={err:.3e} rel={rel:.3e}"
        if not (rel <= TOL["float32"]) or not torch.isfinite(got).all():
            failures.append(line)
        return line

    def timed(name, line, fn, lib, work):
        """Times of the kernel, its plain version and the library call
        (grid_sample computes nearest mode's function, channels-first):
        per call (CUDA events around 10 calls, host costs included) and
        on the device (torch.profiler, the kernels alone)."""
        ms, pms, lms = time_ms(lambda: fn(False)), time_ms(lambda: fn(True)), \
            time_ms(lib)
        dms, ldms = device_ms(lambda: fn(False)), device_ms(lib)
        res[name]["ms"] += ms
        res[name]["plain_ms"] += pms
        res[name]["library_ms"] += lms
        res[name]["device_ms"] += dms
        res[name]["library_device_ms"] += ldms
        bounds[name].add(0, *work)
        b = Bound()
        b.add(0, *work)
        lib_err = float((lib().permute(0, 2, 3, 1) - fn(True)).abs().max())
        return (line + f" kernel_ms={ms:.4f} device_ms={dms:.4f} "
                f"plain_ms={pms:.4f} grid_sample_ms={lms:.4f} "
                f"grid_sample_device_ms={ldms:.4f} bound_ms={b.ms:.4f} "
                f"(device share of bound {b.ms / dms:.3f}; grid_sample vs "
                f"plain {lib_err:.2e})")

    h = w = REG_SIZE
    for mode in ("nearest", "constant"):
        def k5(plain, mode=mode):
            return wk.warp_burst_bilinear(frames, mats, mode=mode, cval=0.5,
                                          plain=plain)
        line = compare("K5", f"K5 warp_burst_bilinear {n}x{h}x{w}x3 {mode}",
                       k5)
        if mode == "nearest":
            co = homography_coords(mats, h, w)
            inp = frames.permute(0, 3, 1, 2).contiguous()
            grid = _grid(co[..., 0], co[..., 1], h, w)

            def lib5():
                return tf.grid_sample(inp, grid, mode="bilinear",
                                      padding_mode="border",
                                      align_corners=True)
            # per pixel: positions 12 + divide 2, blend 6 per channel
            line = timed("K5", line, k5, lib5,
                         (n * h * w * (14 + 6 * 3),
                          2 * frames.numel() * 4 + mats.numel() * 4))
        log(line)
    # K6 at the three pyramid sizes, on positions of the same homographies
    for lvl in range(REG_LEVELS):
        s = REG_SIZE >> lvl
        fr = frames[:, ::1 << lvl, ::1 << lvl].contiguous()
        coords = homography_coords(_scale_matrix(mats, 0.5 ** lvl), s, s)
        for mode in ("nearest", "constant"):
            def k6(plain, mode=mode, fr=fr, coords=coords):
                return wk.warp_burst_coords(fr, coords, mode=mode, cval=0.5,
                                            plain=plain)
            line = compare("K6", f"K6 warp_burst_coords {n}x{s}x{s}x3 {mode}",
                           k6)
            if mode == "nearest":
                inp = fr.permute(0, 3, 1, 2).contiguous()
                grid = _grid(coords[..., 0], coords[..., 1], s, s)

                def lib6(inp=inp, grid=grid):
                    return tf.grid_sample(inp, grid, mode="bilinear",
                                          padding_mode="border",
                                          align_corners=True)
                line = timed("K6", line, k6, lib6,
                             (n * s * s * 6 * 3,
                              (2 * fr.numel() + coords.numel()) * 4))
            log(line)
    # K6's general kernel (any C; the C = 3 kernel serves the ECC stack) at
    # one channel, on the last level's positions
    fr1 = fr[..., :1].contiguous()
    for mode in ("nearest", "constant"):
        def k6c1(plain, mode=mode):
            return wk.warp_burst_coords(fr1, coords, mode=mode, cval=0.5,
                                        plain=plain)
        log(compare("K6", f"K6 warp_burst_coords {n}x{s}x{s}x1 {mode}",
                    k6c1))
    if failures:
        raise AssertionError("warp kernel disagrees with its plain "
                             "version:\n" + "\n".join(failures))
    for k in res:
        res[k].update(bounds[k].fields())
    del frames, mats, fr1

    # the slice: homography align_burst on bursts with known homographies
    bursts, truth = make_homography_bursts(REG_B, REG_F, REG_SIZE, seed=40)
    x = torch.from_numpy(bursts).cuda()
    kw = dict(levels=REG_LEVELS, iters_per_level=REG_ITERS, eps=0.0)
    torch.cuda.synchronize()
    wk.warp_burst_bilinear.launches = wk.warp_burst_coords.launches = 0
    aligned, m, rhos = align_burst(x, motion="homography", **kw)
    torch.cuda.synchronize()
    launches = {"K5": wk.warp_burst_bilinear.launches,
                "K6": wk.warp_burst_coords.launches}
    aligned_p, m_p, _ = align_burst(x, motion="homography", plain=True, **kw)
    torch.cuda.synchronize()
    m, m_p = m.cpu().numpy(), m_p.cpu().numpy()
    truth_px = corner_error(m[:, 1:], truth[:, 1:], REG_SIZE)
    plain_px = corner_error(m, np.linalg.inv(m_p), REG_SIZE)
    pix = float((aligned - aligned_p).abs().max())
    crop = slice(16, -16)
    before = float(psnr(x[:, 1:, crop, crop], x[:, :1, crop, crop]).mean())
    after = float(psnr(aligned[:, 1:, crop, crop], x[:, :1, crop, crop]).mean())
    log(f"registration: homography align_burst B={REG_B} F={REG_F} "
        f"{REG_SIZE}px, {REG_LEVELS}x{REG_ITERS} iterations: launches "
        f"{launches}; corners vs truth {truth_px:.4f} px (limit "
        f"{REG_TRUTH_PX}), kernel vs plain {plain_px:.3e} px and "
        f"{pix:.3e} on the pixels (limit {REG_PLAIN_PX}); min rho "
        f"{float(rhos.min()):.5f}; interior PSNR to frame 0 {before:.2f} -> "
        f"{after:.2f} dB")
    if launches != {"K5": 1, "K6": REG_LEVELS * REG_ITERS}:
        raise AssertionError(f"registration launches {launches}, expected "
                             f"K5 1 and K6 {REG_LEVELS * REG_ITERS}")
    if not torch.equal(aligned[:, 0], x[:, 0]):
        raise AssertionError("frame 0 is not bit-identical")
    if not (truth_px <= REG_TRUTH_PX and plain_px <= REG_PLAIN_PX
            and pix <= REG_PLAIN_PX and after > before):
        raise AssertionError("homography registration is off its truth or "
                             "its plain path, or did not align")

    stream_launches = phase_align_stream(card, bursts, truth, kw)
    launches = {k: launches[k] + stream_launches[k] for k in launches}

    def align_ms(motion, plain=False):
        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            align_burst(x, motion=motion, plain=plain, **kw)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3
        run()
        return statistics.median(run() for _ in range(3))

    times = {mo: align_ms(mo) for mo in ("euclidean", "affine", "homography")}
    times["homography plain"] = align_ms("homography", plain=True)
    log(f"registration B={REG_B} on {card}: align ms "
        f"{ {k: round(v, 3) for k, v in times.items()} }")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        align_burst(x, motion="homography", **kw)
        torch.cuda.synchronize()
    events = prof.key_averages()
    log(events.table(sort_by="cuda_time_total", row_limit=15,
                     max_name_column_width=60))
    total, ours = _device_ms(events)
    log(f"registration homography B={REG_B} profile: device {total:.3f} ms "
        f"of {times['homography']:.3f} ms, port kernels (ms) "
        f"{ {k: round(v, 3) for k, v in ours.items()} }")
    # the ECC products by operand shape: one row per pyramid level and
    # product (g^T g, and the g^T-vector products)
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key == "aten::bmm":
            us = getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0.0))
            log(f"registration profile aten::bmm {e.input_shapes}: "
                f"{e.count} calls, device {us / 1e3:.3f} ms")
    return res, launches


# the CLI's card path: align_stream over CLI_BURSTS in-memory bursts (no
# PNG work), with a fixed host wait of CLI_HOST_MS as each burst is drawn,
# standing in for its decode (a stand-in, not a measured decode time)
CLI_BURSTS, CLI_HOST_MS = 4, 20.0


def phase_align_stream(card: str, bursts, truth, kw) -> dict:
    """Drive `align.align_stream` (what `python -m fbanet_tpu_torch.align`
    runs per burst directory) on the card: each burst handed back in order,
    equal within REG_PLAIN_PX to `align_burst` on it alone and within
    REG_TRUTH_PX of the truth, through K5 once and K6 75 times per burst;
    then times overlapped against serial. Returns the launch counts of the
    overlapped run."""
    import numpy as np
    import torch

    from fbanet_tpu_torch.align import align_stream
    from fbanet_tpu_torch.ops import warp_kernels as wk
    from fbanet_tpu_torch.ops.registration import align_burst

    if not torch.ones(2, device="cuda").to("cpu", non_blocking=True).is_pinned():
        raise AssertionError("a non-blocking copy from the card did not land "
                             "in pinned memory")
    kw = dict(kw, motion="homography")
    got, order = {}, []

    def draw():
        for i in range(CLI_BURSTS):
            time.sleep(CLI_HOST_MS / 1e3)
            order.append(("draw", i))
            yield i, bursts[i]

    def on_aligned(key, frames, aligned, rhos, seconds):
        order.append(("back", key))
        got[key] = aligned

    torch.cuda.synchronize()
    wk.warp_burst_bilinear.launches = wk.warp_burst_coords.launches = 0
    n = align_stream(draw(), on_aligned, **kw)
    torch.cuda.synchronize()
    launches = {"K5": wk.warp_burst_bilinear.launches,
                "K6": wk.warp_burst_coords.launches}
    alone = [align_burst(torch.from_numpy(bursts[i]).cuda(), **kw)
             for i in range(CLI_BURSTS)]
    err = max(float(np.abs(got[i] - a[0].cpu().numpy()).max())
              for i, a in enumerate(alone))
    mats = np.stack([a[1].cpu().numpy() for a in alone])
    truth_px = corner_error(mats[:, 1:], truth[:CLI_BURSTS, 1:], REG_SIZE)
    expect = [("back", i) for i in range(CLI_BURSTS)]
    backs = [e for e in order if e[0] == "back"]
    overlapped = all(order.index(("back", i)) > order.index(("draw", i + 1))
                     for i in range(CLI_BURSTS - 1))

    def run(overlap):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        align_stream(draw(), lambda *a: None, overlap=overlap, **kw)
        return (time.perf_counter() - t0) * 1e3 / CLI_BURSTS

    run(True)
    ms = {name: statistics.median(run(ov) for _ in range(3))
          for name, ov in (("overlapped", True), ("serial", False))}
    log(f"align_stream: {n} homography bursts of {REG_F} x {REG_SIZE}px "
        f"on {card}: launches {launches}; vs align_burst alone {err:.3e} "
        f"(limit {REG_PLAIN_PX}); corners vs truth {truth_px:.4f} px; "
        f"handed back in order {backs == expect}, burst N after N+1 was "
        f"drawn {overlapped}; ms per burst with a {CLI_HOST_MS} ms host "
        f"stand-in { {k: round(v, 3) for k, v in ms.items()} }")
    per = REG_LEVELS * REG_ITERS
    if launches != {"K5": CLI_BURSTS, "K6": CLI_BURSTS * per}:
        raise AssertionError(f"align_stream launches {launches}, expected K5 "
                             f"{CLI_BURSTS} and K6 {CLI_BURSTS * per}")
    if not (n == CLI_BURSTS and backs == expect and overlapped
            and err <= REG_PLAIN_PX and truth_px <= REG_TRUTH_PX):
        raise AssertionError("align_stream lost a burst, its order or its "
                             "overlap, or disagrees with align_burst")
    return launches


def phase_slice(card: str) -> tuple[dict, float]:
    """The serving path at the published width; ends with a torch.profiler
    table of one B=8 align + forward step by device time. Returns the launch
    counts of the served run and the B=8 forward's ms."""
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
    return launches, fwd_ms


# the measurement slice: K1b at B=2 (as K1), the tools and their ablation
# kernels at the scripts' B=8
MEASURE_B = 8
RATES_MODES = ["attn", "leff", "ablate"]
BWD_MODES = ["check", "groups", "plainref", "leffabl", "merged", "ablate"]


def ablation_work(kernel, variant, h, c, heads):
    """(tensor-core flops, CUDA-core flops, bytes) of one K9 / K10 / K11
    call at the tools' B=8: the unablated kernel's work (attention_work /
    leff_work, mask-free) less what the variant no longer does. K9: nocore
    drops the logits and AV products (4 T n C) and the softmax for 2 T C
    adds; nosoftmax keeps one multiply per logit. K10: nodw drops the
    depthwise taps (GELU is counted in neither). K11: norecompute drops the
    q/k/v products (6 T C^2), nodx the dy product (6 T C^2), nowgrads the
    weight-gradient products (8 T C^2) and the gradients' bytes, nocore the
    core products (12 T n C) and its softmax work; nodsoftmax keeps one
    multiply per logit of the softmax backward's five."""
    t, n = MEASURE_B * h * h, WS * WS
    if kernel == "K10":
        tc, f32, nbytes = leff_work(h, c, batch=MEASURE_B)
        return tc, 0 if variant == "nodw" else f32, nbytes
    if kernel == "K9":
        tc, f32, nbytes = attention_work(h, c, heads, False, batch=MEASURE_B)
        if variant == "nocore":
            return tc - 4 * t * n * c, 2 * t * c, nbytes
        if variant == "nosoftmax":
            return tc, t * n * heads, nbytes
        return tc, f32, nbytes
    tc, f32, nbytes = attention_work(h, c, heads, False, backward=True,
                                     batch=MEASURE_B)
    if variant in ("norecompute", "nodx"):
        tc -= 6 * t * c * c
    elif variant == "nowgrads":
        tc -= 8 * t * c * c
        nbytes -= 4 * (4 * c * c + 6 * c + heads * n * n)
    elif variant == "nocore":
        tc, f32 = tc - 12 * t * n * c, 0
    elif variant == "nodsoftmax":
        f32 = 6 * t * n * heads
    return tc, f32, nbytes


def phase_measure(card: str) -> tuple[dict, dict]:
    """The measurement slice. K1b (`fused_window_attention`) against its
    plain version and against K1 on the partitioned map (bitwise), and its
    backward (K3's windowed entry) against the plain backward on every
    gradient plus a bitwise repeat, at the five SwinGroup shapes, B=2, f32
    and bf16, masked and not. K9, K10 and K11, every variant, against their
    plain versions at the tools' B=8 inputs, bf16, and each `full` variant
    bitwise against the production K1 / K2 / K3 launch on the same inputs.
    Then the main path: both tools' modes at B=8 and K1b forward + backward
    through autograd at the five shapes, with the counts set to 0 just
    before and read just after. Returns (per-kernel results, launches)."""
    import torch

    from fbanet_tpu_torch.ops import attention
    from fbanet_tpu_torch.ops.attention import (
        fused_window_attention,
        fused_window_attention_2d,
        window_partition,
    )
    from fbanet_tpu_torch.ops.leff import fused_leff
    from fbanet_tpu_torch.tools import measure_bwd as mb
    from fbanet_tpu_torch.tools import measure_swin_rates as mr

    failures = []
    k1b = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, backward_ms=0.0,
               backward_plain_ms=0.0)
    k1b_bound = Bound()

    def gradient_check(line, got, again, ref, dname):
        errs = _grad_errors(got, ref)
        abs_err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got, ref))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        line += (f": max rel err {max(errs):.3e} (dx {errs[0]:.3e}) "
                 f"max_abs_err {abs_err:.3e} bitwise_repeat={same}")
        if not (max(errs) <= BWD_TOL[dname]) or not same or not finite:
            failures.append(line)
        return line, abs_err

    for i, (h, c, heads) in enumerate(MAIN_SHAPES):
        nw = (h // WS) ** 2
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            for masked in (False, True):
                x4, a = attention_case(h, c, heads, dtype, masked, 800 + i)
                xw = window_partition(x4, WS).contiguous()

                def fwd(plain=False, xw=xw, a=a, heads=heads, nw=nw):
                    return fused_window_attention(
                        xw, **a, heads=heads, windows_per_image=nw,
                        plain=plain)

                got, ref = fwd(), fwd(True)
                on_map = window_partition(fused_window_attention_2d(
                    x4, **a, heads=heads, window_size=WS), WS)
                torch.cuda.synchronize()
                err, rel = rel_err(got, ref)
                same = torch.equal(got, on_map)
                k1b["max_abs_err"] = max(k1b["max_abs_err"], err)
                line = (f"K1b windows G={xw.shape[0]} C={c} heads={heads} "
                        f"{dname} masked={masked}: max_abs_err={err:.3e} "
                        f"rel={rel:.3e} equal_to_K1_on_the_map={same}")
                if dname == "bfloat16" and masked:
                    ms, pms = time_ms(fwd), time_ms(lambda: fwd(True))
                    k1b["ms"] += ms
                    k1b["plain_ms"] += pms
                    k1b_bound.add(*attention_work(h, c, heads, masked))
                    line += f" kernel_ms={ms:.4f} plain_ms={pms:.4f}"
                log(line)
                if not (rel <= TOL[dname]) or not same \
                        or not torch.isfinite(got).all():
                    failures.append(line)

                gw = _normal_fn(900 + i)(tuple(xw.shape), 1.0).to(dtype)
                p = {k: v for k, v in a.items() if k != "bproj"}

                def k3w(xw=xw, gw=gw, p=p, heads=heads, nw=nw):
                    return attention.window_attention_bwd_windows(
                        xw, gw, **p, heads=heads, windows_per_image=nw)

                def k3w_plain(xw=xw, gw=gw, p=p, heads=heads):
                    return attention.window_attention_bwd_reference(
                        xw, gw, **p, heads=heads)

                got, again, ref = k3w(), k3w(), k3w_plain()
                torch.cuda.synchronize()
                line, abs_err = gradient_check(
                    f"K1b backward (K3 on windows) G={xw.shape[0]} C={c} "
                    f"heads={heads} {dname} masked={masked}", got, again,
                    ref, dname)
                if dname == "bfloat16" and masked:
                    ms, pms = time_ms(k3w), time_ms(k3w_plain)
                    k1b["backward_ms"] += ms
                    k1b["backward_plain_ms"] += pms
                    line += f" kernel_ms={ms:.4f} plain_ms={pms:.4f}"
                log(line)
    k1b.update(k1b_bound.fields(), library_ms=None)

    # K9, K10, K11 against their plain versions at the tools' B=8 inputs;
    # each `full` bitwise against the production kernel
    abl = {k: dict(max_abs_err=0.0, plain_ms=0.0, variants={})
           for k in ("K9", "K10", "K11")}
    bounds = {}
    for name, c, res, heads in mr.GROUPS:
        cases = (
            ("K9", mr.ATTN_ABLATIONS,
             mr._attn_args(c, res, heads, batch=MEASURE_B),
             lambda kw, c=c, res=res, heads=heads:
             mr.abl_attention(c, res, heads, **kw)),
            ("K10", mr.LEFF_ABLATIONS, mr._leff_args(c, res, batch=MEASURE_B),
             lambda kw, c=c, res=res: mr.abl_leff(c, res, **kw)),
            ("K11", mb.BWD_ABLATIONS,
             mb._win_args(c, res, heads, batch=MEASURE_B),
             lambda kw, c=c, res=res, heads=heads:
             mb.abl_backward(c, res, heads, **kw)))
        for kernel, table, args, make in cases:
            for vname, kw in table:
                fn = make(kw)
                got, ref = fn(*args), fn(*args, plain=True)
                torch.cuda.synchronize()
                if kernel == "K11":
                    errs = _grad_errors(got, ref)
                    rel = max(errs)
                    err = max(float((a.float() - b.float()).abs().max())
                              for a, b in zip(got, ref))
                    finite = all(bool(torch.isfinite(a).all()) for a in got)
                else:
                    err, rel = rel_err(got, ref)
                    finite = bool(torch.isfinite(got).all())
                entry = abl[kernel]["variants"].setdefault(
                    vname, dict(max_abs_err=0.0))
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                abl[kernel]["max_abs_err"] = max(abl[kernel]["max_abs_err"],
                                                 err)
                bounds.setdefault((kernel, vname), Bound()).add(
                    *ablation_work(kernel, vname, res, c, heads))
                line = (f"{kernel} {vname} {name} c{c}@{res} B={MEASURE_B} "
                        f"bf16: max_abs_err={err:.3e} rel={rel:.3e}")
                if vname == "full":
                    pms = time_ms(lambda fn=fn: fn(*args, plain=True),
                                  iters=3, repeats=3)
                    abl[kernel]["plain_ms"] += pms
                    line += f" plain_ms={pms:.4f}"
                    if kernel == "K9":
                        prod = fused_window_attention_2d(
                            *args, None, heads=heads, window_size=WS)
                        same = torch.equal(got, prod)
                    elif kernel == "K10":
                        same = torch.equal(got, fused_leff(*args))
                    else:  # K3 on the map of one window per image
                        x, g, *params = args
                        prod = attention.window_attention_bwd(
                            x.view(-1, WS, WS, c), g.view(-1, WS, WS, c),
                            *params, None, heads=heads, window_size=WS)
                        same = all(torch.equal(a.reshape(b.shape), b)
                                   for a, b in zip(prod, got))
                    line += f" bitwise_equal_to_production={same}"
                    if not same:
                        failures.append(line)
                log(line)
                if not (rel <= TOL["bfloat16"]) or not finite:
                    failures.append(line)
    if failures:
        raise AssertionError("measurement slice disagrees with its plain "
                             "versions or production kernels:\n"
                             + "\n".join(failures))

    # the main path: both tools at B=8, K1b forward + backward by autograd
    counters = _counters()
    torch.cuda.synchronize()
    for cnt in counters.values():
        cnt.launches = 0
    t0 = time.perf_counter()
    rates = mr.main(RATES_MODES)
    bwd = mb.main(BWD_MODES)
    for i, (h, c, heads) in enumerate(MAIN_SHAPES):
        x4, a = attention_case(h, c, heads, torch.bfloat16, True, 950 + i)
        a = dict(a)
        mask = a.pop("mask")
        xw = window_partition(
            x4.repeat(MEASURE_B // 2, 1, 1, 1), WS).contiguous()
        sums = mb.grad_wrapper(
            lambda *t, mask=mask, heads=heads, nw=(h // WS) ** 2:
            fused_window_attention(*t, mask, heads=heads,
                                   windows_per_image=nw), 10)(
            xw, *a.values())
        if not torch.isfinite(sums).all():
            raise AssertionError("non-finite K1b gradients")
    torch.cuda.synchronize()
    launches = {k: cnt.launches for k, cnt in counters.items()}
    log(f"measure: tools and K1b at B={MEASURE_B} in "
        f"{time.perf_counter() - t0:.1f} s on {card}; launches {launches}")

    res = {"K1b": k1b}
    for kernel, key, table in (("K9", "abl-attn", mr.ATTN_ABLATIONS),
                               ("K10", "abl-leff", mr.LEFF_ABLATIONS),
                               ("K11", "ablbwd", mb.BWD_ABLATIONS)):
        entry = abl[kernel]
        for vname, _kw in table:
            v = entry["variants"][vname]
            v["ms"] = sum(ms for nm, ms in (rates | bwd).items()
                          if nm.startswith(f"{key}/")
                          and nm.endswith(f" {vname}"))
            v.update(bounds[(kernel, vname)].fields())
        full = entry["variants"]["full"]
        res[kernel] = dict(max_abs_err=entry["max_abs_err"], ms=full["ms"],
                           plain_ms=entry["plain_ms"],
                           bound_ms=full["bound_ms"],
                           bound_by=full["bound_by"], library_ms=None,
                           variants=entry["variants"])
        log(f"{kernel} at B={MEASURE_B}, summed over the five groups: "
            + "; ".join(f"{v} {d['ms']:.4f} ms (bound {d['bound_ms']:.4f}, "
                        f"{d['bound_by']})"
                        for v, d in entry["variants"].items()))
    return res, launches


def phase_variants(card: str, fwd_ms: float, train_ms: float
                   ) -> tuple[dict, dict]:
    """The kernel-variant slice. K7, every variant the tool times, against
    its plain version on the tool's B=8 inputs at the five SwinGroup shapes
    (bf16, TOL), loop_ln bitwise against K1 (mask-free, no residual), each
    core's heads per stage and shared memory as the kernel reports them;
    K8, every variant, against its plain
    version, and with no flag bitwise against K2 (no residual). Then the
    main path, with the counts set to 0 just before and read just after:
    `measure_swin_variants check time` at B=8 and `profile_components` over
    every component at the published sizes. Then mfu_forward / mfu_train
    from the slice's B=8 forward (`fwd_ms`) and the train phase's B=8 step
    (`train_ms`). Returns (per-kernel results, launches)."""
    import torch

    from fbanet_tpu_torch.ops import _build
    from fbanet_tpu_torch.ops.attention import fused_window_attention_2d
    from fbanet_tpu_torch.ops.leff import fused_leff
    from fbanet_tpu_torch.tools import flops_accounting, profile_components
    from fbanet_tpu_torch.tools import measure_swin_rates as mr
    from fbanet_tpu_torch.tools import measure_swin_variants as mv

    lib = _build.library()
    n = WS * WS
    failures = []
    res = {k: dict(max_abs_err=0.0, plain_ms=0.0, variants={})
           for k in ("K7", "K8")}
    bounds = {}

    def compare(kernel, vname, line, got, ref, prod, work):
        err, rel = rel_err(got, ref)
        entry = res[kernel]["variants"].setdefault(vname, dict(max_abs_err=0.0))
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        res[kernel]["max_abs_err"] = max(res[kernel]["max_abs_err"], err)
        bounds.setdefault((kernel, vname), Bound()).add(*work)
        same = torch.equal(got, prod)
        line += (f": max_abs_err={err:.3e} rel={rel:.3e} bitwise_equal_to_"
                 f"{'K1' if kernel == 'K7' else 'K2'}={same}")
        if not (rel <= TOL["bfloat16"]) or not torch.isfinite(got).all():
            failures.append(line)
        return line, same

    for name, c, r, heads in mr.GROUPS:
        chunks = {core: (lib.fbanet_attention_variant_chunk(n, c, heads, cid),
                         lib.fbanet_attention_variant_smem(n, c, heads, cid))
                  for core, cid in mv._CORE_IDS.items()}
        line = (f"K7 {name} c{c}@{r} heads={heads}: (heads per stage, shared "
                f"memory bytes) by core {chunks}")
        if any(chunks[kw["core"]][0] == 0
               for _v, kw in mv.attention_cases(name, c, r, heads)):
            failures.append(line + ": a core the tool runs does not fit")
        log(line)
        args = mr._attn_args(c, r, heads, batch=MEASURE_B)
        prod = fused_window_attention_2d(*args, None, heads=heads,
                                         window_size=WS)
        for vname, kw in mv.attention_cases(name, c, r, heads):
            kw = dict(kw)
            fn = mv.variant_attention(c, r, heads, kw.pop("core"), **kw)
            got, ref = fn(*args), fn(*args, plain=True)
            torch.cuda.synchronize()
            line, same = compare(
                "K7", vname, f"K7 {vname} {name} c{c}@{r} B={MEASURE_B} bf16",
                got, ref, prod, attention_work(r, c, heads, False,
                                               batch=MEASURE_B))
            if vname == "loop":
                pms = time_ms(lambda fn=fn: fn(*args, plain=True), iters=3,
                              repeats=3)
                res["K7"]["plain_ms"] += pms
                line += f" plain_ms={pms:.4f}"
            if vname == "loop_ln" and not same:
                failures.append(line)
            log(line)
        la = mr._leff_args(c, r, batch=MEASURE_B)
        k2 = fused_leff(*la)
        for vname, kw in [("prod", {})] + list(mv.LEFF_VARIANTS.items()):
            fn = mv.variant_leff(c, r, **kw)
            got, ref = fn(*la), fn(*la, plain=True)
            torch.cuda.synchronize()
            line, same = compare(
                "K8", vname, f"K8 {vname} {name} c{c}@{r} B={MEASURE_B} bf16",
                got, ref, k2, leff_work(r, c, batch=MEASURE_B))
            if vname == "prod":
                pms = time_ms(lambda fn=fn: fn(*la, plain=True), iters=3,
                              repeats=3)
                res["K8"]["plain_ms"] += pms
                line += f" plain_ms={pms:.4f}"
                if not same:
                    failures.append(line)
            log(line)
    if failures:
        raise AssertionError("variant slice disagrees with its plain versions "
                             "or the production kernels:\n"
                             + "\n".join(failures))

    # the main path: the tool's check and time modes, every component
    counters = _counters()
    torch.cuda.synchronize()
    for cnt in counters.values():
        cnt.launches = 0
    t0 = time.perf_counter()
    mv.main(["check"])
    timed = mv.main(["time"])
    comps = profile_components.main([])
    torch.cuda.synchronize()
    launches = {k: cnt.launches for k, cnt in counters.items()}
    log(f"variants: the tool at B={MEASURE_B} and the component profile in "
        f"{time.perf_counter() - t0:.1f} s on {card}; launches {launches}")
    if not all(math.isfinite(v) and v > 0 for v in comps.values()):
        raise AssertionError(f"component profile not finite: {comps}")

    k1_ms = sum(ms for nm, ms in timed.items()
                if nm.startswith("var/") and nm.endswith(" prod"))
    for kernel, prefix, rep, beside in (
            ("K7", "var", "loop", f" (K1 at the five: {k1_ms:.4f} ms)"),
            ("K8", "leffvar", "prod", " (prod: K2's instantiation)")):
        entry = res[kernel]
        for vname, v in entry["variants"].items():
            v["ms"] = sum(ms for nm, ms in timed.items()
                          if nm.startswith(f"{prefix}/")
                          and nm.endswith(f" {vname}"))
            v.update(bounds[(kernel, vname)].fields())
        entry.update(ms=entry["variants"][rep]["ms"],
                     bound_ms=entry["variants"][rep]["bound_ms"],
                     bound_by=entry["variants"][rep]["bound_by"],
                     library_ms=None)
        log(f"{kernel} at B={MEASURE_B}, summed over the groups each ran"
            f"{beside}: "
            + "; ".join(f"{v} {d['ms']:.4f} ms (bound {d['bound_ms']:.4f}, "
                        f"{d['bound_by']})"
                        for v, d in entry["variants"].items()))
    mfu = flops_accounting.mfu_fields(8, 14, 160, 64, fwd_ms / 1e3,
                                      8e3 / train_ms, 8)
    log(f"mfu at B=8 on {card}: {mfu} (forward {fwd_ms:.2f} ms from the "
        f"slice phase, train {train_ms:.2f} ms/step from the train phase, "
        f"against {flops_accounting.H100_BF16_PEAK / 1e12:.0f} TFLOP/s "
        f"dense bf16)")
    return res, launches


def _counters():
    """name -> the wrapper whose `.launches` counts that kernel."""
    from fbanet_tpu_torch.ops import attention, leff, reduce, warp_kernels
    from fbanet_tpu_torch.tools import (
        measure_bwd,
        measure_swin_rates,
        measure_swin_variants,
    )

    return {"K1": attention.fused_window_attention_2d,
            "K2": leff.fused_leff, "K3": attention.window_attention_bwd,
            "K4": leff.leff_bwd, "R1": reduce.token_matmul,
            "R2": reduce.column_sum,
            "K5": warp_kernels.warp_burst_bilinear,
            "K6": warp_kernels.warp_burst_coords,
            "K1b": attention.fused_window_attention,
            "K9": measure_swin_rates.ablation_attention,
            "K10": measure_swin_rates.ablation_leff,
            "K11": measure_bwd.ablation_backward,
            "K7": measure_swin_variants.attention_variant,
            "K8": measure_swin_variants.leff_variant}


def _device_ms(events) -> tuple[float, dict]:
    """(total device ms of a profile, device ms of the port's kernels by
    name)."""
    total, ours = 0.0, {}
    for e in events:
        if "CUDA" not in str(e.device_type):  # device events only
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        total += us
        for key in ("window_attention_bwd", "window_attention_bf16",
                    "leff_bwd", "leff_ln_bwd", "leff_bf16", "token_matmul",
                    "column_sum", "warp_homography", "warp_coords"):
            if key in e.key:
                ours[key] = ours.get(key, 0.0) + us / 1e3
    return total / 1e3, ours


def phase_train(card: str) -> tuple[dict, float]:
    """The training path at the published width: FBANet-64 (14 frames,
    160 px, window 8, bf16 compute, f32 parameters, drop_path 0.1), random
    weights from a seed, AdamW at lr 1e-4, B=8 synthetic bursts with HR
    targets, 5 steps of `train.make_train_step`. Checks finite losses, that
    every parameter moved, and 20 launches per step of each of K1-K4. Then
    one f32 step at B=2 holds every parameter gradient of the kernel path
    against the plain path, and the B=8 step is timed against the plain
    versions and profiled. Returns the launch counts of the 5 steps and
    the B=8 step's ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fbanet_tpu_torch.config import TrainConfig
    from fbanet_tpu_torch.models import ModelConfig, create_model
    from fbanet_tpu_torch.train import make_optimizer, make_train_step
    from fbanet_tpu_torch.utils.weights import random_state_dict

    cfg = ModelConfig(num_frames=14, img_size=160, embed_dim=64,
                      window_size=8, dtype="bfloat16", drop_path_rate=0.1)
    tcfg = TrainConfig(batch_size=8, lr_initial=1e-4, optimizer="adamw")
    state = random_state_dict(create_model(cfg, device="cpu", seed=0),
                              seed=2)
    model = create_model(cfg, device="cuda", seed=0)
    model.load_state_dict(state, strict=True)
    layers = sum(cfg.depths[i] for i in (0, 1, 4, 5, 6)) * 2
    opt = make_optimizer(model.parameters(), tcfg)
    step = make_train_step(model, opt, tcfg)
    lr_np, hr_np = make_realistic_bursts(8, 14, 160, seed=30, hr_scale=4)
    lr8, hr8 = torch.from_numpy(lr_np).cuda(), torch.from_numpy(hr_np).cuda()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator(device="cuda").manual_seed(7)
    counters = _counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    losses, times, per_step = [], [], []
    for _ in range(5):
        t0 = time.perf_counter()
        losses.append(float(step(lr8, hr8, gen, tcfg.lr_initial)))
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: c.launches for k, c in counters.items()})
    launches = per_step[-1]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"train: 5 steps at B=8, losses {losses}, step ms {times}, "
        f"launches {launches}, peak {peak:.2f} GiB")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    for name in ("K1", "K2", "K3", "K4"):
        counts = [s[name] for s in per_step]
        if counts != [layers * (i + 1) for i in range(5)]:
            raise AssertionError(f"{name}: cumulative launches {counts} over "
                                 f"5 steps, expected {layers} per step")
    still = [n for n, p in model.named_parameters()
             if torch.equal(p.detach(), before[n])]
    if still:
        raise AssertionError(f"parameters that did not move: {still}")
    del before

    # f32, B=2: every parameter gradient, kernels against plain versions
    cfg32 = cfg.replace(dtype="float32")
    m32 = create_model(cfg32, device="cuda", seed=0)
    m32.load_state_dict(state, strict=True)
    grads = []
    for plain in (False, True):
        m32.zero_grad(set_to_none=True)
        loss_fn = make_train_step(m32, None, tcfg, plain=plain).loss_fn
        loss_fn(lr8[:2], hr8[:2],
                torch.Generator(device="cuda").manual_seed(11)).backward()
        grads.append({n: p.grad.clone() for n, p in m32.named_parameters()
                      if p.grad is not None})
    if grads[0].keys() != grads[1].keys():
        raise AssertionError("kernel and plain paths differ in which "
                             "parameters get a gradient")
    worst, worst_name = 0.0, ""
    for n, ref in grads[1].items():
        scale = float(ref.abs().max())
        err = float((grads[0][n] - ref).abs().max()) / (scale or 1.0)
        if not err <= worst:
            worst, worst_name = err, n
    log(f"train f32 B=2 gradients, kernels vs plain: {len(grads[1])} "
        f"tensors, max err relative to each tensor's max |grad| "
        f"{worst:.3e} ({worst_name}; limit {TRAIN_GRAD_TOL})")
    if not worst <= TRAIN_GRAD_TOL:
        raise AssertionError(f"f32 gradient {worst_name}: {worst:.3e}")
    del m32, grads

    # B=8 step time against the plain versions (same model, fresh steps)
    ms = statistics.median(times[1:])
    plain_step = make_train_step(model, opt, tcfg, plain=True)
    plain_times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(plain_step(lr8, hr8, gen, tcfg.lr_initial))
        plain_times.append((time.perf_counter() - t0) * 1e3)
    log(f"train B=8 on {card}: {ms:.2f} ms/step, {8e3 / ms:.3f} samples/s "
        f"(plain versions {statistics.median(plain_times):.2f} ms/step), "
        f"peak {peak:.2f} GiB")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        float(step(lr8, hr8, gen, tcfg.lr_initial))
    events = prof.key_averages()
    log(events.table(sort_by="cuda_time_total", row_limit=25,
                     max_name_column_width=60))
    total, ours = _device_ms(events)
    k4 = ours.get("leff_bwd", 0.0) + ours.get("leff_ln_bwd", 0.0)
    log(f"train B=8 profile: device {total:.3f} ms, port kernels (ms) "
        f"{ {k: round(v, 3) for k, v in ours.items()} }; K4 (leff_bwd + "
        f"leff_ln_bwd) {k4:.3f} ms")
    return launches, ms


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

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    kres = timed("kernels", phase_kernels, MAIN_SHAPES)
    kres.update(timed("backward", phase_backward, MAIN_SHAPES))
    kres.update(timed("reduce", phase_reduce))
    reg, registered = timed("registration", phase_registration, card)
    kres.update(reg)
    served, fwd_ms = timed("slice", phase_slice, card)
    trained, train_ms = timed("train", phase_train, card)
    mres, measured = timed("measure", phase_measure, card)
    kres.update(mres)
    vres, varied = timed("variants", phase_variants, card, fwd_ms, train_ms)
    kres.update(vres)
    # launches on the main paths: registration (K5, K6), serving (K1, K2),
    # training (K1-K4, R1, R2), measurement (K1b, K9-K11 and, through the
    # tools, K1-K4, R1, R2) and the variants (K7, K8 and, through the tools,
    # K1-K4, R1, R2)
    launches = {k: registered.get(k, 0) + served.get(k, 0) + trained.get(k, 0)
                + measured.get(k, 0) + varied.get(k, 0) for k in kres}
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on a main path: "
                             f"{missing}")
    table = (
        ("K1", "K1 fused window attention", "attention.cu",
         "fbanet_tpu/ops/attention_pallas.py:250"),
        ("K2", "K2 fused LeFF", "leff.cu",
         "fbanet_tpu/ops/leff_pallas.py:172"),
        ("K3", "K3 fused window attention backward", "attention_bwd.cu",
         "fbanet_tpu/ops/attention_pallas.py:334"),
        ("K4", "K4 fused LeFF backward (and K4b)", "leff_bwd.cu",
         "fbanet_tpu/ops/leff_pallas.py:278 and :528"),
        ("R1", "K3/K4 weight-gradient sums (token_matmul)", "reduce.cu",
         "fbanet_tpu/ops/attention_pallas.py:465 and leff_pallas.py:394"),
        ("R2", "K3/K4 partial sums (column_sum)", "reduce.cu",
         "fbanet_tpu/ops/attention_pallas.py:463 and leff_pallas.py:392"),
        ("K5", "K5 homography bilinear warp", "warp.cu",
         "fbanet_tpu/ops/warp_pallas.py:102"),
        ("K6", "K6 dense-coords bilinear warp", "warp.cu",
         "fbanet_tpu/ops/warp_pallas.py:128"),
        ("K1b", "K1b fused window attention on [G, N, C] windows",
         "attention.cu", "fbanet_tpu/ops/attention_pallas.py:234"),
        ("K9", "K9 attention ablation (measure_swin_rates)", "attention.cu",
         "scripts/measure_swin_rates.py:136"),
        ("K10", "K10 LeFF ablation (measure_swin_rates)", "leff.cu",
         "scripts/measure_swin_rates.py:253"),
        ("K11", "K11 attention backward ablation (measure_bwd)",
         "attention_bwd_ablation.cu", "scripts/measure_bwd.py:182"),
        ("K7", "K7 attention head-stage variants (measure_swin_variants)",
         "attention_variants.cu", "scripts/measure_swin_variants.py:241"),
        ("K8", "K8 LeFF packed-bf16 variants (measure_swin_variants)",
         "leff_variants.cu", "scripts/measure_swin_variants.py:355"),
    )
    kernels = [{"name": name, "route": "cuda",
                "source": f"fbanet_tpu_torch/csrc/{src}", "replaces": where,
                "launches": launches[key], **kres[key]}
               for key, name, src, where in table]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
