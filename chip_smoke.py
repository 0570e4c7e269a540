#!/usr/bin/env python3
"""Drive the PyTorch port (fbanet_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py ranks      # phase_ranks alone: on W > 1 cards,
                                     # W ranks over NCCL, one a card
    python3 chip_smoke.py configs F  # phase_configs alone, its results as
                                     # JSON in F (the full run starts it so)
    python3 chip_smoke.py raw F      # phase_raw alone, likewise
    python3 chip_smoke.py ecc        # phase_ecc alone

Phases, each printed as it runs; any failure raises and the exit code is
non-zero:

1. device: requires CUDA; prints the card's name and power limit.
2. build: compiles the CUDA kernels from fbanet_tpu_torch/csrc with nvcc
   (one process per source, in parallel, into build/fbanet_tpu_torch/, at
   first use) and prints the seconds and nvcc's register/spill report.
3. kernels: K1 (fused window attention) and K2 (fused LeFF) against their
   plain PyTorch versions on the card at the five SwinGroup shapes of the
   published model (B=2), f32 and bf16, K1 masked and unmasked, with the
   residual, K1 with a bitwise repeat (K1 and K2 in bf16 under their plans,
   the wgmma forms, and under their first kernels, which the plans keep for
   f32 and shapes the wgmma forms do not take; K1's wgmma form also at B=8,
   masked and unmasked). Prints the max abs error and the median times
   (CUDA events). Then K1 and K2 at B=8 at the five shapes under their
   plans (tools/measure_attention.py, tools/measure_leff.py): the same
   limit, ms, device ms, bound and the share of it, and K1's device ms under
   every candidate plan (`measure_attention.py plans`); and the Python
   models of K1's and K2's shared memory, which the CPU tests plan with,
   against the kernels'.
4. backward: K3 (attention backward) and K4 (LeFF backward), each with the
   fixed-order sums of ops/reduce.py, against their plain backwards at the
   same shapes, f32 and bf16, K3 masked and unmasked, residual on and off:
   every gradient within its limit, and bitwise equal over two runs (K3 in
   bf16 under its plan, the wgmma form, and under its first kernel; K4's
   plan splits the hidden channels at the B=2 bottleneck, so the split
   path is among them; K4 in bf16 also under the WMMA form; the plans keep
   the first forms for shapes the wgmma forms do not take). Then K3 and K4
   at B=8 at the five shapes under their plans
   (tools/measure_attention_bwd.py, tools/measure_leff_bwd.py): the same
   limits, ms, device ms, bound and the share of it; and the Python models
   of K3's and K4's shared memory, which the CPU tests plan with, against
   the kernels'.
5. reduce: the two reduction kernels against their plain versions at
   every shape of the B=8 train step (R1 at its 25 weight-gradient shapes,
   R2 at the K3/K4 partials, 800 x 6016 and 800 x 5760): relative error
   <= 1e-4 and a bitwise repeat at each, kernel / library / plain ms and
   the bound per shape and summed (tools/measure_reduce.py).
6. registration: K5 (homography warp) and K6 (dense-coords warp) against
   their plain versions on the published burst, B=8 x 13 non-reference
   frames of 160 x 160 x 3 f32, nearest and constant mode, with a bitwise
   repeat (K5's and K6's C = 3 kernels; K6 at the three ECC pyramid
   sizes; their general kernels at one channel, K5 at 160 px, K6 at 40),
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
   and a torch.profiler table of one homography align. Then translation
   ECC's kernel (`phase_ecc`) against its plain loop: the serving burst
   (16 x 13 frames of 160 px, 3 x 25 at eps 1e-5 and at eps 0), 37 x 53
   and 480 px (its finest level read through L2), each within 2e-3 px and
   rho within 1e-5 with a bitwise repeat; its ms, device ms and bound, and
   `online_register`'s ms and launches per B=16 batch.
7. slice: FBANet-64, 14 frames, 160 px, bf16 compute, every parameter drawn
   from a seed, serves 3 batches of 4 bursts through `eval_step` (ECC
   registration + forward + clamp + PSNR/SSIM). Checks finite [0, 1]
   outputs of shape [4, 640, 640, 3], K1 and K2 (their wgmma forms) launch
   counts of exactly 20 per forward and none of K1's first kernel, one
   launch of translation ECC's kernel per batch, and agreement with the same slice on the plain versions.
   Then times align and forward at B=8 and prints a torch.profiler table
   of one such step by device time.
8. train: the same model with drop_path 0.1 takes 5 AdamW steps at B=8
   through `train.make_train_step` (Charbonnier + 3 GW loss). Checks finite
   losses, that every parameter moved, 20 launches per step of each of
   K1-K4 (K1, K2 and K3 in their wgmma forms, none of K1's first kernel),
   and every f32 parameter gradient of one B=2 step against the plain
   versions (20 launches of each of K4 and K1's, K2's and K3's first
   kernels); times the B=8 step against the plain versions and prints a
   torch.profiler table of one step, with K1's, K2's, K3's and K4's device
   ms.
9. trainer: the entry points that read a dataset, at the same width, from
   a synthetic RealBSR tree written to disk through data/png.py (16 train
   and 8 test bursts of 14 frames at 192 px): the decoder the dataset uses
   and why the native pool is or is not there; loader bursts/s cold and
   cached; `train.main` for 2 epochs of 2 B=8 steps with a per-epoch eval,
   then stopped after one step and `--resume`d, under deterministic
   algorithms: 20 launches of each of K1-K4 per step and of K1 and K2 per
   eval forward, none of K1's first kernel, the resumed run's parameters
   and per-epoch PSNRs bit-equal to the uninterrupted run's; ms per step
   from disk and the data_wait share; `evaluate.main` on `model_best`
   within 1e-3 dB of the best epoch (eval bursts/s); `tiled.main` (psize
   80, overlap 40) on a GT-free 160 px burst: a finite [640, 640, 3] image.
10. ddp: data parallelism (parallel/mesh.py, DDP in train.make_train_step)
   on the trainer phase's tree. A NCCL process group of world 1 in this
   process: 3 steps of FBANet-64 at B=8 (bf16, drop_path 0.1) under
   DistributedDataParallel bit-equal to the same 3 steps without it, under
   deterministic algorithms, 20 launches of each of K1-K4 per step and none
   of K1's first kernel; then 8 more steps of each, alternating, under the
   default settings: the median ms of the DDP and the plain step, and the
   gradient bytes all-reduced per step. `python -m
   torch.distributed.run --nproc_per_node 1 -m fbanet_tpu_torch.train` for
   one epoch, then `... -m fbanet_tpu_torch.evaluate` on its `model_best`:
   no `module.` prefix, a strict load into a plain `create_model`, whose
   eval PSNR here is the torchrun evaluation's within 1e-3 dB. Two ranks
   on this one card over gloo (NCCL refuses two ranks on one GPU):
   `-m fbanet_tpu_torch.parallel.dryrun DIR steps`, one f32 step on a global
   batch of 8 against the one-process step on the same rows, every
   gradient within the train phase's f32 limit, both ranks' parameters
   bit-equal.
11. measure: K1b (window attention on [G, N, C] windows) against its plain
   version at the five shapes (B=2, f32 and bf16, masked and not) and
   bitwise against K1 on the partitioned map, under its plan and under the
   first kernel (against K1's); its backward (K3's windowed
   entry) against the plain backward on every gradient plus a bitwise
   repeat. K9, K10 and K11, every variant, against their plain versions on
   the tools' B=8 inputs (bf16, 3e-2 of max(1, |out|)), each `full`
   bitwise against the kernel its flags are built on on the same inputs,
   on both forms of K1 / K2 / K3 (the wgmma form their plans pick, every
   variant also bitwise on a repeat and with its device ms per group
   (K10: on both forms), `full` bitwise equal to K1 under that plan / K2 /
   K3's windowed entry, K9's notrans to K1b's windowed entry on the map;
   and the first kernel through an explicit plan, `full` bitwise equal to
   it); K9's shared memory on K1's plan against the tool's model.
   Then the slice's main path: both kernel-measurement tools at B=8
   (`measure_swin_rates attn leff ablate`, `measure_bwd check groups
   plainref leffabl merged ablate`, K9's, K10's and K11's variants timed
   on both forms, their tables printed) and K1b forward + backward through
   autograd at the five shapes.
12. variants: K7 (K1's function with its head stage rewritten: loop,
   loop_ln, stack3d, stack3d_ln, lanepack, ln+qkv1, ln+nr2) and K8 (K2's
   with packed-bf16 depthwise and/or GELUs), every variant on both forms
   of K1 / K2 (the wgmma form their plans pick, with its device ms per
   group, and the first kernel through an explicit plan, K7's also with
   its device ms) against its
   plain version on the tool's B=8 inputs at the five shapes (bf16, 3e-2
   of max(1, |out|)); K7 loop_ln, stack3d_ln, ln+qkv1 and ln+nr2 bitwise
   against K1 on the wgmma form and stack3d against loop, K7 loop_ln
   bitwise against K1's first kernel on that kernel, K8 with no flag
   bitwise against K2 on each form; each K7 core's heads per stage and
   shared memory on each form as the kernels report them (the wgmma
   form's against the tool's models), lanepack's bytes. Then the slice's
   main path: `measure_swin_variants check time` at B=8 (K7's and K8's
   variants checked and timed on both forms) and `profile_components`
   over every component at the published sizes (their tables printed);
   then mfu_forward / mfu_train (`flops_accounting.mfu_fields`) from the
   slice's forward and the train phase's step times.
13. configs (in a process of its own): every configuration the JAX model
   builds. FBANet-32 (embed 32, the configuration's default; head size 32
   at enc0 / enc1, 8 at the others): its plans must send K1-K4 to their
   wgmma forms at all five groups in bf16 (enc0, C = 32, on their C = 32
   instantiations) and to their first kernels in f32; K1-K4 against their
   plain versions under those plans, f32 at B=2, bf16 at B=2 and B=8, K1
   and K3 masked and not, each bitwise on a repeat (K3 and K4: dx and
   every parameter gradient, their sums included), the first kernels also
   through `_K1_BASE_PLAN` / `_K2_BASE_PLAN` / `_K3_BASE_PLAN` /
   `_WMMA_PLAN` in bf16, K1b and K3's windowed entry in bf16 at B=2 (K1b
   at enc0 also at B=8 and through `_K1_BASE_PLAN`); the layout models
   against the kernels' sizes at head sizes 8 and 32 and at C = 32 (K1,
   K2, K3, K4); K1-K4 and K1b per group at B=8 (ms, device ms, bound; enc0
   on the C = 32 forms) and R1 / R2 at every shape of its B=8 step (R1's
   32-wide outputs among them, beside torch.mm); then 3 batches of 4
   served through `eval_step` against the plain path and 5 AdamW steps at
   B=8 (20 launches of each of K1-K4 a step, all on their wgmma forms, K1
   and K3 on `-narrow`, none on a first kernel), one profiled, and an f32
   B=2 step's gradients against the plain versions. FBANet-64 at window 10, B=8: 20 composed attentions (JAX's
   shape rule) and 20 K2 a forward against the plain path, the forward
   timed, 3 steps. Two B=2 steps of FBANet-64 under each of
   use_qkv_bias=False, token_mlp="ffn" and conv + SE + qk_scale +
   dropout, with the launches their routes give.
14. raw (in a process of its own): FBANet-64 on RealBSR-RAW (4-channel
   packed Bayer, 14 frames, 160 px, bf16) from uint16 storage tensors.
   Served at B=8 through `eval_step` with ECC on R/G1/G2: 20 launches of K1
   and K2 (wgmma forms), a finite [8, 640, 640, 4] output within 40 dB of
   the plain path, the forward timed; 5 AdamW steps at B=8 with exactly
   the RGB step's launches of K1-K4, R1 and R2 (one RGB step at the same
   width counted beside them), step ms and peak memory; an f32 B=2 step's
   gradients against the plain versions. Then `train.main` for one epoch
   with `--profile_dir` (the trace names K1's kernel), `evaluate.main
   --save_images` and `tiled.main` (psize 80, overlap 40: `.npy` of
   [640, 640, 4] beside 640 x 640 PNGs) on a RAW tree of 8 + 4 bursts
   written through data/png.py; LPIPS (random weights) on a B=8 pair of
   640^2 images, the card against the CPU within 1e-4 relative, and ms;
   `bakeoff.main --synthetic`: every method above the unaligned PSNR,
   seconds per method.

Each kernel wrapper counts its launches (K1, K2, K3, K7, K8, K9, K10
and K11 per form); the counts are set to 0 just before the registration, the CLI
stream, the serving, the training (the B=8 steps, then the f32 B=2 step,
whose plans send K1, K2 and K3 to their first kernels), each run of the
trainer phase, each DDP step of the ddp phase, the measurement and the
variant runs, each serving, forward and step of the configs phase, and
each serving, step and entry point of the raw phase, and read just
after. The line before the last is a JSON object
{"kernels": [...]} (launches on those runs; error, times and bound from
phases 3-6, 9 and 10, errors also from 13; K7 and K9-K11 also per variant; K1, K2, K3, K7, K8,
K9, K10 and K11 with their first kernels as entries of their own, K1
and K3 also with their wgmma forms at head sizes 8 and 32, whose line
numbers come from 13), preceded
by the nvidia-smi name/power-limit line; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
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
    at B=2: tools/measure_attention_bwd.py's `work`."""
    from fbanet_tpu_torch.tools.measure_attention_bwd import work

    return work(batch, h, c, heads, masked, backward)


def leff_work(h, c, backward=False, batch=2):
    """(tensor-core flops, CUDA-core flops, bytes) of one K2 (or K4) call at
    B=2: tools/measure_leff.py's `work` (tools/measure_leff_bwd.py's for
    the backward)."""
    if backward:
        from fbanet_tpu_torch.tools.measure_leff_bwd import work
    else:
        from fbanet_tpu_torch.tools.measure_leff import work
    return work(batch, h, c)


def log(msg: str) -> None:
    print(msg, flush=True)


def make_realistic_bursts(batch, frames, size, seed=0, hr_scale=0):
    """[B, F, S, S, 3] photographic-like bursts in [0, 1] (bench.py's
    make_realistic_bursts: `data/synthetic.py::realistic_bursts`): smooth
    multi-frequency sinusoid fields, per-frame subpixel shifts (frame 0
    unshifted), sensor noise. With `hr_scale` it also returns the
    noise-free frame-0 field sampled on the x`hr_scale` grid, [B, S*s, S*s,
    3]: the HR target."""
    from fbanet_tpu_torch.data.synthetic import realistic_bursts

    got = realistic_bursts(batch, frames, size, seed=seed, hr_scale=hr_scale)
    return (got["LR"], got["HR"]) if hr_scale else got["LR"]


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


def attention_case(h, c, heads, dtype, masked, gen_seed, batch=2):
    """Inputs of one K1 call at a main-path shape, B=`batch`, on the
    card."""
    import torch

    from fbanet_tpu_torch.models.layers import shift_attention_mask

    nrm = _normal_fn(gen_seed)
    n = WS * WS
    x = nrm((batch, h, h, c), 1.0).to(dtype)
    args = dict(ln_scale=1 + nrm((c,), 0.1), ln_bias=nrm((c,), 0.1),
                wq=nrm((c, c), c ** -0.5), bq=nrm((c,), 0.1),
                wkv=nrm((2 * c, c), c ** -0.5), bkv=nrm((2 * c,), 0.1),
                wproj=nrm((c, c), c ** -0.5), bproj=nrm((c,), 0.1),
                bias=nrm((heads, n, n), 0.5),
                mask=(torch.from_numpy(shift_attention_mask(h, h, WS, WS // 2)).cuda()
                      if masked else None))
    return x, args


def leff_case(h, c, dtype, gen_seed, batch=2):
    """Inputs of one K2 call at a main-path shape, B=`batch`, on the
    card."""
    nrm = _normal_fn(gen_seed)
    ch = 4 * c
    x = nrm((batch, h, h, c), 1.0).to(dtype)
    args = dict(ln_scale=1 + nrm((c,), 0.1), ln_bias=nrm((c,), 0.1),
                w1=nrm((ch, c), c ** -0.5), b1=nrm((ch,), 0.1),
                wdw=nrm((ch, 1, 3, 3), 1 / 3), bdw=nrm((ch,), 0.1),
                w2=nrm((c, ch), ch ** -0.5), b2=nrm((c,), 0.1))
    return x, args


def phase_kernels(shapes) -> dict:
    """Each kernel against its plain version on the card. Returns per-kernel
    {max_abs_err, ms, plain_ms} (times summed over the shapes, bf16)."""
    import torch

    from fbanet_tpu_torch.ops import attention, leff
    from fbanet_tpu_torch.ops.leff import fused_leff

    res = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
           for k in ("K1", "K1-base", "K2", "K2-base")}
    bounds = {k: Bound() for k in res}
    failures = []
    # K1 and K2 plan on the card with the kernels' shared-memory functions;
    # the CPU tests plan with their Python models, which must agree
    for c in (64, 128, 256):
        for form in leff._K2_FORMS:
            ours, theirs = leff._leff_smem(c, *form), \
                leff._kernel_leff_smem(c, *form)
            if ours != theirs:
                failures.append(f"K2 shared memory C={c} {form}: kernel "
                                f"{theirs}, plan {ours}")
        for heads in (1, 2, 4, 8, 16):
            for nwg, staged in ((2, 1), (2, 0), (4, 1), (4, 0)):
                ours = attention._attention_smem(WS * WS, c, heads, nwg,
                                                 staged)
                theirs = attention._kernel_attention_smem(WS * WS, c, heads,
                                                          nwg, staged)
                if ours != theirs:
                    failures.append(f"K1 shared memory C={c} heads={heads} "
                                    f"warpgroups {nwg} staged {staged}: "
                                    f"kernel {theirs}, plan {ours}")
    for i, (h, c, heads) in enumerate(shapes):
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            bf16 = dname == "bfloat16"
            for batch, masked in ((2, False), (2, True), (8, False),
                                  (8, True))[:4 if bf16 else 2]:
                x, a = attention_case(h, c, heads, dtype, masked,
                                      100 + i + 50 * (batch == 8), batch)

                def k1(plain=False, x=x, a=a, heads=heads):
                    return attention.fused_window_attention_2d(
                        x, **a, heads=heads, window_size=WS, residual=True,
                        plain=plain)

                plan = attention._attention_plan(
                    batch, h, h, c, heads, WS, bf16,
                    smem=attention._kernel_attention_smem)
                name = "K1" if plan[0] else "K1-base"
                got, again, ref = k1(), k1(), k1(plain=True)
                torch.cuda.synchronize()
                err, rel = rel_err(got, ref)
                same = torch.equal(got, again)
                res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
                line = (f"K1 attention B={batch} H={h} C={c} heads={heads} "
                        f"{dname} masked={masked} plan {plan}: max_abs_err="
                        f"{err:.3e} rel={rel:.3e} bitwise_repeat={same}")
                timed = bf16 and masked and batch == 2
                if timed:
                    ms, pms = time_ms(k1), time_ms(lambda: k1(plain=True))
                    res["K1"]["ms"] += ms
                    res["K1"]["plain_ms"] += pms
                    bounds["K1"].add(*attention_work(h, c, heads, masked,
                                                     backward=False))
                    line += f" kernel_ms={ms:.4f} plain_ms={pms:.4f}"
                log(line)
                if not (rel <= TOL[dname]) or not same \
                        or not torch.isfinite(got).all():
                    failures.append(line)
                if bf16 and batch == 2:
                    # the first kernel in bf16, which the plan keeps for
                    # bf16 shapes the wgmma form does not take (and
                    # K7-base's, K9's base)
                    def k1_base(x=x, a=a, heads=heads):
                        return attention._attention_launch(
                            x, *a.values(), heads, WS, True,
                            attention._K1_BASE_PLAN)

                    got = k1_base()
                    torch.cuda.synchronize()
                    err, rel = rel_err(got, ref)
                    res["K1-base"]["max_abs_err"] = max(
                        res["K1-base"]["max_abs_err"], err)
                    line = (f"K1 attention B={batch} H={h} C={c} heads="
                            f"{heads} {dname} masked={masked} plan "
                            f"{attention._K1_BASE_PLAN} (first kernel): "
                            f"max_abs_err={err:.3e} rel={rel:.3e}")
                    if timed:
                        ms = time_ms(k1_base)
                        res["K1-base"]["ms"] += ms
                        res["K1-base"]["plain_ms"] += pms
                        bounds["K1-base"].add(*attention_work(
                            h, c, heads, masked, backward=False))
                        line += f" kernel_ms={ms:.4f}"
                    log(line)
                    if not (rel <= TOL[dname]) or \
                            not torch.isfinite(got).all():
                        failures.append(line)
            x, a = leff_case(h, c, dtype, 200 + i)

            def k2(plain=False, x=x, a=a):
                return fused_leff(x, **a, residual=True, plain=plain)

            plan = leff._leff_plan(2, h, h, c, 4 * c, dname == "bfloat16",
                                   smem=leff._kernel_leff_smem)
            got, ref = k2(), k2(plain=True)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            res["K2"]["max_abs_err"] = max(res["K2"]["max_abs_err"], err)
            line = (f"K2 leff H={h} C={c} Ch={4 * c} {dname} plan {plan}: "
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
            if dname == "bfloat16":
                # the first kernel in bf16, which the plan keeps for bf16
                # shapes the wgmma form does not take (and K8-base's and
                # K10-base's)
                def k2_base(x=x, a=a):
                    return leff._leff_launch(x, *a.values(), True,
                                             leff._K2_BASE_PLAN)

                got = k2_base()
                torch.cuda.synchronize()
                err, rel = rel_err(got, ref)
                ms = time_ms(k2_base)
                res["K2-base"]["max_abs_err"] = max(
                    res["K2-base"]["max_abs_err"], err)
                res["K2-base"]["ms"] += ms
                res["K2-base"]["plain_ms"] += pms
                bounds["K2-base"].add(*leff_work(h, c))
                line = (f"K2 leff H={h} C={c} Ch={4 * c} {dname} plan "
                        f"{leff._K2_BASE_PLAN} (first kernel): max_abs_err="
                        f"{err:.3e} rel={rel:.3e} kernel_ms={ms:.4f}")
                log(line)
                if not (rel <= TOL[dname]) or not torch.isfinite(got).all():
                    failures.append(line)
    if failures:
        raise AssertionError("kernel disagrees with its plain version:\n"
                             + "\n".join(failures))
    for k in res:
        res[k].update(bounds[k].fields(), library_ms=None)
    # K1 and K2 at B=8, each shape under its plan: the same limit, ms,
    # device ms, bound and the share of it (tools/measure_attention.py,
    # tools/measure_leff.py); K1 under every candidate plan
    from fbanet_tpu_torch.tools import measure_attention, measure_leff

    for name, tool in (("K1", measure_attention), ("K2", measure_leff)):
        b8 = tool.shapes(batch=8)
        res[name]["b8"] = {r["group"]: {k: r[k] for k in (
            "plan", "ms", "device_ms", "bound_ms", "share_of_bound",
            "max_rel_err")} for r in b8["rows"]}
        res[name]["b8_sums"] = b8["sums"]
    measure_attention.plans(batch=8)
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
    bf16 under its plan (the wgmma form, "K4") and under the WMMA form
    ("K4-base"); every gradient, plus bitwise repeatability (two kernel
    runs on the same inputs). Returns per-kernel {max_abs_err, ms,
    plain_ms} (times summed over the shapes: bf16, K3 masked, residual
    on)."""
    import torch

    from fbanet_tpu_torch.ops import attention, leff

    res = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
           for k in ("K3", "K3-base", "K4", "K4-base")}
    bounds = {k: Bound() for k in res}
    failures = []
    for c in (64, 128, 256):
        for heads in (1, 2, 4, 8, 16):
            for nwg in (2, 4):
                ours = attention._attention_bwd_smem(WS * WS, c, heads, nwg)
                theirs = attention._kernel_bwd_smem(WS * WS, c, heads, nwg)
                if ours != theirs:
                    failures.append(f"K3 shared memory C={c} heads={heads} "
                                    f"warpgroups {nwg}: kernel {theirs}, "
                                    f"plan {ours}")
    # K4 plans on the card with the kernel's shared-memory function; the
    # CPU tests plan with its Python model, which must agree with it
    for c in (32, 64, 128, 256):
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

                    plan = attention._attention_bwd_plan(
                        2, h, h, c, heads, WS, dname == "bfloat16",
                        smem=attention._kernel_bwd_smem)
                    got, again, ref = k3(), k3(), k3_plain()
                    torch.cuda.synchronize()
                    line = check("K3", f"K3 attention bwd H={h} C={c} "
                                 f"heads={heads} {dname} masked={masked} "
                                 f"residual={residual} plan {plan}", got,
                                 again, ref, dname)
                    timed = dname == "bfloat16" and masked and residual
                    if timed:
                        ms, pms = time_ms(k3), time_ms(k3_plain)
                        res["K3"]["ms"] += ms
                        res["K3"]["plain_ms"] += pms
                        bounds["K3"].add(*attention_work(
                            h, c, heads, masked, backward=True))
                        line += f" kernel_ms={ms:.4f} plain_ms={pms:.4f}"
                    log(line)
                    if dname == "bfloat16":
                        # the first kernel in bf16, which the plan keeps for
                        # bf16 shapes the wgmma form does not take (and
                        # K11's base)
                        def k3_base(x=x, g=g, p=p, heads=heads,
                                    residual=residual):
                            return attention._attention_bwd_launch(
                                x, g, *p.values(), heads, WS, residual,
                                attention._K3_BASE_PLAN)

                        got, again = k3_base(), k3_base()
                        torch.cuda.synchronize()
                        line = check("K3-base", f"K3 attention bwd H={h} "
                                     f"C={c} heads={heads} {dname} masked="
                                     f"{masked} residual={residual} plan "
                                     f"{attention._K3_BASE_PLAN} (first "
                                     f"kernel)", got, again, ref, dname)
                        if timed:
                            ms = time_ms(k3_base)
                            res["K3-base"]["ms"] += ms
                            res["K3-base"]["plain_ms"] += pms
                            bounds["K3-base"].add(*attention_work(
                                h, c, heads, masked, backward=True))
                            line += f" kernel_ms={ms:.4f}"
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
                line = check("K4" if plan[0] else "K4-base",
                             f"K4 leff bwd H={h} C={c} Ch={4 * c} {dname} "
                             f"residual={residual} plan {plan}", got, again,
                             ref, dname)
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
                    line = check("K4-base", f"K4 leff bwd H={h} C={c} "
                                 f"Ch={4 * c} {dname} residual={residual} "
                                 f"plan {leff._WMMA_PLAN} (WMMA form)", got,
                                 again, ref, dname)
                    if residual:
                        ms = time_ms(k4_wmma)
                        res["K4-base"]["ms"] += ms
                        res["K4-base"]["plain_ms"] += pms
                        bounds["K4-base"].add(*leff_work(h, c,
                                                         backward=True))
                        line += f" kernel_ms={ms:.4f}"
                    log(line)
    if failures:
        raise AssertionError("backward kernel disagrees with its plain "
                             "version or does not repeat:\n"
                             + "\n".join(failures))
    for k in res:
        res[k].update(bounds[k].fields(), library_ms=None)
    # K3 and K4 at B=8, each shape under its plan: the same limits, ms,
    # device ms, bound and the share of it (tools/measure_attention_bwd.py,
    # tools/measure_leff_bwd.py)
    from fbanet_tpu_torch.tools import measure_attention_bwd, measure_leff_bwd

    for name, tool in (("K3", measure_attention_bwd),
                       ("K4", measure_leff_bwd)):
        b8 = tool.shapes(batch=8)
        res[name]["b8"] = {r["group"]: {k: r[k] for k in (
            "plan", "ms", "device_ms", "bound_ms", "share_of_bound",
            "max_rel_err")} for r in b8["rows"]}
        res[name]["b8_sums"] = b8["sums"]
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
        got, again, ref = fn(False), fn(False), fn(True)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        repeat = torch.equal(got, again)
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        line += (f": max_abs_err={err:.3e} rel={rel:.3e} "
                 f"bitwise_repeat={repeat}")
        if not (rel <= TOL["float32"]) or not torch.isfinite(got).all() \
                or not repeat:
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
    # K5's general kernel (any C; the C = 3 kernel serves the align) at one
    # channel
    fr5 = frames[..., :1].contiguous()
    for mode in ("nearest", "constant"):
        def k5c1(plain, mode=mode):
            return wk.warp_burst_bilinear(fr5, mats, mode=mode, cval=0.5,
                                          plain=plain)
        log(compare("K5", f"K5 warp_burst_bilinear {n}x{h}x{w}x1 {mode}",
                    k5c1))
    del fr5
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
    res["ECC"] = phase_ecc(card)
    return res, launches


# translation ECC's kernel (csrc/ecc.cu) against its plain loop: the
# serving burst (ECC_B x 13 frames of 160 px, online_register's 3 x 25 at
# eps 1e-5, and at eps 0), an odd size, and 480 px (its finest level read
# through L2). A translation moves every corner by its shift, so the
# corners' error is the shifts' (<= REG_PLAIN_PX); rho within ECC_RHO.
ECC_B, ECC_RHO = 16, 1e-5
# f32 operations the algorithm needs per pixel and iteration (the bilinear
# sample of the image and of its two gradients, 27; centring the image and
# the template, 2; seven products summed, 19) and per pixel of a pyramid
# level built (the separable 5-tap binomial of the image and the template)
ECC_PIX_FLOPS, ECC_PYR_FLOPS = 48, 60


def ecc_work(its, h, w):
    """(tensor-core flops, CUDA-core flops, bytes) of one ECC launch whose
    frames of h x w ran `its` [levels, N] iterations: the iterations each
    level ran and its pyramid, each frame and template read once, p, rho and
    the counts written."""
    levels, n = its.shape
    flops, hh, ww = 0, h, w
    for lvl in range(levels):
        flops += int(its[lvl].sum()) * hh * ww * ECC_PIX_FLOPS
        if lvl:
            flops += n * hh * ww * ECC_PYR_FLOPS
        hh, ww = (hh + 1) // 2, (ww + 1) // 2
    return 0, flops, n * (2 * h * w + 3 + levels) * 4


def phase_ecc(card: str) -> dict:
    """Translation ECC's kernel against its plain loop, then its times and
    those of `online_register` on a served batch. Returns the kernel's
    results (its launches are counted on the serving path, `phase_slice`)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fbanet_tpu_torch.ops import registration as reg
    from fbanet_tpu_torch.tools.measure_reduce import device_ms

    res = dict(max_abs_err=0.0)
    failures = []

    def pairs(b, h, w, seed):
        lr = torch.from_numpy(make_realistic_bursts(b, 14, max(h, w),
                                                    seed=seed)).cuda()
        gray = reg.rgb_to_gray(lr)[:, :, :h, :w]
        tpl = gray[:, :1].expand(-1, 13, -1, -1).reshape(-1, h, w)
        return tpl.contiguous(), gray[:, 1:].reshape(-1, h, w).contiguous()

    def run(tpl, img, eps):
        return reg.ecc_translation(tpl, img, None, REG_LEVELS, REG_ITERS, eps)

    def compare(tpl, img, eps):
        n, h, w = tpl.shape
        p, rho, its = run(tpl, img, eps)
        again = run(tpl, img, eps)
        m_p, rho_p = reg.ecc_align(tpl, img, levels=REG_LEVELS,
                                   iters_per_level=REG_ITERS, eps=eps,
                                   plain=True)
        torch.cuda.synchronize()
        px = float((p - m_p[:, :2, 2]).abs().max())
        drho = float((rho - rho_p).abs().max())
        repeat = all(torch.equal(a, b) for a, b in zip((p, rho, its), again))
        per_level = its.amax(1).tolist()
        line = (f"ECC ecc_translation {n}x{h}x{w} eps={eps:g}: corners "
                f"{px:.3e} px (limit {REG_PLAIN_PX}), rho {drho:.3e} (limit "
                f"{ECC_RHO}), bitwise_repeat={repeat}, iterations per level "
                f"(finest first, most over the frames) {per_level}; max |shift| "
                f"{float(p.abs().max()):.3f} px")
        log(line)
        res["max_abs_err"] = max(res["max_abs_err"], px)
        if not (px <= REG_PLAIN_PX and drho <= ECC_RHO and repeat
                and bool(torch.isfinite(p).all())):
            failures.append(line)
        return its

    tpl, img = pairs(ECC_B, REG_SIZE, REG_SIZE, seed=60)
    its = compare(tpl, img, 1e-5)
    compare(tpl, img, 0.0)
    for h, w, seed in ((37, 53, 61), (480, 480, 62)):
        compare(*pairs(1, h, w, seed), 1e-5)
    if failures:
        raise AssertionError("ECC kernel disagrees with its plain loop:\n"
                             + "\n".join(failures))

    ms = time_ms(lambda: run(tpl, img, 1e-5))
    dms = device_ms(lambda: run(tpl, img, 1e-5), keys=("ecc",))
    pms = time_ms(lambda: reg.ecc_align(tpl, img, levels=REG_LEVELS,
                                        iters_per_level=REG_ITERS, eps=1e-5,
                                        plain=True), iters=2)
    b = Bound()
    b.add(*ecc_work(its.cpu().numpy(), REG_SIZE, REG_SIZE))
    res.update(ms=ms, device_ms=dms, plain_ms=pms, library_ms=None,
               **b.fields())
    log(f"ECC on {card}: {tpl.shape[0]} frames of {REG_SIZE} px, eps 1e-5: "
        f"kernel_ms={ms:.4f} device_ms={dms:.4f} plain_ms={pms:.4f} "
        f"bound_ms={b.ms:.4f} ({res['bound_by']}; device share of bound "
        f"{b.ms / dms:.3f})")

    # online_register on a served batch: host ms (synchronised) and the
    # kernels it launches
    lr = torch.from_numpy(make_realistic_bursts(ECC_B, 14, REG_SIZE,
                                                seed=63)).cuda()

    def register():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reg.online_register(lr)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    register()
    host = [register() for _ in range(10)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        reg.online_register(lr)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if "CUDA" in str(e.device_type)
               and not e.name.startswith(("Memcpy", "Memset"))
               and not getattr(e, "is_user_annotation", False)]
    res["register_ms"] = float(np.median(host))
    res["register_launches"] = len(kernels)
    log(f"ECC online_register B={ECC_B} on {card}: host ms median "
        f"{res['register_ms']:.3f} (min {min(host):.3f}), kernels "
        f"{len(kernels)} a batch: "
        f"{sorted({e.name[:40] for e in kernels})}")
    return res


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
    from fbanet_tpu_torch.ops.leff import _leff_launch
    from fbanet_tpu_torch.ops.registration import ecc_translation, online_register
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

    # the wgmma forms of K1 and K2, which serving runs, K1's first kernel,
    # which it must not, and translation ECC's kernel, one launch a batch
    k1, k1_base = fused_window_attention_2d.wgmma, \
        fused_window_attention_2d.base
    for cnt in (k1, k1_base, _leff_launch.wgmma, ecc_translation):
        cnt.launches = 0
    t0 = time.perf_counter()
    served = [eval_step(model, lr, hr, online_align="ecc")
              for lr, hr in requests]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": k1.launches, "K1-base": k1_base.launches,
                "K2": _leff_launch.wgmma.launches,
                "ECC": ecc_translation.launches}
    log(f"slice: served {len(served)} batches of 4 in {wall:.3f} s "
        f"(first call included); launches {launches}")
    for name, count in launches.items():
        want = {"K1-base": 0, "ECC": len(served)}.get(name,
                                                      layers * len(served))
        if count != want:
            raise AssertionError(f"{name}: {count} launches, expected "
                                 f"{want} ({layers} per forward of the wgmma"
                                 f" forms, one ECC a batch, x {len(served)})")

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
    pred_plain = eval_step(model, lr, hr, online_align="ecc", plain=True)[0]
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
    # synchronised work; ECC runs as one kernel launch, with no host read)
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
    depthwise taps (GELU is counted in neither). K11 (both forms):
    norecompute drops the q/k/v products (6 T C^2), nodx the dy product
    (6 T C^2), nowgrads the weight-gradient products (8 T C^2) and the
    gradients' bytes, nocore the core products (12 T n C), its softmax work
    and the q/k/v products, whose values only the core reads (both forms
    skip them); nodsoftmax keeps one multiply per logit of the softmax
    backward's five."""
    t, n = MEASURE_B * h * h, WS * WS
    if kernel in ("K10", "K10-base"):
        tc, f32, nbytes = leff_work(h, c, batch=MEASURE_B)
        return tc, 0 if variant == "nodw" else f32, nbytes
    if kernel in ("K9", "K9-base"):
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
        tc, f32 = tc - 12 * t * n * c - 6 * t * c * c, 0
    elif variant == "nodsoftmax":
        f32 = 6 * t * n * heads
    return tc, f32, nbytes


def phase_measure(card: str) -> tuple[dict, dict]:
    """The measurement slice. K1b (`fused_window_attention`) against its
    plain version and against K1 on the partitioned map (bitwise), and its
    backward (K3's windowed entry) against the plain backward on every
    gradient plus a bitwise repeat, at the five SwinGroup shapes, B=2, f32
    and bf16, masked and not. K9, K10 and K11, every variant, on both of
    K1's / K2's / K3's forms, against their plain versions at the tools' B=8
    inputs, bf16, with a bitwise repeat, and each `full` variant bitwise
    against the kernel its flags are built on on the same inputs (K1 / K2 /
    K3 on each form; K9's notrans on the wgmma form against K1b too).
    Then the main path: both tools' modes at B=8 and K1b forward + backward
    through autograd at the five shapes, with the counts set to 0 just
    before and read just after. Returns (per-kernel results, launches)."""
    import torch

    from fbanet_tpu_torch.ops import _build, attention
    from fbanet_tpu_torch.ops.attention import (
        fused_window_attention,
        fused_window_attention_2d,
        window_partition,
    )
    from fbanet_tpu_torch.ops import leff
    from fbanet_tpu_torch.tools import measure_bwd as mb
    from fbanet_tpu_torch.tools import measure_swin_rates as mr
    from fbanet_tpu_torch.tools.measure_reduce import device_ms

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
                plan = attention._attention_plan(
                    xw.shape[0], WS, WS, c, heads, WS, dname == "bfloat16",
                    smem=attention._kernel_attention_smem)
                line = (f"K1b windows G={xw.shape[0]} C={c} heads={heads} "
                        f"{dname} masked={masked} plan {plan}: max_abs_err="
                        f"{err:.3e} rel={rel:.3e} equal_to_K1_on_the_map="
                        f"{same}")
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
                if dname == "bfloat16":
                    # K1b on the first kernel, against K1's first kernel
                    base = attention._K1_BASE_PLAN
                    got = attention._launch_windows(
                        xw, *a.values(), heads, nw, plan=base)
                    on_map = window_partition(attention._attention_launch(
                        x4, *a.values(), heads, WS, False, base), WS)
                    torch.cuda.synchronize()
                    err, rel = rel_err(got, ref)
                    same = torch.equal(got, on_map)
                    line = (f"K1b windows G={xw.shape[0]} C={c} heads="
                            f"{heads} {dname} masked={masked} plan {base} "
                            f"(first kernel): max_abs_err={err:.3e} rel="
                            f"{rel:.3e} equal_to_K1_first_kernel_on_the_map="
                            f"{same}")
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
    # each `full` bitwise against the kernel its flags are built on, on
    # both of K1's / K2's / K3's forms: the one K1's / K2's / K3's plan
    # picks (the wgmma form at every group; each variant bitwise on a
    # repeat, its device ms per group) and the first kernel through an
    # explicit _K1_BASE_PLAN / _K2_BASE_PLAN / _K3_BASE_PLAN (K10's device
    # ms too)
    abl = {k: dict(max_abs_err=0.0, plain_ms=0.0, variants={})
           for k in ("K9", "K9-base", "K10", "K10-base", "K11", "K11-base")}
    bounds = {}
    k9_forms = (("K9", None), ("K9-base", attention._K1_BASE_PLAN))
    k10_forms = (("K10", None), ("K10-base", leff._K2_BASE_PLAN))
    k11_forms = (("K11", None), ("K11-base", attention._K3_BASE_PLAN))

    def ablation_entry(kernel, vname, err, res, c, heads):
        entry = abl[kernel]["variants"].setdefault(
            vname, dict(max_abs_err=0.0))
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        abl[kernel]["max_abs_err"] = max(abl[kernel]["max_abs_err"], err)
        bounds.setdefault((kernel, vname), Bound()).add(
            *ablation_work(kernel, vname, res, c, heads))
        return entry

    lib = _build.library()
    for name, c, res, heads in mr.GROUPS:
        args = mr._attn_args(c, res, heads, batch=MEASURE_B)
        plan = mr.ablation_plan(args[0], heads)
        # K9's shared memory on K1's plan as the kernel reports it, against
        # the tool's model
        for variant in range(4):
            got_s = lib.fbanet_attention_ablation_wgmma_smem(
                WS * WS, c, heads, variant, plan[0], plan[2])
            model = mr._ablation_smem(WS * WS, c, heads, variant, plan[0],
                                      plan[2])
            if got_s != model or got_s == 0:
                failures.append(f"K9 {name} variant {variant} plan {plan}: "
                                f"kernel smem {got_s} != model {model}")
        for vname, kw in mr.ATTN_ABLATIONS:
            ref = mr.abl_attention(c, res, heads, **kw)(*args, plain=True)
            if vname == "full":  # the plain version, beside both forms
                pms = time_ms(lambda kw=kw: mr.abl_attention(
                    c, res, heads, **kw)(*args, plain=True), iters=3,
                    repeats=3)
                log(f"K9 plain {name} c{c}@{res} B={MEASURE_B}: "
                    f"plain_ms={pms:.4f}")
            for kernel, kplan in k9_forms:
                fn = mr.abl_attention(c, res, heads, plan=kplan, **kw)
                got, again = fn(*args), fn(*args)
                torch.cuda.synchronize()
                err, rel = rel_err(got, ref)
                finite = bool(torch.isfinite(got).all())
                repeat = torch.equal(got, again)
                entry = ablation_entry(kernel, vname, err, res, c, heads)
                line = (f"{kernel} {vname} {name} c{c}@{res} B={MEASURE_B} "
                        f"bf16 plan {kplan or plan}: max_abs_err={err:.3e} "
                        f"rel={rel:.3e} bitwise_repeat={repeat}")
                if kplan is None:  # the wgmma form's device ms
                    dms = device_ms(lambda fn=fn: fn(*args), traces=3)
                    entry.setdefault("b8", {})[name] = dict(device_ms=dms)
                    line += f" device_ms={dms:.4f}"
                if vname == "full":  # K1 (mask-free, no residual) on the form
                    abl[kernel]["plain_ms"] += pms
                    same = torch.equal(got, attention._attention_launch(
                        *args, None, heads, WS, False, kplan or plan))
                    line += f" bitwise_equal_to_K1={same}"
                    if not same:
                        failures.append(line)
                if vname == "notrans" and kplan is None:  # K1b on the map
                    same = torch.equal(got.view(-1, WS * WS, c),
                                       attention._launch_windows(
                        args[0].view(-1, WS * WS, c), *args[1:], None,
                        heads, 1, plan))
                    line += f" bitwise_equal_to_K1b={same}"
                    if not same:
                        failures.append(line)
                log(line)
                if not (rel <= TOL["bfloat16"]) or not finite or not repeat:
                    failures.append(line)
        args = mr._leff_args(c, res, batch=MEASURE_B)
        plan = mr.leff_plan(args[0], args[3].shape[0])
        for vname, kw in mr.LEFF_ABLATIONS:
            ref = mr.abl_leff(c, res, **kw)(*args, plain=True)
            if vname == "full":  # the plain version, beside both forms
                pms = time_ms(lambda kw=kw: mr.abl_leff(c, res, **kw)(
                    *args, plain=True), iters=3, repeats=3)
                log(f"K10 plain {name} c{c}@{res} B={MEASURE_B}: "
                    f"plain_ms={pms:.4f}")
            for kernel, kplan in k10_forms:
                fn = mr.abl_leff(c, res, plan=kplan, **kw)
                got, again = fn(*args), fn(*args)
                torch.cuda.synchronize()
                err, rel = rel_err(got, ref)
                finite = bool(torch.isfinite(got).all())
                repeat = torch.equal(got, again)
                entry = ablation_entry(kernel, vname, err, res, c, heads)
                line = (f"{kernel} {vname} {name} c{c}@{res} B={MEASURE_B} "
                        f"bf16 plan {kplan or plan}: max_abs_err={err:.3e} "
                        f"rel={rel:.3e} bitwise_repeat={repeat}")
                # the form's device ms
                dms = device_ms(lambda fn=fn: fn(*args), traces=3)
                entry.setdefault("b8", {})[name] = dict(device_ms=dms)
                line += f" device_ms={dms:.4f}"
                if vname == "full":  # K2 (no residual) on the same form
                    abl[kernel]["plain_ms"] += pms
                    same = torch.equal(got, leff._leff_launch(
                        *args, False, kplan or plan))
                    line += f" bitwise_equal_to_K2={same}"
                    if not same:
                        failures.append(line)
                log(line)
                if not (rel <= TOL["bfloat16"]) or not finite or not repeat:
                    failures.append(line)
        args = mb._win_args(c, res, heads, batch=MEASURE_B)
        x, g, *params = args
        plan = mb.ablation_plan(x, heads)
        for vname, kw in mb.BWD_ABLATIONS:
            plain = mb.abl_backward(c, res, heads, **kw)
            ref = plain(*args, plain=True)
            if vname == "full":  # the plain version, beside both forms
                pms = time_ms(lambda: plain(*args, plain=True), iters=3,
                              repeats=3)
                log(f"K11 plain {name} c{c}@{res} B={MEASURE_B}: "
                    f"plain_ms={pms:.4f}")
            for kernel, kplan in k11_forms:
                fn = mb.abl_backward(c, res, heads, plan=kplan, **kw)
                got, again = fn(*args), fn(*args)
                torch.cuda.synchronize()
                errs = _grad_errors(got, ref)
                rel = max(errs)
                err = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(got, ref))
                finite = all(bool(torch.isfinite(a).all()) for a in got)
                repeat = all(torch.equal(a, b) for a, b in zip(got, again))
                entry = ablation_entry(kernel, vname, err, res, c, heads)
                line = (f"{kernel} {vname} {name} c{c}@{res} B={MEASURE_B} "
                        f"bf16 plan {kplan or plan}: max_abs_err={err:.3e} "
                        f"rel={rel:.3e} bitwise_repeat={repeat}")
                if kplan is None:  # the form's device ms, kernels and sums
                    dms = device_ms(lambda fn=fn: fn(*args), traces=3)
                    entry.setdefault("b8", {})[name] = dict(device_ms=dms)
                    line += f" device_ms={dms:.4f}"
                if vname == "full":
                    if kplan is None:  # K3's windowed entry under its plan
                        prod = attention.window_attention_bwd_windows(
                            x, g, *params, None, heads=heads,
                            windows_per_image=1)
                    else:  # K3's first kernel on the map of one window
                        prod = attention._attention_bwd_launch(
                            x.view(-1, WS, WS, c), g.view(-1, WS, WS, c),
                            *params, None, heads, WS, False, kplan)
                    abl[kernel]["plain_ms"] += pms
                    same = all(torch.equal(a.reshape(b.shape), b)
                               for a, b in zip(prod, got))
                    line += f" bitwise_equal_to_K3={same}"
                    if not same:
                        failures.append(line)
                log(line)
                if not (rel <= TOL["bfloat16"]) or not finite or not repeat:
                    failures.append(line)
    if failures:
        raise AssertionError("measurement slice disagrees with its plain "
                             "versions or their base kernels:\n"
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
                               ("K9-base", "abl-attn-base",
                                mr.ATTN_ABLATIONS),
                               ("K10", "abl-leff", mr.LEFF_ABLATIONS),
                               ("K10-base", "abl-leff-base",
                                mr.LEFF_ABLATIONS),
                               ("K11", "ablbwd", mb.BWD_ABLATIONS),
                               ("K11-base", "ablbwd-base", mb.BWD_ABLATIONS)):
        entry = abl[kernel]
        for vname, _kw in table:
            v = entry["variants"][vname]
            lines = {nm.split("/")[1].split(" ")[0]: ms
                     for nm, ms in (rates | bwd).items()
                     if nm.startswith(f"{key}/")
                     and nm.endswith(f" {vname}")}
            v["ms"] = sum(lines.values())
            for group, ms in lines.items():  # per group, where kept
                if group in v.get("b8", {}):
                    v["b8"][group]["ms"] = ms
            if "b8" in v:
                v["device_ms"] = sum(d["device_ms"] for d in v["b8"].values())
            v.update(bounds[(kernel, vname)].fields())
        full = entry["variants"]["full"]
        res[kernel] = dict(max_abs_err=entry["max_abs_err"], ms=full["ms"],
                           plain_ms=entry["plain_ms"],
                           bound_ms=full["bound_ms"],
                           bound_by=full["bound_by"], library_ms=None,
                           variants=entry["variants"])
        if "device_ms" in full:
            res[kernel]["device_ms"] = full["device_ms"]
        log(f"{kernel} at B={MEASURE_B}, summed over the five groups: "
            + "; ".join(f"{v} {d['ms']:.4f} ms" + (
                f" (device {d['device_ms']:.4f})" if "device_ms" in d else "")
                + f" (bound {d['bound_ms']:.4f}, {d['bound_by']})"
                for v, d in entry["variants"].items()))
    return res, launches


def phase_variants(card: str, fwd_ms: float, train_ms: float
                   ) -> tuple[dict, dict]:
    """The kernel-variant slice. K7, every variant the tool times, on both
    of K1's forms (the wgmma form K1's plan picks and the first kernel
    through an explicit _K1_BASE_PLAN, each with its device ms per group)
    against its plain version on the tool's B=8 inputs at the five
    SwinGroup shapes (bf16, TOL); loop_ln, stack3d_ln, ln+qkv1 and ln+nr2
    bitwise against K1 (mask-free, no residual) on the wgmma form, stack3d
    against loop, loop_ln against K1's first kernel on that kernel; each
    core's heads per stage and shared memory on each form as the kernels
    report them;
    K8, every variant, on both of K2's forms (the wgmma form K2's plan
    picks, with its device ms per group, and the first kernel through an
    explicit _K2_BASE_PLAN) against its plain version, and with no flag
    bitwise against K2 on that form (no residual). Then the
    main path, with the counts set to 0 just before and read just after:
    `measure_swin_variants check time` at B=8 and `profile_components` over
    every component at the published sizes. Then mfu_forward / mfu_train
    from the slice's B=8 forward (`fwd_ms`) and the train phase's B=8 step
    (`train_ms`). Returns (per-kernel results, launches)."""
    import torch

    from fbanet_tpu_torch.ops import _build, attention, leff
    from fbanet_tpu_torch.tools import flops_accounting, profile_components
    from fbanet_tpu_torch.tools import measure_swin_rates as mr
    from fbanet_tpu_torch.tools import measure_swin_variants as mv
    from fbanet_tpu_torch.tools.measure_reduce import device_ms

    lib = _build.library()
    n = WS * WS
    failures = []
    res = {k: dict(max_abs_err=0.0, plain_ms=0.0, variants={})
           for k in ("K7", "K7-base", "K8", "K8-base")}
    bounds = {}

    def compare(kernel, vname, line, got, ref, prod, base, work):
        err, rel = rel_err(got, ref)
        entry = res[kernel]["variants"].setdefault(vname, dict(max_abs_err=0.0))
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        res[kernel]["max_abs_err"] = max(res[kernel]["max_abs_err"], err)
        bounds.setdefault((kernel, vname), Bound()).add(*work)
        same = torch.equal(got, prod)
        line += (f": max_abs_err={err:.3e} rel={rel:.3e} bitwise_equal_to_"
                 f"{base}={same}")
        if not (rel <= TOL["bfloat16"]) or not torch.isfinite(got).all():
            failures.append(line)
        return line, same

    # K7's cores that the wgmma form holds bitwise equal to K1 (mask-free,
    # no residual) on it, and stack3d to loop; on the first kernel loop_ln
    k7_bitwise = {"K7": ("loop_ln", "stack3d_ln", "ln+qkv1", "ln+nr2"),
                  "K7-base": ("loop_ln",)}
    for name, c, r, heads in mr.GROUPS:
        args = mr._attn_args(c, r, heads, batch=MEASURE_B)
        plan = attention._attention_plan(
            MEASURE_B, r, r, c, heads, WS, True,
            smem=attention._kernel_attention_smem)
        # heads per stage and shared memory of every core, on each form, as
        # the kernels report them (the wgmma form's against the tool's
        # models)
        forms = {}
        for core, cid in mv._CORE_IDS.items():
            kp = mv.attention_plan(args[0], heads, core)
            got_w = (lib.fbanet_attention_variant_wgmma_stage(
                n, c, heads, cid, plan[0], plan[2]),
                lib.fbanet_attention_variant_wgmma_smem(
                n, c, heads, cid, plan[0], plan[2]))
            model = (mv.heads_per_stage(core, c, heads, plan[0])
                     if got_w[1] else 0,
                     mv._variant_smem(n, c, heads, cid, plan[0], plan[2]))
            forms[core] = dict(
                plan=kp, wgmma=got_w,
                base=(lib.fbanet_attention_variant_chunk(n, c, heads, cid),
                      lib.fbanet_attention_variant_smem(n, c, heads, cid)))
            if got_w != model:
                failures.append(f"K7 {name} {core}: the wgmma form reports "
                                f"{got_w}, the tool's model {model}")
        line = (f"K7 {name} c{c}@{r} heads={heads} plan {plan}: (heads per "
                f"stage, shared memory bytes) by core on the wgmma form "
                f"{ {k: v['wgmma'] for k, v in forms.items()} }, on the first "
                f"kernel { {k: v['base'] for k, v in forms.items()} }")
        if heads % 2 == 0:
            lp = forms["lanepack"]
            where = "wgmma form" if lp["plan"][0] else "first kernel"
            line += (f"; lanepack runs on the {where} "
                     f"({lp['wgmma'][1] or 'does not fit'} of 232448 bytes "
                     f"on the wgmma form)")
        cases = mv.attention_cases(name, c, r, heads)
        if any(forms[kw["core"]]["base"][0] == 0 for _v, kw in cases):
            failures.append(line + ": a core the tool runs does not fit")
        log(line)
        k1 = {"K7": (attention._attention_launch(
                  *args, None, heads, WS, False, plan), f"K1_plan_{plan}"),
              "K7-base": (attention._attention_launch(
                  *args, None, heads, WS, False, attention._K1_BASE_PLAN),
                  "K1_first_kernel")}
        loops = {}
        for vname, kw in cases:
            kw = dict(kw)
            core = kw.pop("core")
            ref = mv.variant_attention(c, r, heads, core, **kw)(
                *args, plain=True)
            if vname == "loop":
                loop = mv.variant_attention(c, r, heads, "loop")
                pms = time_ms(lambda: loop(*args, plain=True), iters=3,
                              repeats=3)
                log(f"K7 plain {name} c{c}@{r} B={MEASURE_B}: "
                    f"plain_ms={pms:.4f}")
            for kernel, kplan in (("K7", None),
                                  ("K7-base", attention._K1_BASE_PLAN)):
                fn = mv.variant_attention(c, r, heads, core, plan=kplan, **kw)
                got = fn(*args)
                torch.cuda.synchronize()
                line, same = compare(
                    kernel, vname, f"{kernel} {vname} {name} c{c}@{r} "
                    f"B={MEASURE_B} bf16 plan "
                    f"{kplan or mv.attention_plan(args[0], heads, core)}",
                    got, ref, *k1[kernel],
                    attention_work(r, c, heads, False, batch=MEASURE_B))
                # the form's device ms
                dms = device_ms(lambda fn=fn: fn(*args), traces=3)
                res[kernel]["variants"][vname].setdefault(
                    "b8", {})[name] = dict(device_ms=dms)
                line += f" device_ms={dms:.4f}"
                if vname in ("loop", "stack3d"):
                    loops.setdefault(kernel, {})[vname] = got
                if vname == "loop":
                    res[kernel]["plain_ms"] += pms
                if vname in k7_bitwise[kernel] and not same:
                    failures.append(line)
                log(line)
        for kernel, outs in loops.items():
            if kernel == "K7" and "stack3d" in outs:
                same = torch.equal(outs["stack3d"], outs["loop"])
                log(f"K7 stack3d {name}: bitwise_equal_to_loop={same}")
                if not same:
                    failures.append(f"K7 stack3d {name} differs from loop")
        la = mr._leff_args(c, r, batch=MEASURE_B)
        plan = mv.variant_plan(la[0], la[3].shape[0])
        # K2 with no residual on each form: K8's `prod` on it
        k2 = {"K8": (leff._leff_launch(*la, False, plan), f"K2_plan_{plan}"),
              "K8-base": (leff._leff_launch(*la, False, leff._K2_BASE_PLAN),
                          "K2_first_kernel")}
        for vname, kw in [("prod", {})] + list(mv.LEFF_VARIANTS.items()):
            ref = mv.variant_leff(c, r, **kw)(*la, plain=True)
            if vname == "prod":
                pms = time_ms(lambda kw=kw: mv.variant_leff(c, r, **kw)(
                    *la, plain=True), iters=3, repeats=3)
                log(f"K8 plain {name} c{c}@{r} B={MEASURE_B}: "
                    f"plain_ms={pms:.4f}")
            for kernel, kplan in (("K8", None),
                                  ("K8-base", leff._K2_BASE_PLAN)):
                fn = mv.variant_leff(c, r, plan=kplan, **kw)
                got = fn(*la)
                torch.cuda.synchronize()
                line, same = compare(
                    kernel, vname, f"{kernel} {vname} {name} c{c}@{r} "
                    f"B={MEASURE_B} bf16 plan {kplan or plan}", got, ref,
                    *k2[kernel], leff_work(r, c, batch=MEASURE_B))
                if kplan is None:  # the wgmma form's device ms
                    dms = device_ms(lambda fn=fn: fn(*la), traces=3)
                    res[kernel]["variants"][vname].setdefault(
                        "b8", {})[name] = dict(device_ms=dms)
                    line += f" device_ms={dms:.4f}"
                if vname == "prod":
                    res[kernel]["plain_ms"] += pms
                    if not same:
                        failures.append(line)
                log(line)
    if failures:
        raise AssertionError("variant slice disagrees with its plain versions "
                             "or their base kernels:\n"
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

    k1_ms = {pre: sum(ms for nm, ms in timed.items()
                      if nm.startswith(f"{pre}/") and nm.endswith(" prod"))
             for pre in ("var", "var-base")}
    for kernel, prefix, rep, beside in (
            ("K7", "var", "loop", f" (K1's wgmma form at the five: "
             f"{k1_ms['var']:.4f} ms)"),
            ("K7-base", "var-base", "loop", f" (K1's first kernel at the "
             f"five: {k1_ms['var-base']:.4f} ms)"),
            ("K8", "leffvar", "prod", " (prod: K2's wgmma form)"),
            ("K8-base", "leffvar-base", "prod", " (prod: K2's first kernel)")):
        entry = res[kernel]
        for vname, v in entry["variants"].items():
            lines = {nm.split("/")[1].split(" ")[0]: ms
                     for nm, ms in timed.items()
                     if nm.startswith(f"{prefix}/")
                     and nm.endswith(f" {vname}")}
            v["ms"] = sum(lines.values())
            if "b8" in v:
                for group, ms in lines.items():
                    v["b8"][group]["ms"] = ms
                v["device_ms"] = sum(d["device_ms"] for d in v["b8"].values())
            v.update(bounds[(kernel, vname)].fields())
        entry.update(ms=entry["variants"][rep]["ms"],
                     bound_ms=entry["variants"][rep]["bound_ms"],
                     bound_by=entry["variants"][rep]["bound_by"],
                     library_ms=None)
        if "device_ms" in entry["variants"][rep]:
            entry["device_ms"] = entry["variants"][rep]["device_ms"]
        log(f"{kernel} at B={MEASURE_B}, summed over the groups each ran"
            f"{beside}: "
            + "; ".join(f"{v} {d['ms']:.4f} ms" + (
                f" (device {d['device_ms']:.4f})" if "device_ms" in d else "")
                + f" (bound {d['bound_ms']:.4f}, {d['bound_by']})"
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

    return {"K1": attention.fused_window_attention_2d.wgmma,
            "K1-narrow": attention.fused_window_attention_2d.narrow,
            "K1-base": attention.fused_window_attention_2d.base,
            "K2": leff._leff_launch.wgmma, "K2-base": leff._leff_launch.base,
            "K3": attention._attention_bwd_launch.wgmma,
            "K3-narrow": attention._attention_bwd_launch.narrow,
            "K3-base": attention._attention_bwd_launch.base,
            "K4": leff._leff_bwd_launch.wgmma,
            "K4-base": leff._leff_bwd_launch.base, "R1": reduce.token_matmul,
            "R2": reduce.column_sum,
            "K5": warp_kernels.warp_burst_bilinear,
            "K6": warp_kernels.warp_burst_coords,
            "K1b": attention.fused_window_attention,
            "K9": measure_swin_rates.ablation_attention.wgmma,
            "K9-base": measure_swin_rates.ablation_attention.base,
            "K10": measure_swin_rates.ablation_leff.wgmma,
            "K10-base": measure_swin_rates.ablation_leff.base,
            "K11": measure_bwd.ablation_backward.wgmma,
            "K11-base": measure_bwd.ablation_backward.base,
            "K7": measure_swin_variants.attention_variant.wgmma,
            "K7-base": measure_swin_variants.attention_variant.base,
            "K8": measure_swin_variants.leff_variant.wgmma,
            "K8-base": measure_swin_variants.leff_variant.base}


def _device_ms(events) -> tuple[float, dict]:
    """(total device ms of a profile, device ms of the port's kernels by
    name). A user annotation's span on the device timeline (such as
    torch's `Optimizer.step#AdamW.step`) covers kernels counted in their
    own rows and is left out."""
    total, ours = 0.0, {}
    for e in events:
        if "CUDA" not in str(e.device_type) or getattr(
                e, "is_user_annotation", False):  # kernels only
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        total += us
        for key in ("attention_bwd_wgmma", "window_attention_bwd",
                    "attention_wgmma_kernel", "window_attention_bf16",
                    "leff_wgmma", "leff_bwd",
                    "leff_ln_bwd", "leff_bf16", "token_matmul",
                    "column_sum", "warp_homography", "warp_coords"):
            if key in e.key:
                ours[key] = ours.get(key, 0.0) + us / 1e3
    return total / 1e3, ours


def phase_train(card: str) -> tuple[dict, float]:
    """The training path at the published width: FBANet-64 (14 frames,
    160 px, window 8, bf16 compute, f32 parameters, drop_path 0.1), random
    weights from a seed, AdamW at lr 1e-4, B=8 synthetic bursts with HR
    targets, 5 steps of `train.make_train_step`. Checks finite losses, that
    every parameter moved, and 20 launches per step of each of K1-K4 (none
    of K1's first kernel). Then one f32 step at B=2 holds every parameter
    gradient of the kernel path against the plain path, and the B=8 step is
    timed against the plain versions and profiled. Returns the launch
    counts of the 5 steps and of the f32 step's kernel path (K1's, K2's and
    K3's first kernels run there), and the B=8 step's ms."""
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
    for name in ("K1", "K2", "K3", "K4", "K1-base", "K4-base"):
        counts = [s[name] for s in per_step]
        per = 0 if name.endswith("-base") else layers
        if counts != [per * (i + 1) for i in range(5)]:
            raise AssertionError(f"{name}: cumulative launches {counts} over "
                                 f"5 steps, expected {per} per step")
    still = [n for n, p in model.named_parameters()
             if torch.equal(p.detach(), before[n])]
    if still:
        raise AssertionError(f"parameters that did not move: {still}")
    del before

    # f32, B=2: every parameter gradient, kernels against plain versions.
    # The kernel path's launches count as a path of their own: in f32 the
    # plans send K1, K2 and K3 to their first kernels, 20 launches each
    cfg32 = cfg.replace(dtype="float32")
    m32 = create_model(cfg32, device="cuda", seed=0)
    m32.load_state_dict(state, strict=True)
    grads = []
    for c in counters.values():
        c.launches = 0
    for plain in (False, True):
        m32.zero_grad(set_to_none=True)
        loss_fn = make_train_step(m32, None, tcfg, plain=plain).loss_fn
        loss_fn(lr8[:2], hr8[:2],
                torch.Generator(device="cuda").manual_seed(11)).backward()
        grads.append({n: p.grad.clone() for n, p in m32.named_parameters()
                      if p.grad is not None})
    f32_launches = {k: c.launches for k, c in counters.items()}
    log(f"train f32 B=2 step: launches {f32_launches}")
    for name in ("K1-base", "K2-base", "K3-base", "K4-base"):
        if f32_launches[name] != layers:
            raise AssertionError(f"{name}: {f32_launches[name]} launches in "
                                 f"the f32 step, expected {layers}")
    launches = {k: v + f32_launches[k] for k, v in launches.items()}
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
    k3 = ours.get("attention_bwd_wgmma", 0.0) + ours.get(
        "window_attention_bwd", 0.0)
    k2 = ours.get("leff_wgmma", 0.0) + ours.get("leff_bf16", 0.0)
    k1 = ours.get("attention_wgmma_kernel", 0.0) + ours.get(
        "window_attention_bf16", 0.0)
    log(f"train B=8 profile: device {total:.3f} ms, port kernels (ms) "
        f"{ {k: round(v, 3) for k, v in ours.items()} }; K1 "
        f"(attention_wgmma_kernel + window_attention_bf16) {k1:.3f} ms, K3 "
        f"(attention_bwd_wgmma + window_attention_bwd) {k3:.3f} ms, K2 "
        f"(leff_wgmma + leff_bf16) {k2:.3f} ms, K4 (leff_bwd + leff_ln_bwd) "
        f"{k4:.3f} ms")
    return launches, ms

# the trainer phase: a RealBSR tree on disk, at the published width
TRAINER_BURSTS = {"train": 16, "test": 8}
TRAINER_LR = 192  # LR px of the tree (HR 768); the model crops 160
TRAINER_EVAL_DB = 1e-3  # evaluate.main vs the best epoch's PSNR


@contextlib.contextmanager
def deterministic():
    """`torch.use_deterministic_algorithms` (warn only),
    `cudnn.deterministic`, no cuDNN autotuning; the settings before are put
    back after. cuBLAS's workspace for it is fixed at the top of main()."""
    import torch

    cudnn = torch.backends.cudnn
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.utils.deterministic.fill_uninitialized_memory,
             cudnn.deterministic, cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.utils.deterministic.fill_uninitialized_memory = saved[2]
        cudnn.deterministic, cudnn.benchmark = saved[3], saved[4]


def _trainer_argv(root, save, *extra):
    return ["--dataroot", str(root), "--embed_dim", "64", "--train_ps", "160",
            "--burst_size", "14", "--batch_size", "8", "--nepoch", "2",
            "--dtype", "bfloat16", "--save_dir", str(save),
            "--train_workers", "16", "--eval_workers", "8",
            "--device", "cuda", *extra]


def phase_trainer(card: str) -> tuple[dict, Path]:
    """The entry points that read a dataset, at FBANet-64 (14 frames, 160 px
    crops, B=8, bf16, drop_path 0.1), from a synthetic RealBSR tree written
    to disk through `data/png.py`: 16 train and 8 test bursts of 14 frames
    at 192 px (HR 768), `aligned` layout.

    Prints the decoder the dataset uses and why the native pool is or is
    not there, cold-decode and cached bursts/s through the loader. Run A:
    `train.main` for 2 epochs of 2 steps, each followed by an eval of the 8
    test bursts. Run B: the same command stopped after 1 step (the config's
    `stop_after_steps`, which no CLI flag sets), then `--resume`. Both under
    `torch.use_deterministic_algorithms` and `cudnn.deterministic`. Checks
    finite losses, 20 launches of each of K1-K4 per train step and of K1
    and K2 per eval forward (their wgmma forms; none of K1's first kernel),
    run B's parameters and per-epoch PSNRs bit-equal to run A's,
    `evaluate.main` on A's `model_best` within TRAINER_EVAL_DB of the best
    epoch's PSNR, and `tiled.main` (psize 80, overlap 40) on a GT-free
    160 px burst: a finite [640, 640, 3] image. Prints ms per train step
    from disk (median of run A's steps after the first), the data_wait
    share, eval bursts/s. Returns the launch counts of the phase and the
    tree's directory (the ddp phase trains from it, then removes it)."""
    import argparse
    import shutil
    import tempfile
    import warnings

    import numpy as np
    import torch

    from fbanet_tpu_torch import evaluate as E
    from fbanet_tpu_torch import tiled as TL
    from fbanet_tpu_torch import train as T
    from fbanet_tpu_torch.config import add_cli_args, from_cli
    from fbanet_tpu_torch.data import native_io, png
    from fbanet_tpu_torch.data.loader import BurstLoader
    from fbanet_tpu_torch.data.realbsr import RealBSRDataset
    from fbanet_tpu_torch.data.synthetic import write_synthetic_realbsr

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="trainer_", dir=ROOT / "build"))
    root, tiles_root = tmp / "realbsr", tmp / "tiled"
    t0 = time.perf_counter()
    for seed, (split, n) in enumerate(TRAINER_BURSTS.items()):
        write_synthetic_realbsr(root, num_bursts=n, num_frames=14,
                                lr_size=TRAINER_LR, splits=(split,),
                                seed=seed, level=1)
    write_synthetic_realbsr(tiles_root, num_bursts=1, num_frames=14,
                            lr_size=160, splits=("test",), write_hr=False,
                            seed=2, level=1)
    log(f"trainer: wrote {sum(TRAINER_BURSTS.values())} bursts of 14 x "
        f"{TRAINER_LR}^2 (HR {4 * TRAINER_LR}^2) and one GT-free 160^2 "
        f"burst in {time.perf_counter() - t0:.2f} s")

    # the decode rates, through the loader's 16 workers, no device
    ds_kw = dict(split="train", burst_size=14, crop_size=160,
                 wire_dtype="storage")
    cold = RealBSRDataset(root, cache_decoded=False, **ds_kw)
    t0 = time.perf_counter()
    n = sum(len(b["burst_name"]) for b in BurstLoader(
        cold, batch_size=8, num_workers=16).epoch(0))
    cold_rate = n / (time.perf_counter() - t0)
    cached = RealBSRDataset(root, cache_decoded=True, **ds_kw)
    cached.warm_cache()
    t0 = time.perf_counter()
    n = sum(len(b["burst_name"]) for b in BurstLoader(
        cached, batch_size=8, num_workers=16).epoch(1))
    cached_rate = n / (time.perf_counter() - t0)
    log(f"trainer: decoder {cold.decoder!r}; native pool unavailable "
        f"because: {native_io.unavailable_reason()}")
    log(f"trainer: loader on {card}'s host: cold decode {cold_rate:.2f} "
        f"bursts/s, cached {cached_rate:.2f} bursts/s (B=8, 16 workers, "
        f"14 x 160^2 crops + 640^2 HR, storage wire)")

    layers = 20
    counters = _counters()

    def run(fn, *args, **kw):
        for c in counters.values():
            c.launches = 0
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        return out, {k: c.launches for k, c in counters.items()}

    def check_launches(what, got, steps, forwards):
        want = {"K1": layers * (steps + forwards),
                "K2": layers * (steps + forwards), "K3": layers * steps,
                "K4": layers * steps, "K1-base": 0, "K4-base": 0}
        bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
        if bad:
            raise AssertionError(f"trainer {what}: launches (got, expected) "
                                 f"{bad} for {steps} train steps and "
                                 f"{forwards} eval forwards")

    with deterministic(), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        res_a, la = run(T.main, _trainer_argv(root, tmp / "a"))
        secs_a = time.perf_counter() - t0
        hist_a = res_a["history"]
        steps_a = sum(h["steps"] for h in hist_a)
        check_launches("run A", la, steps_a, len(hist_a))
        cfg_b = from_cli(add_cli_args(argparse.ArgumentParser())
                         .parse_args(_trainer_argv(root, tmp / "b")))
        res_s, ls = run(T.train, cfg_b.replace(
            train=cfg_b.train.replace(stop_after_steps=1)), device="cuda")
        check_launches("run B, stop", ls, 1, 0)
        res_b, lb = run(T.main, _trainer_argv(root, tmp / "b",
                                               "--resume"))
        check_launches("run B, resume", lb, 3, 2)
    reasons = sorted({str(w.message).splitlines()[0][:160] for w in caught
                      if "deterministic" in str(w.message)})

    losses = [h["loss"] for h in hist_a + res_s["history"] + res_b["history"]]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"trainer: non-finite epoch loss {losses}")
    psnr_a = [h["psnr"] for h in hist_a]
    psnr_b = [h["psnr"] for h in res_b["history"]]
    diffs = {k: float((v.float() - res_b["params"][k].float()).abs().max())
             for k, v in res_a["params"].items()}
    unequal = [k for k, v in res_a["params"].items()
               if not torch.equal(v, res_b["params"][k])]
    log(f"trainer run A ({secs_a:.1f} s): epoch PSNR {psnr_a}, loss "
        f"{[h['loss'] for h in hist_a]}, decoder {res_a['decoder']!r}; "
        f"run B (stop at 1 step, resume): PSNR {psnr_b}; parameters "
        f"bit-equal to A: {len(diffs) - len(unequal)} of {len(diffs)} "
        f"(max |diff| {max(diffs.values()):.3e}); non-deterministic-op "
        f"warnings: {reasons or 'none'}")
    if unequal or psnr_a != psnr_b:
        raise AssertionError(f"trainer: resume differs from the "
                             f"uninterrupted run: PSNR {psnr_a} vs {psnr_b}, "
                             f"{len(unequal)} tensors differ (first "
                             f"{unequal[:3]}); warnings {reasons}")

    step_s = [t for h in hist_a for t in h["step_s"]]
    waits = [w for h in hist_a for w in h["data_wait_s"][:len(h["step_s"])]]
    step_ms = statistics.median(step_s[1:]) * 1e3
    wait_share = sum(waits[1:]) / (sum(waits[1:]) + sum(step_s[1:]))
    log(f"trainer on {card}: {step_ms:.2f} ms per train step from disk "
        f"(median of run A's {len(step_s) - 1} steps after the first; "
        f"steps {[round(t * 1e3, 2) for t in step_s]} ms), data_wait share "
        f"{100 * wait_share:.2f} % (waits "
        f"{[round(w * 1e3, 3) for w in waits]} ms)")

    best = Path(res_a["model_dir"]) / "model_best"
    ev, le = run(E.main, [*_trainer_argv(root, tmp / "a"), "--weights",
                          str(best)])
    check_launches("evaluate", le, 0, 1)
    gap = abs(ev["psnr"] - res_a["best_psnr"])
    log(f"trainer evaluate.main on model_best: PSNR {ev['psnr']:.4f} dB vs "
        f"the best epoch's {res_a['best_psnr']:.4f} (|diff| {gap:.2e}, limit "
        f"{TRAINER_EVAL_DB}); {ev['num_images']} bursts in "
        f"{ev['seconds']:.3f} s = {ev['num_images'] / ev['seconds']:.2f} "
        f"eval bursts/s on {card} (loader decode included)")
    if not gap <= TRAINER_EVAL_DB:
        raise AssertionError(f"trainer: evaluate PSNR {ev['psnr']} vs best "
                             f"epoch {res_a['best_psnr']}")

    outs = []
    real = TL.tiled_forward

    def spy(*args, **kw):
        outs.append(real(*args, **kw))
        return outs[-1]

    TL.tiled_forward = spy
    try:
        written, lt = run(TL.main, [
            "--dataroot", str(tiles_root), "--weights", str(best),
            "--psize", "80", "--overlap", "40", "--embed_dim", "64",
            "--burst_size", "14", "--dtype", "bfloat16",
            "--result_dir", str(tmp / "tiled_out"), "--device", "cuda"])
    finally:
        TL.tiled_forward = real
    check_launches("tiled", lt, 0, 1)
    sr = outs[0]
    head = png.read_header(written[0])
    log(f"trainer tiled.main: {written[0].name} {head[:2]} px, output "
        f"{sr.shape}, finite {bool(np.isfinite(sr).all())}, range "
        f"[{sr.min():.4f}, {sr.max():.4f}]")
    if sr.shape != (640, 640, 3) or not np.isfinite(sr).all() or \
            head[:2] != (640, 640):
        raise AssertionError(f"trainer: tiled output {sr.shape}, header "
                             f"{head}")
    shutil.rmtree(tmp / "a", ignore_errors=True)
    shutil.rmtree(tmp / "b", ignore_errors=True)
    return {k: la[k] + ls[k] + lb[k] + le[k] + lt[k] for k in la}, tmp


# the ddp phase: steps of the NCCL world-1 comparison, and the two-rank
# gloo run's limit (the train phase's f32 gradient limit, TRAIN_GRAD_TOL)
DDP_STEPS = 3  # checked bit for bit against the plain steps
DDP_TIMED = 8  # then timed, each side
DDP_EVAL_DB = 1e-3  # torchrun evaluate vs the plain model's eval PSNR


def _torchrun(nproc: int, *args: str, timeout: int = 600):
    """`python -m torch.distributed.run --standalone` with `nproc` ranks on
    this host; raises with its output when it fails. Returns (stdout,
    seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc), *args], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT)}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:  # torchrun stops its ranks on SIGTERM
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                proc.kill()
    if proc.returncode != 0:
        raise RuntimeError(f"torchrun {' '.join(args[:2])} exited "
                           f"{proc.returncode}:\n{out[-3000:]}\n"
                           f"{err[-6000:]}")
    return out, time.perf_counter() - t0


def phase_ddp(card: str, tree_dir: Path) -> dict:
    """Data parallelism on the card (parallel/mesh.py, DDP in
    `train.make_train_step`):

    1. A NCCL process group of world 1 in this process (torchrun's
       environment set by hand) and FBANet-64 at B=8 (14 frames, 160 px,
       bf16, drop_path 0.1) under DistributedDataParallel: DDP_STEPS AdamW
       steps, each beside the same step of a second copy without DDP (the
       same state, inputs and generators), under `deterministic()`. The
       parameters after the steps must be bit-equal; each DDP step launches
       20 of each of K1-K4 and none of K1's first kernel. Then DDP_TIMED
       more steps of each, alternating, under the default settings: prints
       the median ms of the DDP step and of the plain step, and the
       gradient bytes all-reduced per step.
    2. `torchrun --nproc_per_node 1 -m fbanet_tpu_torch.train` for one
       epoch on the trainer phase's tree, then `torchrun ... -m
       fbanet_tpu_torch.evaluate` on its `model_best`: the checkpoint has
       no `module.` prefix, loads with strict=True into a plain
       `create_model`, and `evaluate.evaluate` of that model here gives the
       torchrun evaluation's PSNR within DDP_EVAL_DB. Whether the ranks
       rebuilt the kernels (the library's mtime) is printed.
    3. `phase_ranks`: one f32 step over two ranks on this card over gloo
       (NCCL refuses two ranks on one GPU) against one process.

    Returns the launch counts of 1's DDP steps (the phase's main path)."""
    import argparse
    import shutil

    import torch

    from fbanet_tpu_torch import evaluate as E
    from fbanet_tpu_torch.config import TrainConfig, add_cli_args, from_cli
    from fbanet_tpu_torch.models import ModelConfig, create_model
    from fbanet_tpu_torch.ops import _build
    from fbanet_tpu_torch.parallel import mesh
    from fbanet_tpu_torch.train import (
        make_optimizer,
        make_train_step,
        step_generator,
    )
    from fbanet_tpu_torch.utils.checkpoint import load_checkpoint
    from fbanet_tpu_torch.utils.weights import random_state_dict

    # 1. NCCL, world 1, DDP against no DDP
    cfg = ModelConfig(num_frames=14, img_size=160, embed_dim=64,
                      window_size=8, dtype="bfloat16", drop_path_rate=0.1)
    tcfg = TrainConfig(batch_size=8, lr_initial=1e-4, optimizer="adamw")
    state = random_state_dict(create_model(cfg, device="cpu", seed=0),
                              seed=2)
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(mesh.free_port())}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        world, dev = mesh.init("cuda")
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    counters = _counters()
    try:
        log(f"ddp: process group {world.backend}, world {world.size}, rank "
            f"{world.rank} on {dev}")
        if (world.backend, world.size) != ("nccl", 1):
            raise AssertionError(f"ddp: expected a NCCL world of 1, got "
                                 f"{world}")
        models, steps = [], []
        for wrapped in (False, True):
            m = create_model(cfg, device=dev, seed=0)
            m.load_state_dict(state, strict=True)
            models.append(m)
            steps.append(make_train_step(
                m, make_optimizer(m.parameters(), tcfg), tcfg,
                world=world if wrapped else None))
        if steps[0].ddp is not None or steps[1].ddp is None:
            raise AssertionError("ddp: the step did not wrap the model in "
                                 "DistributedDataParallel")
        n_params = sum(p.numel() for p in models[1].parameters()
                       if p.requires_grad)
        reduced = sum(p.numel() * p.element_size()
                      for p in models[1].parameters() if p.requires_grad)
        lr_np, hr_np = make_realistic_bursts(8, 14, 160, seed=30, hr_scale=4)
        lr8, hr8 = (torch.from_numpy(lr_np).to(dev),
                    torch.from_numpy(hr_np).to(dev))
        ddp_launches = {k: 0 for k in counters}

        def one_step(wrapped, i):
            for c in counters.values():
                c.launches = 0
            gen = step_generator(tcfg.seed, 1, i, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(steps[wrapped](lr8, hr8, gen, tcfg.lr_initial))
            torch.cuda.synchronize()
            if not math.isfinite(loss):
                raise AssertionError(f"ddp: loss {loss}")
            return (time.perf_counter() - t0) * 1e3

        with deterministic():
            for i in range(DDP_STEPS):
                for wrapped in (False, True):
                    one_step(wrapped, i)
                    if wrapped:
                        got = {k: c.launches for k, c in counters.items()}
                        want = {"K1": 20, "K2": 20, "K3": 20, "K4": 20,
                                "K1-base": 0, "K4-base": 0}
                        bad = {k: (got[k], v) for k, v in want.items()
                               if got[k] != v}
                        if bad:
                            raise AssertionError(f"ddp step {i}: launches "
                                                 f"(got, expected) {bad}")
                        for k, v in got.items():
                            ddp_launches[k] += v
        plain_p = dict(models[0].named_parameters())
        unequal = [n for n, p in models[1].named_parameters()
                   if not torch.equal(p, plain_p[n])]
        # the timing: more steps, alternating, under the default settings
        times = {False: [], True: []}
        for i in range(DDP_STEPS, DDP_STEPS + DDP_TIMED):
            for wrapped in ((False, True) if i % 2 else (True, False)):
                times[wrapped].append(one_step(wrapped, i))
        ddp_ms, plain_ms = (statistics.median(times[True]),
                            statistics.median(times[False]))
        log(f"ddp on {card}: NCCL world 1, {DDP_STEPS} steps of FBANet-64 at "
            f"B=8 under DDP vs without (deterministic algorithms): "
            f"parameters bit-equal {len(plain_p) - len(unequal)} of "
            f"{len(plain_p)}; then {DDP_TIMED} more of each, alternating, "
            f"default settings: step ms DDP "
            f"{[round(t, 2) for t in times[True]]} (median {ddp_ms:.2f}), "
            f"plain {[round(t, 2) for t in times[False]]} (median "
            f"{plain_ms:.2f}); DDP overhead {ddp_ms - plain_ms:+.2f} ms "
            f"({100 * (ddp_ms / plain_ms - 1):+.2f} %); all-reduced per "
            f"step: {n_params} f32 parameters, {reduced} bytes "
            f"({reduced / 1e6:.1f} MB); launches of the {DDP_STEPS} "
            f"checked DDP steps "
            f"{ {k: v for k, v in ddp_launches.items() if v} }")
        if unequal:
            raise AssertionError(f"ddp: {len(unequal)} parameters differ "
                                 f"from the plain steps (first "
                                 f"{unequal[:3]})")
        del models, steps
    finally:
        world.close()
    torch.cuda.empty_cache()

    # 2. torchrun at world 1: train.main one epoch, then evaluate.main
    lib = _build.build()
    mtime = lib.stat().st_mtime
    root = tree_dir / "realbsr"
    argv = _trainer_argv(root, tree_dir / "ddp")
    argv[argv.index("--nepoch") + 1] = "1"
    out, secs = _torchrun(1, "-m", "fbanet_tpu_torch.train", *argv)
    epoch_lines = [ln for ln in out.splitlines() if ln.startswith(("[Ep",
                                                                   "Epoch"))]
    best = tree_dir / "ddp" / "log" / "BaseModel_" / "models" / "model_best"
    ckpt = load_checkpoint(best)
    prefixed = [k for k in ckpt["params"] if k.startswith("module.")]
    if prefixed:
        raise AssertionError(f"ddp: checkpoint names with DDP's prefix: "
                             f"{prefixed[:3]}")
    plain = create_model(cfg, device="cuda", seed=0)
    plain.load_state_dict(ckpt["params"], strict=True)
    del plain
    ev_out, ev_secs = _torchrun(1, "-m", "fbanet_tpu_torch.evaluate", *argv,
                                "--weights", str(best))
    ev_line = [ln for ln in ev_out.splitlines() if ln.startswith("PSNR:")]
    if len(ev_line) != 1:
        raise AssertionError(f"ddp: torchrun evaluate printed {ev_line}")
    tr_psnr = float(ev_line[0].split()[1])
    ecfg = from_cli(add_cli_args(argparse.ArgumentParser())
                    .parse_args([*argv, "--weights", str(best)]))
    here = E.evaluate(ecfg, device="cuda")
    gap = abs(tr_psnr - here["psnr"])
    log(f"ddp torchrun world 1 on {card}: train.main 1 epoch in {secs:.1f} s "
        f"(process included) -> {epoch_lines}; checkpoint best PSNR "
        f"{ckpt['best_psnr']:.4f}, {len(ckpt['params'])} tensors, no "
        f"`module.` prefix, loads strict into create_model; torchrun "
        f"evaluate.main {ev_secs:.1f} s: {ev_line[0]}; the plain model here "
        f"{here['psnr']:.4f} dB (|diff| {gap:.2e}, limit {DDP_EVAL_DB}); "
        f"kernels rebuilt by the ranks: {lib.stat().st_mtime != mtime}")
    if not gap <= DDP_EVAL_DB or not abs(ckpt["best_psnr"] - here["psnr"]) \
            <= DDP_EVAL_DB:
        raise AssertionError(f"ddp: torchrun eval {tr_psnr}, checkpoint "
                             f"{ckpt['best_psnr']}, plain model "
                             f"{here['psnr']}")

    # 3. several ranks, one f32 step, against one process
    phase_ranks(card, tree_dir / "ranks")
    shutil.rmtree(tree_dir, ignore_errors=True)
    return ddp_launches


def phase_ranks(card: str, work: Path) -> None:
    """One f32 step of FBANet-64 (14 frames, 160 px, drop_path 0) on a
    global batch of 8 over several ranks, `python -m torch.distributed.run
    -m fbanet_tpu_torch.parallel.dryrun DIR steps`, against the
    one-process step on the same 8 rows here: the loss within 1e-5
    relative, every parameter gradient within TRAIN_GRAD_TOL of its
    tensor's max |grad| (f32 sums in another order, the train phase's
    gradient check), every rank's parameters bit-equal. With one card, two
    ranks on it over gloo (NCCL refuses two ranks on one GPU); with W > 1
    cards (`python3 chip_smoke.py ranks` on a four-card machine), W ranks
    over NCCL, one a card."""
    import torch

    from fbanet_tpu_torch.config import TrainConfig
    from fbanet_tpu_torch.models import ModelConfig, create_model
    from fbanet_tpu_torch.train import make_optimizer, make_train_step
    from fbanet_tpu_torch.utils.weights import random_state_dict

    cards = torch.cuda.device_count()
    nproc, backend, device = ((cards, "nccl", "cuda") if cards > 1
                              else (2, "gloo", "cuda:0"))
    cfg32 = ModelConfig(num_frames=14, img_size=160, embed_dim=64,
                        window_size=8, dtype="float32", drop_path_rate=0.0)
    state = random_state_dict(create_model(cfg32, device="cpu", seed=0),
                              seed=2)
    lr_np, hr_np = make_realistic_bursts(8, 14, 160, seed=30, hr_scale=4)
    work.mkdir(parents=True)
    mc = {f: getattr(cfg32, f) for f in ("num_frames", "img_size",
                                         "embed_dim", "window_size",
                                         "dtype", "drop_path_rate")}
    case = {"name": "f32", "train": {"lr_initial": 1e-4},
            "lr": [torch.from_numpy(lr_np)], "hr": [torch.from_numpy(hr_np)],
            "seed": 11}
    torch.save({"device": device, "backend": backend,
                "steps": {"model": mc, "state": state, "cases": [case]}},
               work / "inputs.pt")
    _, secs = _torchrun(nproc, "-m", "fbanet_tpu_torch.parallel.dryrun",
                        str(work), "steps")
    ranks = [torch.load(work / f"steps.rank{r}.pt", weights_only=False)["f32"]
             for r in range(nproc)]
    m32 = create_model(cfg32, device="cuda", seed=0)
    m32.load_state_dict(state, strict=True)
    tc = TrainConfig(lr_initial=1e-4)
    one = make_train_step(m32, make_optimizer(m32.parameters(), tc), tc)
    loss1 = float(one(torch.from_numpy(lr_np).cuda(),
                      torch.from_numpy(hr_np).cuda(),
                      torch.Generator("cuda").manual_seed(11),
                      tc.lr_initial))
    worst, worst_name = 0.0, ""
    for n, p in m32.named_parameters():
        ref = p.grad.float().cpu()
        err = float((ranks[0]["grads"][n] - ref).abs().max()) / (
            float(ref.abs().max()) or 1.0)
        if not err <= worst:
            worst, worst_name = err, n
    same = all(torch.equal(v, r["params"][k]) for r in ranks[1:]
               for k, v in ranks[0]["params"].items())
    loss_rel = abs(ranks[0]["loss"] - loss1) / abs(loss1)
    log(f"ddp {nproc} ranks over {backend} on {cards} x {card} ({secs:.1f} "
        f"s, processes included): f32 step at global B=8 vs one process: "
        f"loss {ranks[0]['loss']:.6f} vs {loss1:.6f} (rel {loss_rel:.2e}), "
        f"gradients max err relative to each tensor's max {worst:.3e} "
        f"({worst_name}; limit {TRAIN_GRAD_TOL}); ranks' parameters "
        f"bit-equal: {same}")
    if not (loss_rel <= 1e-5 and worst <= TRAIN_GRAD_TOL and same):
        raise AssertionError(f"ddp {nproc} ranks: loss rel {loss_rel}, grad "
                             f"{worst_name} {worst}, ranks equal {same}")


# the configs phase: every configuration the JAX model builds. FBANet-32
# (embed 32, the configuration's default) has head size 32 at enc0 and
# enc1 and 8 at the bottleneck, dec0 and dec1: in bf16 the wgmma forms of
# K1-K4 take all five groups (K1's and K3's in `.narrow`; enc0, C = 32, on
# their C = 32 instantiations: K1 and K3 one head on one warpgroup, K2
# and K4 16 x 16 tiles), and every first kernel f32; weight gradients 32
# wide, which R1 takes as half a 64-wide tile; window 10 (N = 100) and the
# options of JAX's composed SwinLayer run composed PyTorch ops.
CONFIG_SHAPES = [(160, 32, 1), (80, 64, 2), (40, 128, 16), (80, 128, 16),
                 (160, 64, 8)]


def configs_kernels() -> dict:
    """K1, K1b, K2, K3 and K4 at FBANet-32's five group shapes against
    their plain versions, each with a bitwise repeat: under their plans (in
    bf16 the wgmma forms at every group, enc0's C = 32 included; the first
    kernels in f32) at B=2 in f32 and at B=2 and B=8 in bf16, K1 and K3
    masked and not, K3's and K4's dx and every parameter gradient with its
    sums; in bf16 the first kernels too through `_K1_BASE_PLAN` /
    `_K2_BASE_PLAN` / `_K3_BASE_PLAN` / `_WMMA_PLAN`; K1b and K3's windowed
    entry in bf16 at B=2, masked and not (K1b at enc0 also at B=8 and
    through `_K1_BASE_PLAN`); the layout models against the kernels' own
    sizes at head sizes 8 and 32 and at C = 32. Then K1-K4 per group at
    B=8 under their plans and R1 / R2 at every shape of FBANet-32's B=8
    train step (tools/measure_*.py with `groups(32)`). Returns {kernel:
    {max_abs_err, b8 / shapes}}, with ms, plain ms and bound at B=2 (bf16,
    masked, residual, summed over the five groups) for K1's and K3's
    `-narrow` entries."""
    import torch

    from fbanet_tpu_torch.ops import attention, leff
    from fbanet_tpu_torch.tools import (
        measure_attention,
        measure_attention_bwd,
        measure_leff,
        measure_leff_bwd,
        measure_reduce,
    )

    res = {k: dict(max_abs_err=0.0) for k in ("K1-base", "K1b", "K2",
                                              "K2-base", "K3-base", "K4",
                                              "K4-base")}
    for k in ("K1-narrow", "K3-narrow"):
        res[k] = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                      library_ms=None)
    bounds = {k: Bound() for k in ("K1-narrow", "K3-narrow")}
    failures = []

    def record(name, line, errs, abs_err, same, finite, dname, tol):
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], abs_err)
        line += (f": max rel err {max(errs):.3e} max_abs_err {abs_err:.3e} "
                 f"bitwise_repeat={same}")
        log(line)
        if not (max(errs) <= tol[dname]) or not same or not finite:
            failures.append(line)

    def record_bwd(name, line, got, again, ref, dname):
        record(name, line, _grad_errors(got, ref),
               max(float((u.float() - v.float()).abs().max())
                   for u, v in zip(got, ref)),
               all(torch.equal(u, v) for u, v in zip(got, again)),
               all(bool(torch.isfinite(u).all()) for u in got), dname,
               BWD_TOL)

    # the layout models the CPU tests plan with, against the kernels' own
    # sizes, at the head sizes the wgmma forms take for embed 32
    for c in (64, 128, 256):
        for heads in (c // 8, c // 32):
            for nwg in (2, 4):
                pairs = [(f"K3 warpgroups {nwg}",
                          attention._attention_bwd_smem(WS * WS, c, heads,
                                                        nwg),
                          attention._kernel_bwd_smem(WS * WS, c, heads,
                                                     nwg))]
                pairs += [(f"K1 warpgroups {nwg} staged {staged}",
                           attention._attention_smem(WS * WS, c, heads, nwg,
                                                     staged),
                           attention._kernel_attention_smem(
                               WS * WS, c, heads, nwg, staged))
                          for staged in (0, 1)]
                for what, ours, theirs in pairs:
                    if ours != theirs:
                        failures.append(f"{what} shared memory C={c} heads="
                                        f"{heads}: kernel {theirs}, plan "
                                        f"{ours}")
    # and at C = 32 (enc0): K1's and K3's one-head instantiations, K2's
    # and K4's forms (0 for what each does not take)
    pairs = [(f"K3 C=32 heads {heads} warpgroups {nwg}",
              attention._attention_bwd_smem(WS * WS, 32, heads, nwg),
              attention._kernel_bwd_smem(WS * WS, 32, heads, nwg))
             for heads in (1, 2, 4) for nwg in (1, 2, 4)]
    pairs += [(f"K1 C=32 heads {heads} warpgroups {nwg} staged {staged}",
               attention._attention_smem(WS * WS, 32, heads, nwg, staged),
               attention._kernel_attention_smem(WS * WS, 32, heads, nwg,
                                                staged))
              for heads in (1, 2, 4) for nwg in (1, 2, 4)
              for staged in (0, 1)]
    pairs += [(f"K2 C={c} form {form}", leff._leff_smem(c, *form),
               leff._kernel_leff_smem(c, *form))
              for c in (32, 64) for form in leff._K2_FORMS]
    pairs += [(f"K4 C=32 form {form}", leff._leff_bwd_smem(32, *form),
               leff._kernel_smem(32, *form)) for form in leff._K4_FORMS]
    for what, ours, theirs in pairs:
        log(f"configs {what}: shared memory kernel {theirs}, plan {ours}")
        if ours != theirs:
            failures.append(f"{what} shared memory: kernel {theirs}, plan "
                            f"{ours}")
    for i, (h, c, heads) in enumerate(CONFIG_SHAPES):
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            bf16 = dname == "bfloat16"
            for batch in ((2, 8) if bf16 else (2,)):
                for masked in (False, True):
                    x, a = attention_case(h, c, heads, dtype, masked,
                                          900 + i + 20 * (batch == 8), batch)
                    plan = attention._attention_plan(
                        batch, h, h, c, heads, WS, bf16,
                        smem=attention._kernel_attention_smem)
                    bplan = attention._attention_bwd_plan(
                        batch, h, h, c, heads, WS, bf16,
                        smem=attention._kernel_bwd_smem)
                    # K1-K4 on the wgmma forms at every group in bf16,
                    # enc0's C = 32 included
                    if (plan[0] > 0) != bf16 or (bplan[0] > 0) != bf16:
                        failures.append(
                            f"B={batch} H={h} C={c} heads={heads} {dname}: "
                            f"plans K1 {plan} K3 {bplan}, not the wgmma "
                            f"forms of K1 and K3 {bf16}")
                    k1_name = "K1-narrow" if plan[0] else "K1-base"
                    k3_name = "K3-narrow" if bplan[0] else "K3-base"

                    def k1(plain=False, x=x, a=a, heads=heads):
                        return attention.fused_window_attention_2d(
                            x, **a, heads=heads, window_size=WS,
                            residual=True, plain=plain)

                    got, again, ref = k1(), k1(), k1(plain=True)
                    torch.cuda.synchronize()
                    err, rel = rel_err(got, ref)
                    record(k1_name, f"configs K1 B={batch} H={h} C={c} "
                           f"heads={heads} {dname} masked={masked} plan "
                           f"{plan}", [rel], err, torch.equal(got, again),
                           bool(torch.isfinite(got).all()), dname, TOL)
                    timed = bf16 and masked and batch == 2
                    if timed:
                        res[k1_name]["ms"] += time_ms(k1)
                        res[k1_name]["plain_ms"] += time_ms(
                            lambda: k1(plain=True))
                        bounds[k1_name].add(*attention_work(
                            h, c, heads, masked, backward=False))
                    if bf16:
                        # the first kernel, which still serves f32
                        def k1_base(x=x, a=a, heads=heads):
                            return attention._attention_launch(
                                x, *a.values(), heads, WS, True,
                                attention._K1_BASE_PLAN)

                        got, again = k1_base(), k1_base()
                        torch.cuda.synchronize()
                        err, rel = rel_err(got, ref)
                        record("K1-base", f"configs K1 B={batch} H={h} "
                               f"C={c} heads={heads} {dname} masked="
                               f"{masked} plan {attention._K1_BASE_PLAN} "
                               f"(first kernel)", [rel], err,
                               torch.equal(got, again),
                               bool(torch.isfinite(got).all()), dname, TOL)
                    g = _normal_fn(950 + i + 20 * (batch == 8))(
                        (batch, h, h, c), 1.0).to(dtype)
                    p = {k: v for k, v in a.items() if k != "bproj"}

                    def k3(x=x, g=g, p=p, heads=heads):
                        return attention.window_attention_bwd(
                            x, g, **p, heads=heads, window_size=WS,
                            residual=True)

                    def k3_plain(x=x, g=g, p=p, heads=heads):
                        return attention._plain_bwd_2d(
                            x, g, *p.values(), heads, WS, True)

                    got, again, ref = k3(), k3(), k3_plain()
                    torch.cuda.synchronize()
                    record_bwd(k3_name, f"configs K3 B={batch} H={h} C={c} "
                               f"heads={heads} {dname} masked={masked} plan "
                               f"{bplan}", got, again, ref, dname)
                    if bf16 and masked and batch == 2:
                        res[k3_name]["ms"] += time_ms(k3)
                        res[k3_name]["plain_ms"] += time_ms(k3_plain)
                        bounds[k3_name].add(*attention_work(
                            h, c, heads, masked, backward=True))
                    if bf16:
                        def k3_base(x=x, g=g, p=p, heads=heads):
                            return attention._attention_bwd_launch(
                                x, g, *p.values(), heads, WS, True,
                                attention._K3_BASE_PLAN)

                        got, again = k3_base(), k3_base()
                        torch.cuda.synchronize()
                        record_bwd("K3-base", f"configs K3 B={batch} H={h} "
                                   f"C={c} heads={heads} {dname} masked="
                                   f"{masked} plan {attention._K3_BASE_PLAN} "
                                   f"(first kernel)", got, again, ref,
                                   dname)
                    if not masked:
                        configs_k2(h, c, batch, dtype, 970 + i + 20 * batch,
                                   record)
                        configs_k4(h, c, batch, dtype, 960 + i + 20 * batch,
                                   record_bwd)
                    # K1b in bf16 at B=2, at enc0 (C = 32) at B=8 too
                    if not bf16 or (batch != 2 and c != 32):
                        continue
                    # K1b and K3's windowed entry: the same windows,
                    # partitioned, under their plans
                    xw = attention.window_partition(x, WS).contiguous()
                    gw = attention.window_partition(g, WS).contiguous()
                    nw = (h // WS) ** 2

                    def k1b(plain=False, plan=None, xw=xw, a=a, heads=heads,
                            nw=nw):
                        if plan is not None:
                            return attention._launch_windows(
                                xw, *a.values(), heads, nw, plan=plan)
                        return attention.fused_window_attention(
                            xw, **a, heads=heads, windows_per_image=nw,
                            plain=plain)

                    ref = k1b(plain=True)
                    plans = [None] + ([attention._K1_BASE_PLAN] if c == 32
                                      else [])
                    for use in plans:
                        got, again = k1b(plan=use), k1b(plan=use)
                        torch.cuda.synchronize()
                        err, rel = rel_err(got, ref)
                        record("K1b" if use is None else "K1-base",
                               f"configs K1b G={xw.shape[0]} C={c} heads="
                               f"{heads} {dname} masked={masked} plan "
                               f"{use or 'its own'}", [rel], err,
                               torch.equal(got, again),
                               bool(torch.isfinite(got).all()), dname, TOL)
                    if batch != 2:
                        continue

                    def k3w(xw=xw, gw=gw, p=p, heads=heads, nw=nw):
                        return attention.window_attention_bwd_windows(
                            xw, gw, **p, heads=heads, windows_per_image=nw)

                    got, again = k3w(), k3w()
                    ref = attention.window_attention_bwd_reference(
                        xw, gw, *p.values(), heads=heads)
                    torch.cuda.synchronize()
                    record_bwd(k3_name, f"configs K3 windows G={xw.shape[0]}"
                               f" C={c} heads={heads} {dname} masked="
                               f"{masked}", got, again, ref, dname)
                    del xw, gw
                del x, a
    for k, bound in bounds.items():
        res[k].update(bound.fields())
        log(f"configs {k} B=2 over its wgmma groups (bf16, masked, "
            f"residual): {res[k]}")
    if failures:
        raise AssertionError("configs: kernel disagrees with its plain "
                             "version or does not repeat:\n"
                             + "\n".join(failures))
    # every kernel of FBANet-32's step at B=8 per group, under its plan:
    # the groups on the wgmma forms (all five, enc0 on the C = 32
    # instantiations) under "-narrow" (K1, K3) or the plain name (K2, K4);
    # a group on a first kernel would go under "-base"
    groups32 = measure_reduce.groups(32)
    for (wgmma, base), tool in ((("K1-narrow", "K1-base"), measure_attention),
                                (("K2", "K2-base"), measure_leff),
                                (("K3-narrow", "K3-base"),
                                 measure_attention_bwd),
                                (("K4", "K4-base"), measure_leff_bwd)):
        b8 = tool.shapes(batch=8, groups=groups32)
        for name in dict.fromkeys((wgmma, base)):
            rows = [r for r in b8["rows"]
                    if (wgmma if r["plan"][0] else base) == name]
            res.setdefault(name, {})["b8"] = {r["group"]: {k: r[k] for k in (
                "plan", "ms", "device_ms", "bound_ms", "share_of_bound",
                "max_rel_err")} for r in rows}
            res[name]["b8_sums"] = measure_reduce.shape_sums(name, rows, 8)
    # K1b (the windowed entry: the wgmma form at every group, enc0's C = 32
    # instantiation included) per group at B=8: the same windows as K1's
    # map, partitioned
    rows = {}
    for i, (name, h, c, heads) in enumerate(groups32):
        x, a = attention_case(h, c, heads, torch.bfloat16, True, 980 + i,
                              batch=8)
        xw = attention.window_partition(x, WS).contiguous()

        def k1b(xw=xw, a=a, heads=heads, nw=(h // WS) ** 2):
            return attention.fused_window_attention(
                xw, **a, heads=heads, windows_per_image=nw)

        bound = Bound()
        bound.add(*attention_work(h, c, heads, True, batch=8))
        rows[name] = dict(ms=time_ms(k1b),
                          device_ms=measure_reduce.device_ms(k1b),
                          bound_ms=bound.ms)
        log(f"configs K1b {name} B=8 H={h} C={c} heads={heads}: "
            f"{rows[name]}")
        del x, xw
    res["K1b"]["b8"] = rows
    sums = measure_reduce.shapes(batch=8, groups=groups32)
    for name in ("R1", "R2"):
        res[name] = dict(max_abs_err=max(r["max_abs_err"] for r in sums[name]),
                         shapes=len(sums[name]), sums=sums["sums"][name])
        log(f"configs {name} over FBANet-32's {len(sums[name])} B=8 shapes: "
            f"{res[name]}")
    return res


def configs_k2(h, c, batch, dtype, seed, record) -> None:
    """K2 at one of FBANet-32's group shapes against its plain version
    with the residual (`record`: the error against 3e-2 of max(1, max
    |plain|) in bf16, 1e-4 in f32, a bitwise repeat): under its plan (in
    bf16 the wgmma form at every group, enc0's C = 32 forms included; f32
    the first kernel) and in bf16 under `_K2_BASE_PLAN` too. Failures go
    where `record` puts them."""
    import torch

    from fbanet_tpu_torch.ops import leff

    bf16 = dtype == torch.bfloat16
    dname = "bfloat16" if bf16 else "float32"
    x, a = leff_case(h, c, dtype, seed, batch)
    plan = leff._leff_plan(batch, h, h, c, 4 * c, bf16,
                           smem=leff._kernel_leff_smem)
    if (plan[0] > 0) != bf16:
        raise AssertionError(f"configs B={batch} H={h} C={c} {dname}: K2 "
                             f"plan {plan}")
    ref = leff.fused_leff(x, **a, residual=True, plain=True)
    for name, use in (("K2" if plan[0] else "K2-base", plan),
                      *((("K2-base", leff._K2_BASE_PLAN),) if bf16 else ())):
        got = leff._leff_launch(x, *a.values(), True, use)
        again = leff._leff_launch(x, *a.values(), True, use)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        record(name, f"configs K2 B={batch} H={h} C={c} Ch={4 * c} {dname} "
               f"plan {use}", [rel], err, torch.equal(got, again),
               bool(torch.isfinite(got).all()), dname, TOL)


def configs_k4(h, c, batch, dtype, seed, record_bwd) -> None:
    """K4 at one of FBANet-32's group shapes against its plain backward
    (`record_bwd`: every gradient with its sums, a bitwise repeat): under
    its plan (in bf16 the wgmma form at every group, enc0 included; f32 the
    WMMA form) and in bf16 under `_WMMA_PLAN` too; the K2 forward's plan
    takes its wgmma form at every group in bf16 too. Failures go where
    `record_bwd` puts them."""
    import torch

    from fbanet_tpu_torch.ops import leff

    bf16 = dtype == torch.bfloat16
    dname = "bfloat16" if bf16 else "float32"
    x, a = leff_case(h, c, dtype, seed, batch)
    g = _normal_fn(seed + 1)((batch, h, h, c), 1.0).to(dtype)
    p = {k: v for k, v in a.items() if k != "b2"}
    plan = leff._leff_bwd_plan(batch, h, h, c, 4 * c, bf16,
                               smem=leff._kernel_smem)
    fwd = leff._leff_plan(batch, h, h, c, 4 * c, bf16)
    if (plan[0] > 0) != bf16 or (fwd[0] > 0) != bf16:
        raise AssertionError(f"configs B={batch} H={h} C={c} {dname}: K4 "
                             f"plan {plan}, K2 plan {fwd}")

    def k4(plan=plan):
        return leff._leff_bwd_launch(x, g, *p.values(), True, plan)

    dx, *rest = leff.leff_bwd_reference(x, g, **p)
    ref = (dx + g, *rest)
    for name, use in (("K4" if plan[0] else "K4-base", plan),
                      *((("K4-base", leff._WMMA_PLAN),) if bf16 else ())):
        got, again = k4(use), k4(use)
        torch.cuda.synchronize()
        record_bwd(name, f"configs K4 B={batch} H={h} C={c} Ch={4 * c} "
                   f"{dname} plan {use}", got, again, ref, dname)


def _config_counters() -> dict:
    """`_counters()` of K1-K4's forms, R1 and R2, with K2's calls on either
    form ("K2-all") and the composed branch of K1's entry ("composed")."""
    from fbanet_tpu_torch.ops import attention, leff

    kernels = _counters()
    return {**{k: kernels[k] for k in ("K1", "K1-narrow", "K1-base", "K2",
                                       "K2-base", "K3", "K3-narrow",
                                       "K3-base", "K4", "K4-base", "R1",
                                       "R2")},
            "K2-all": leff.fused_leff,
            "composed": attention.fused_window_attention_2d.composed}


def _config_model(cfg, seed: int):
    """The port's model of `cfg` on the card with every parameter drawn
    from `seed`, and the layer count of its two hourglasses."""
    from fbanet_tpu_torch.models import create_model
    from fbanet_tpu_torch.utils.weights import random_state_dict

    model = create_model(cfg, device="cuda", seed=0)
    model.load_state_dict(random_state_dict(model, seed=seed), strict=True)
    return model, sum(cfg.depths[i] for i in (0, 1, 4, 5, 6)) * 2


def _config_steps(model, lr, hr, steps: int) -> tuple[list, list, list]:
    """`steps` AdamW steps of `train.make_train_step` at lr 1e-4: (losses,
    host ms per step, the counters' launches per step). Raises on a
    non-finite loss or a parameter that did not move."""
    import torch

    from fbanet_tpu_torch.config import TrainConfig
    from fbanet_tpu_torch.train import make_optimizer, make_train_step

    tcfg = TrainConfig(batch_size=lr.shape[0], lr_initial=1e-4,
                       optimizer="adamw")
    step = make_train_step(model, make_optimizer(model.parameters(), tcfg),
                           tcfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator(device="cuda").manual_seed(7)
    counters = _config_counters()
    losses, times, per_step = [], [], []
    for _ in range(steps):
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(lr, hr, gen, tcfg.lr_initial)))
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: c.launches for k, c in counters.items()})
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    still = [n for n, p in model.named_parameters()
             if torch.equal(p.detach(), before[n])]
    if still:
        raise AssertionError(f"parameters that did not move: {still}")
    return losses, times, per_step


def _expect(what: str, got: dict, want: dict) -> None:
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if bad:
        raise AssertionError(f"{what}: launches (got, expected) {bad}; all "
                             f"{got}")


def configs_fbanet32(card: str) -> tuple[dict, dict]:
    """FBANet-32 (embed 32, the configuration's default, with the published
    heads), 14 frames, 160 px, bf16: 3 batches of 4 served through
    `eval_step` (ECC, forward, clamp, PSNR/SSIM) against the plain path,
    then 5 AdamW steps at B=8 with drop_path 0.1; 20 launches a forward of
    K1 and of K2, 20 a step of each of K1-K4, all on their wgmma forms: K1
    and K3 on `-narrow` (head sizes 8 and 32; enc0's one-warpgroup C = 32
    instantiations among them), K2 and K4 on theirs (enc0 on 16 x 16
    tiles), none on a first kernel, none at head sizes 16 and 64 and no
    composed branch; one f32 B=2 step's gradients against the plain
    versions (K1-K4 20 each on their first kernels). Returns (launches on
    these runs, times)."""
    import torch

    from fbanet_tpu_torch.evaluate import eval_step
    from fbanet_tpu_torch.metrics import psnr
    from fbanet_tpu_torch.models import ModelConfig
    from fbanet_tpu_torch.ops.registration import online_register
    from fbanet_tpu_torch.train import make_train_step

    cfg = ModelConfig(num_frames=14, img_size=160, embed_dim=32,
                      window_size=8, dtype="bfloat16", drop_path_rate=0.1)
    model, layers = _config_model(cfg, seed=41)
    counters = _config_counters()
    requests = [tuple(torch.from_numpy(a).cuda() for a in
                      make_realistic_bursts(4, 14, 160, seed=50 + i,
                                            hr_scale=4)) for i in range(3)]
    for c in counters.values():
        c.launches = 0
    served = [eval_step(model, lr, hr, online_align="ecc")
              for lr, hr in requests]
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    log(f"configs FBANet-32: served 3 batches of 4, launches {launches}")
    n = layers * len(served)
    _expect("FBANet-32 serving", launches, {
        "K1": 0, "K1-narrow": n, "K1-base": 0, "K2": n, "K2-base": 0,
        "K2-all": n, "composed": 0})
    for pred, *_ in served:
        if tuple(pred.shape) != (4, 640, 640, 3) or \
                not torch.isfinite(pred).all():
            raise AssertionError("FBANet-32: output not finite or of the "
                                 f"wrong shape {tuple(pred.shape)}")
    lr, hr = requests[0]
    plain = eval_step(model, lr, hr, online_align="ecc", plain=True)[0]
    agree = float(psnr(served[0][0], plain).min())
    log(f"configs FBANet-32: kernel vs plain path PSNR {agree:.2f} dB (min "
        f"over the batch, limit {SLICE_PSNR_MIN})")
    if not agree >= SLICE_PSNR_MIN:
        raise AssertionError(f"FBANet-32 kernel vs plain path {agree:.2f} dB")

    lr8_np, hr8_np = make_realistic_bursts(8, 14, 160, seed=60, hr_scale=4)
    lr8 = torch.from_numpy(lr8_np).cuda()
    hr8 = torch.from_numpy(hr8_np).cuda()
    aligned = online_register(lr8)

    def forward(plain=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = model(aligned, plain=plain)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError("FBANet-32: non-finite B=8 forward")
        return (time.perf_counter() - t0) * 1e3

    forward()
    fwd_ms = statistics.median(forward() for _ in range(3))
    plain_fwd_ms = statistics.median(forward(True) for _ in range(2))
    losses, times, per_step = _config_steps(model, lr8, hr8, 5)
    for i, got in enumerate(per_step):
        _expect(f"FBANet-32 train step {i}", got, {
            "K1": 0, "K1-narrow": layers, "K1-base": 0, "K2": layers,
            "K2-base": 0, "K2-all": layers, "K3": 0, "K3-narrow": layers,
            "K3-base": 0, "K4": layers, "K4-base": 0, "composed": 0})
    step_ms = statistics.median(times[1:])
    log(f"configs FBANet-32 B=8 on {card}: forward {fwd_ms:.2f} ms (plain "
        f"versions {plain_fwd_ms:.2f}), train step {step_ms:.2f} ms "
        f"({8e3 / step_ms:.3f} samples/s), losses {losses}, per step "
        f"{per_step[-1]}")
    runs = {k: sum(s[k] for s in per_step) + launches[k] for k in launches}

    # one B=8 step profiled: device ms, the port's kernels by name
    from torch.profiler import ProfilerActivity, profile

    from fbanet_tpu_torch.config import TrainConfig
    from fbanet_tpu_torch.train import make_optimizer

    tcfg = TrainConfig(batch_size=8, lr_initial=1e-4, optimizer="adamw")
    step = make_train_step(model, make_optimizer(model.parameters(), tcfg),
                           tcfg)
    gen = torch.Generator(device="cuda").manual_seed(9)
    float(step(lr8, hr8, gen, 1e-4))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        float(step(lr8, hr8, gen, 1e-4))
    total, ours = _device_ms(prof.key_averages())
    log(f"configs FBANet-32 B=8 step profile: device {total:.3f} ms, port "
        f"kernels (ms) { {k: round(v, 3) for k, v in ours.items()} }")

    # f32, B=2: every parameter gradient, kernels against plain versions
    m32, _ = _config_model(cfg.replace(dtype="float32"), seed=41)
    grads = []
    for c in counters.values():
        c.launches = 0
    for plain in (False, True):
        m32.zero_grad(set_to_none=True)
        loss_fn = make_train_step(m32, None, tcfg, plain=plain).loss_fn
        loss_fn(lr8[:2], hr8[:2],
                torch.Generator(device="cuda").manual_seed(11)).backward()
        grads.append({k: p.grad.clone() for k, p in m32.named_parameters()
                      if p.grad is not None})
    f32_launches = {k: c.launches for k, c in counters.items()}
    _expect("FBANet-32 f32 step", f32_launches, {
        "K1-narrow": 0, "K1-base": layers, "K2-base": layers,
        "K3-narrow": 0, "K3-base": layers, "K4": 0, "K4-base": layers})
    worst, worst_name = 0.0, ""
    for k, ref in grads[1].items():
        scale = float(ref.abs().max())
        err = float((grads[0][k] - ref).abs().max()) / (scale or 1.0)
        if not err <= worst:
            worst, worst_name = err, k
    log(f"configs FBANet-32 f32 B=2 gradients, kernels vs plain: "
        f"{len(grads[1])} tensors, max err {worst:.3e} ({worst_name}; limit "
        f"{TRAIN_GRAD_TOL}); launches {f32_launches}")
    if not worst <= TRAIN_GRAD_TOL or grads[0].keys() != grads[1].keys():
        raise AssertionError(f"FBANet-32 f32 gradient {worst_name}: "
                             f"{worst:.3e}")
    runs = {k: v + f32_launches[k] for k, v in runs.items()}
    return runs, dict(fwd_ms=fwd_ms, plain_fwd_ms=plain_fwd_ms,
                      step_ms=step_ms, step_device_ms=total,
                      step_kernels_ms=ours)


def configs_window10(card: str) -> dict:
    """FBANet-64 at window 10 (N = 100, JAX's composed branch), 14 frames,
    160 px, bf16, B=8: 20 composed attentions a forward, K1 0, K2 20; the
    forward against the plain path (PSNR >= SLICE_PSNR_MIN); 3 finite AdamW
    steps with drop_path 0.1. Returns the launches of those runs."""
    import torch

    from fbanet_tpu_torch.metrics import psnr
    from fbanet_tpu_torch.models import ModelConfig

    cfg = ModelConfig(num_frames=14, img_size=160, embed_dim=64,
                      window_size=10, dtype="bfloat16", drop_path_rate=0.1)
    model, layers = _config_model(cfg, seed=42)
    lr_np, hr_np = make_realistic_bursts(8, 14, 160, seed=70, hr_scale=4)
    lr, hr = torch.from_numpy(lr_np).cuda(), torch.from_numpy(hr_np).cuda()
    counters = _config_counters()
    for c in counters.values():
        c.launches = 0
    with torch.no_grad():
        out = model(lr)
    launches = {k: c.launches for k, c in counters.items()}
    _expect("window 10 forward", launches, {
        "composed": layers, "K1": 0, "K1-base": 0, "K2-all": layers})
    with torch.no_grad():
        ref = model(lr, plain=True)
    agree = float(psnr(out.clamp(0, 1), ref.clamp(0, 1)).min())
    log(f"configs window 10 B=8: launches {launches}; kernel vs plain path "
        f"PSNR {agree:.2f} dB (limit {SLICE_PSNR_MIN})")
    if not (agree >= SLICE_PSNR_MIN and torch.isfinite(out).all()):
        raise AssertionError(f"window 10: {agree:.2f} dB")

    def forward():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            model(lr)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    fwd_ms = statistics.median(forward() for _ in range(3))
    losses, times, per_step = _config_steps(model, lr, hr, 3)
    for i, got in enumerate(per_step):
        _expect(f"window 10 train step {i}", got, {
            "composed": layers, "K1": 0, "K1-base": 0, "K2-all": layers,
            "K3": 0, "K3-base": 0, "K4": layers, "K4-base": 0})
    log(f"configs window 10 B=8 on {card}: forward {fwd_ms:.2f} ms, losses "
        f"{losses}, step ms {times}, per step {per_step[-1]}")
    return {k: launches[k] + sum(s[k] for s in per_step) for k in launches}


def configs_options(card: str) -> dict:
    """FBANet-64 (14 frames, 160 px, bf16), B=2, two AdamW steps under each
    of: use_qkv_bias=False (fused route, zero biases into K1 / K3: 20 of
    each of K1-K4 a step), token_mlp="ffn" (K1 / K3 20, K2 / K4 0: the
    composed MlpFFN), and the conv projection with SE, qk_scale and both
    dropouts (the composed route: no kernel in the layers). Returns the
    launches of those steps."""
    import torch

    from fbanet_tpu_torch.models import ModelConfig
    from fbanet_tpu_torch.models.layers import SwinLayer

    base = ModelConfig(num_frames=14, img_size=160, embed_dim=64,
                       window_size=8, dtype="bfloat16", drop_path_rate=0.1)
    lr_np, hr_np = make_realistic_bursts(2, 14, 160, seed=80, hr_scale=4)
    lr, hr = torch.from_numpy(lr_np).cuda(), torch.from_numpy(hr_np).cuda()
    total = {}
    for name, kw, route, want in (
            ("use_qkv_bias=False", dict(use_qkv_bias=False), "fused",
             {"K1": 1, "K2-all": 1, "K3": 1, "K4": 1}),
            ("token_mlp=ffn", dict(token_mlp="ffn"), "fused",
             {"K1": 1, "K2-all": 0, "K3": 1, "K4": 0}),
            ("conv+SE+qk_scale+dropout", dict(
                token_projection="conv", use_se_layer=True, qk_scale=0.2,
                drop_rate=0.1, attn_drop_rate=0.1), "composed",
             {"K1": 0, "K2-all": 0, "K3": 0, "K4": 0, "R1": 0,
              "R2": 0})):
        model, layers = _config_model(base.replace(**kw), seed=43)
        routes = {m.route for m in model.modules()
                  if isinstance(m, SwinLayer)}
        if routes != {route}:
            raise AssertionError(f"{name}: routes {routes}, not {route}")
        losses, times, per_step = _config_steps(model, lr, hr, 2)
        for got in per_step:
            _expect(name, got, {k: v * layers for k, v in want.items()})
        log(f"configs {name} ({route}) B=2 on {card}: losses {losses}, step "
            f"ms {times}, per step {per_step[-1]}")
        for s in per_step:
            for k, v in s.items():
                total[k] = total.get(k, 0) + v
        del model
    return total


def phase_configs(card: str) -> tuple[dict, dict, dict]:
    """Every configuration the JAX model builds, on the card: FBANet-32's
    kernels (`configs_kernels`), its serving and training
    (`configs_fbanet32`), window 10 (`configs_window10`) and the SwinLayer
    options (`configs_options`). Returns (the kernels' checks and times,
    the launches of the main-path runs by chip_smoke's kernel names, the
    FBANet-32 times)."""
    checks = configs_kernels()
    runs, times = configs_fbanet32(card)
    for more in (configs_window10(card), configs_options(card)):
        runs = {k: runs[k] + more[k] for k in runs}
    log(f"configs: launches on the phase's runs {runs}")
    return checks, runs, times


# the raw phase: FBANet-64 on RealBSR-RAW (4-channel packed Bayer)
RAW_TREE = {"train": 8, "test": 4}  # bursts of 14 x 160^2 x 4 on disk
LPIPS_TOL = 1e-4  # LPIPS on the card vs the CPU, relative: f32 convolutions


def raw_bursts(batch, seed):
    """Packed-Bayer bursts for the RAW model from `make_realistic_bursts`:
    channels (R, G, G', B) with G' = 0.97 G + 0.015, as 16383-scaled uint16
    (the dataset's storage wire) on the card: (LR [B, 14, 160, 160, 4], HR
    [B, 640, 640, 4])."""
    import numpy as np
    import torch

    def bayer(x):
        x = np.concatenate([x[..., :2], 0.97 * x[..., 1:2] + 0.015,
                            x[..., 2:]], -1)
        return torch.from_numpy(np.round(np.clip(x, 0, 1) * 16383).astype(
            np.uint16)).cuda()

    lr, hr = make_realistic_bursts(batch, 14, 160, seed=seed, hr_scale=4)
    return bayer(lr), bayer(hr)


def raw_model(seed: int, dtype: str = "bfloat16", channels: int = 4):
    """FBANet-64 at the published configuration (14 frames, 160 px, window
    8, drop_path 0.1) with `channels` input channels, every parameter
    drawn from `seed`."""
    from fbanet_tpu_torch.models import ModelConfig

    return _config_model(ModelConfig(
        num_frames=14, img_size=160, embed_dim=64, window_size=8,
        in_channels=channels, dtype=dtype, drop_path_rate=0.1), seed)


def raw_serving(card: str) -> tuple[dict, dict]:
    """FBANet-64 RAW served at B=8 through `eval_step` (ECC on channels
    R, G1, G2, the forward, clamp, PSNR / SSIM) from uint16 storage
    tensors: 20 launches of K1 and K2 (wgmma forms), none of K1's first
    kernel; finite [8, 640, 640, 4] in [0, 1]; the kernel path within
    SLICE_PSNR_MIN of the plain path; the B=8 forward timed against the
    plain versions. Returns (launches, times)."""
    import torch

    from fbanet_tpu_torch.evaluate import eval_step
    from fbanet_tpu_torch.metrics import psnr, to_unit_f32

    model, layers = raw_model(seed=90)
    lr, hr = raw_bursts(8, seed=91)
    counters = _config_counters()
    for c in counters.values():
        c.launches = 0
    pred, p, s, _ = eval_step(model, lr, hr, online_align="ecc")
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    _expect("RAW serving", launches, {"K1": layers, "K1-base": 0,
                                      "K2": layers, "composed": 0})
    if tuple(pred.shape) != (8, 640, 640, 4) or not torch.isfinite(pred).all() \
            or pred.min() < 0 or pred.max() > 1:
        raise AssertionError(f"RAW output {tuple(pred.shape)} not finite or "
                             "outside [0, 1]")
    plain = eval_step(model, lr, hr, online_align="ecc", plain=True)[0]
    agree = float(psnr(pred, plain).min())
    log(f"raw serving B=8 (uint16 wire, ECC on R/G1/G2): launches "
        f"{launches}; PSNR {float(p.mean()):.4f} SSIM {float(s.mean()):.4f} "
        f"(random weights); kernel vs plain path {agree:.2f} dB (min over "
        f"the batch, limit {SLICE_PSNR_MIN})")
    if not agree >= SLICE_PSNR_MIN:
        raise AssertionError(f"RAW kernel vs plain path {agree:.2f} dB")

    x = to_unit_f32(lr)

    def forward(plain=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = model(x, plain=plain)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError("RAW: non-finite B=8 forward")
        return (time.perf_counter() - t0) * 1e3

    forward()
    fwd_ms = statistics.median(forward() for _ in range(5))
    plain_ms = statistics.median(forward(True) for _ in range(2))
    log(f"raw serving B=8 on {card}: forward {fwd_ms:.2f} ms (plain "
        f"versions {plain_ms:.2f} ms)")
    return launches, {"fwd_ms": fwd_ms, "plain_fwd_ms": plain_ms}


def raw_training(card: str) -> tuple[dict, dict]:
    """5 AdamW steps of FBANet-64 RAW at B=8 from uint16 storage tensors:
    finite losses, every parameter moved, and per step the same launches
    of K1-K4, R1 and R2 as one step of the RGB model at the same width;
    step ms and peak memory. Then one f32 B=2 step's gradients, kernels vs
    plain, within TRAIN_GRAD_TOL (K1's, K2's and K3's first kernels and K4,
    20 each). Returns (launches, times)."""
    import torch

    from fbanet_tpu_torch.config import TrainConfig
    from fbanet_tpu_torch.train import make_train_step

    rgb, layers = raw_model(seed=92, channels=3)
    lr3, hr3 = make_realistic_bursts(2, 14, 160, seed=93, hr_scale=4)
    lr3, hr3 = torch.from_numpy(lr3).cuda(), torch.from_numpy(hr3).cuda()
    lr3, hr3 = lr3.repeat(4, 1, 1, 1, 1), hr3.repeat(4, 1, 1, 1)
    rgb_step = _config_steps(rgb, lr3, hr3, 1)[2][0]
    del rgb, lr3, hr3

    model, _ = raw_model(seed=94)
    lr, hr = raw_bursts(8, seed=95)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, per_step = _config_steps(model, lr, hr, 5)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, got in enumerate(per_step):
        _expect(f"RAW train step {i} (the RGB step's launches)", got,
                rgb_step)
    if rgb_step["K1"] != layers or rgb_step["K3"] != layers:
        raise AssertionError(f"RGB step launches {rgb_step}")
    step_ms = statistics.median(times[1:])
    log(f"raw train B=8 on {card}: {step_ms:.2f} ms/step ({8e3 / step_ms:.3f}"
        f" samples/s), peak {peak:.2f} GiB, losses {losses}, step ms "
        f"{[round(t, 2) for t in times]}, launches per step {per_step[-1]} "
        f"(the RGB step's: {rgb_step})")
    launches = {k: sum(s[k] for s in per_step) for k in per_step[0]}

    m32, _ = raw_model(seed=94, dtype="float32")
    tcfg = TrainConfig(batch_size=2, lr_initial=1e-4, optimizer="adamw")
    counters = _config_counters()
    for c in counters.values():
        c.launches = 0
    grads = []
    for plain in (False, True):
        m32.zero_grad(set_to_none=True)
        make_train_step(m32, None, tcfg, plain=plain).loss_fn(
            lr[:2], hr[:2], torch.Generator(device="cuda").manual_seed(11)
        ).backward()
        grads.append({k: p.grad.clone() for k, p in m32.named_parameters()
                      if p.grad is not None})
    f32_launches = {k: c.launches for k, c in counters.items()}
    _expect("RAW f32 step", f32_launches, {
        "K1-base": layers, "K2-base": layers, "K3-base": layers,
        "K4-base": layers, "K4": 0})
    worst, worst_name = 0.0, ""
    for k, ref in grads[1].items():
        scale = float(ref.abs().max())
        err = float((grads[0][k] - ref).abs().max()) / (scale or 1.0)
        if not err <= worst:
            worst, worst_name = err, k
    log(f"raw f32 B=2 gradients, kernels vs plain: {len(grads[1])} tensors, "
        f"max err {worst:.3e} ({worst_name}; limit {TRAIN_GRAD_TOL})")
    if not worst <= TRAIN_GRAD_TOL or grads[0].keys() != grads[1].keys():
        raise AssertionError(f"RAW f32 gradient {worst_name}: {worst:.3e}")
    launches = {k: v + f32_launches[k] for k, v in launches.items()}
    return launches, {"step_ms": step_ms, "peak_gib": peak,
                      "grad_err": worst}


def raw_entry_points(card: str) -> dict:
    """`train.main` (one epoch, B=8, `--profile_dir`) -> `evaluate.main
    --save_images` -> `tiled.main` (psize 80, overlap 40) on a RAW tree
    written through `data/png.py`: 8 train and 4 test bursts of 14 x 160^2
    x 4 (16-bit). Checks the trace file names K1's kernel, 20 launches of
    K1-K4 a step and of K1 and K2 a forward, 4 PNGs of 640 x 640 x 3 from
    evaluate, and from tiled 4 `.npy` of [640, 640, 4] beside their PNGs.
    Returns the launches."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from fbanet_tpu_torch import evaluate as E
    from fbanet_tpu_torch import tiled as TL
    from fbanet_tpu_torch import train as T
    from fbanet_tpu_torch.data import png
    from fbanet_tpu_torch.data.synthetic import write_synthetic_realbsr

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="raw_", dir=ROOT / "build"))
    t0 = time.perf_counter()
    for seed, (split, n) in enumerate(RAW_TREE.items()):
        write_synthetic_realbsr(tmp / "tree", num_bursts=n, num_frames=14,
                                lr_size=160, splits=(split,), seed=seed,
                                channels=4, level=1)
    log(f"raw: wrote {sum(RAW_TREE.values())} RAW bursts of 14 x 160^2 x 4 "
        f"in {time.perf_counter() - t0:.2f} s")
    common = ["--dataroot", str(tmp / "tree"), "--embed_dim", "64",
              "--train_ps", "160", "--burst_size", "14", "--in_channels", "4",
              "--dtype", "bfloat16", "--device", "cuda"]
    counters = _config_counters()

    def run(fn, argv):
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        out = fn(argv)
        torch.cuda.synchronize()
        return out, {k: c.launches for k, c in counters.items()}, \
            time.perf_counter() - t0

    res, lt, secs = run(T.main, [
        *common, "--batch_size", "8", "--nepoch", "1", "--save_dir",
        str(tmp / "log"), "--train_workers", "8", "--eval_workers", "4",
        "--profile_dir", str(tmp / "prof")])
    steps = sum(h["steps"] for h in res["history"])
    _expect("RAW train.main", lt, {"K1": 20 * (steps + 1), "K1-base": 0,
                                   "K2": 20 * (steps + 1), "K3": 20 * steps,
                                   "K4": 20 * steps, "K4-base": 0})
    trace = tmp / "prof" / "trace.json"
    text = trace.read_text() if trace.exists() else ""
    log(f"raw train.main: {steps} step(s) + eval in {secs:.2f} s, loss "
        f"{res['history'][0]['loss']:.5f}, PSNR {res['best_psnr']:.4f}; "
        f"trace {trace.name} {len(text) / 2**20:.2f} MiB, names K1's "
        f"kernel: {'attention_wgmma_kernel' in text}")
    if "attention_wgmma_kernel" not in text:
        raise AssertionError(f"RAW --profile_dir: {trace} does not name K1")

    best = str(Path(res["model_dir"]) / "model_best")
    ev, le, secs = run(E.main, [*common, "--weights", best, "--save_images",
                                "--result_dir", str(tmp / "eval")])
    pngs = sorted((tmp / "eval").glob("*.png"))
    heads = {png.read_header(q)[:3] for q in pngs}
    log(f"raw evaluate.main --save_images: PSNR {ev['psnr']:.4f}, "
        f"{len(pngs)} PNGs {heads} in {secs:.2f} s")
    if len(pngs) != 4 or heads != {(640, 640, 8)} or \
            not np.isfinite(ev["psnr"]):
        raise AssertionError(f"RAW evaluate: {len(pngs)} PNGs {heads}")

    written, ltl, secs = run(TL.main, [*common, "--weights", best, "--psize",
                                       "80", "--overlap", "40",
                                       "--result_dir", str(tmp / "tiled")])
    npys = [np.load(q.with_suffix(".npy")) for q in written]
    heads = {png.read_header(q)[:3] for q in written}
    log(f"raw tiled.main: {len(written)} PNGs {heads}, npy "
        f"{sorted({a.shape for a in npys})}, finite "
        f"{all(np.isfinite(a).all() for a in npys)} in {secs:.2f} s; "
        f"launches {ltl}")
    if len(written) != 4 or heads != {(640, 640, 8)} or \
            {a.shape for a in npys} != {(640, 640, 4)} or \
            not all(np.isfinite(a).all() for a in npys):
        raise AssertionError("RAW tiled outputs")
    shutil.rmtree(tmp, ignore_errors=True)
    return {k: lt[k] + le[k] + ltl[k] for k in lt}


def raw_lpips(card: str) -> dict:
    """LPIPS (random weights, `random_initialized_lpips(0)`) on a B=8 pair
    of 640^2 images at boundary_ignore 40: the card against the CPU within
    LPIPS_TOL relative, and the card's ms (CUDA events, median of 5)."""
    import torch

    from fbanet_tpu_torch.models.lpips import random_initialized_lpips

    g = torch.Generator().manual_seed(96)
    a, b = (torch.rand(8, 640, 640, 3, generator=g) for _ in range(2))
    metric = random_initialized_lpips(0)
    ref = metric(a, b, boundary_ignore=40)
    metric = metric.cuda()
    ac, bc = a.cuda(), b.cuda()
    got = metric(ac, bc, boundary_ignore=40)
    err = float(((got.cpu() - ref).abs() / ref.abs()).max())
    ms = statistics.median(_cuda_ms(lambda: metric(ac, bc, boundary_ignore=40))
                           for _ in range(5))
    log(f"raw LPIPS B=8 640^2 (boundary 40) on {card}: {ms:.3f} ms, card vs "
        f"CPU max rel err {err:.3e} (limit {LPIPS_TOL}), values "
        f"{[round(v, 5) for v in got.tolist()]}")
    if not (err <= LPIPS_TOL and torch.isfinite(got).all()):
        raise AssertionError(f"LPIPS card vs CPU {err:.3e}")
    return {"lpips_ms": ms, "lpips_err": err}


def _cuda_ms(fn) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def raw_bakeoff(card: str) -> dict:
    """`bakeoff.main --synthetic` on the card (3 scenes x 3 pairs at 160
    px): every method's mean PSNR above the unaligned pair's; seconds per
    method (mean over the scenes)."""
    from fbanet_tpu_torch import bakeoff

    t0 = time.perf_counter()
    res = bakeoff.main(["--synthetic", "--device", "cuda"])
    secs = time.perf_counter() - t0
    per = {m: statistics.mean(r[m]["seconds"] for r in res.values())
           for m in bakeoff.METHODS}
    log(f"raw bakeoff --synthetic on {card} ({secs:.1f} s): PSNR "
        f"{ {s: {m: round(v['psnr'], 3) for m, v in r.items()} for s, r in res.items()} }; "
        f"s per frame {({m: round(v, 4) for m, v in per.items()})}")
    bad = [(s, m) for s, r in res.items() for m in bakeoff.METHODS
           if not r[m]["psnr"] > r["unaligned"]["psnr"]]
    if bad:
        raise AssertionError(f"bakeoff: not above unaligned: {bad}")
    return {"bakeoff_s": per}


def phase_raw(card: str) -> tuple[dict, dict]:
    """FBANet-64 on RealBSR-RAW (in a process of its own, as the configs
    phase): serving, training, the entry points on a RAW tree, LPIPS and
    the bake-off. Returns (launches on the main-path runs, times)."""
    t0 = time.perf_counter()
    launches, times = raw_serving(card)
    more, t = raw_training(card)
    times.update(t)
    for extra in (more, raw_entry_points(card)):
        launches = {k: launches[k] + extra[k] for k in launches}
    times.update(raw_lpips(card))
    times.update(raw_bakeoff(card))
    log(f"raw: launches on the phase's runs {launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    return launches, times


def main() -> None:
    if not (ROOT / "fbanet_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke.py: fbanet_tpu_torch/ not found next to "
                         "this script; run it from a checkout of the repo")
    sys.path.insert(0, str(ROOT))
    # cuBLAS's deterministic workspace, for the trainer phase's
    # use_deterministic_algorithms; read when torch first calls cuBLAS
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    if sys.argv[1:2] == ["configs"]:  # the configs phase, in its own process
        checks, launches, times = phase_configs(card)
        Path(sys.argv[2]).write_text(json.dumps(
            {"checks": checks, "launches": launches, "times": times},
            default=str))
        return
    if sys.argv[1:2] == ["raw"]:  # the raw phase, in its own process
        launches, times = phase_raw(card)
        Path(sys.argv[2]).write_text(json.dumps(
            {"launches": launches, "times": times}, default=str))
        return
    log((lib_path.parent / "build.log").read_text())

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    if sys.argv[1:] == ["ecc"]:  # translation ECC's kernel alone
        print(json.dumps({"ECC": timed("ecc", phase_ecc, card)}), flush=True)
        return
    if sys.argv[1:] == ["ranks"]:  # the multi-rank step alone (W cards)
        import shutil
        import tempfile

        (ROOT / "build").mkdir(exist_ok=True)
        work = Path(tempfile.mkdtemp(prefix="ranks_", dir=ROOT / "build"))
        timed("ranks", phase_ranks, card, work / "ranks")
        shutil.rmtree(work, ignore_errors=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return
    kres = timed("kernels", phase_kernels, MAIN_SHAPES)
    kres.update(timed("backward", phase_backward, MAIN_SHAPES))
    kres.update(timed("reduce", phase_reduce))
    reg, registered = timed("registration", phase_registration, card)
    kres.update(reg)
    served, fwd_ms = timed("slice", phase_slice, card)
    trained, train_ms = timed("train", phase_train, card)
    from_disk, tree_dir = timed("trainer", phase_trainer, card)
    data_parallel = timed("ddp", phase_ddp, card, tree_dir)
    mres, measured = timed("measure", phase_measure, card)
    kres.update(mres)
    vres, varied = timed("variants", phase_variants, card, fwd_ms, train_ms)
    kres.update(vres)
    # the configs phase runs in a process of its own: late in this one,
    # after the ddp phase's process group and the measure phases' hundreds
    # of traces, torch.profiler recorded no kernels in 7 traces of R1 and
    # about half the device time of K1-K4 (PERF.md §6)
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    result = Path(tempfile.mkdtemp(prefix="configs_", dir=ROOT / "build"))
    timed("configs", lambda: subprocess.run([
        sys.executable, str(ROOT / "chip_smoke.py"), "configs",
        str(result / "configs.json")], check=True))
    got = json.loads((result / "configs.json").read_text())
    checks, configured = got["checks"], got["launches"]
    # the raw phase takes a profiler trace: a process of its own too
    timed("raw", lambda: subprocess.run([
        sys.executable, str(ROOT / "chip_smoke.py"), "raw",
        str(result / "raw.json")], check=True))
    raw = json.loads((result / "raw.json").read_text())["launches"]
    # FBANet-32's checks and B=8 times; the wgmma forms at head sizes 8
    # and 32 take their line's numbers from that phase (B=2 at enc1-dec1)
    line_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")
    for name, got in checks.items():
        if name not in kres:
            kres[name] = {k: got[k] for k in line_keys}
        entry = kres[name]
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   got.get("max_abs_err", 0.0))
        entry["fbanet32"] = {k: v for k, v in got.items()
                             if k not in line_keys}
    # launches on the main paths: registration (K5, K6), serving (K1, K2,
    # ECC), training (K1-K4, R1, R2), the entry points from disk (K1-K4,
    # R1, R2), the DDP steps (K1-K4, R1, R2),
    # measurement (K1b, K9-K11 and, through the tools, K1-K4, R1, R2) and
    # the variants (K7, K8 and, through the tools, K1-K4, R1, R2), the
    # configs phase's runs (K1-K4 and their first kernels, R1, R2) and the
    # raw phase's (K1-K4 and their first kernels, R1, R2)
    launches = {k: registered.get(k, 0) + served.get(k, 0) + trained.get(k, 0)
                + from_disk.get(k, 0) + data_parallel.get(k, 0)
                + measured.get(k, 0) + varied.get(k, 0)
                + configured.get(k, 0) + raw.get(k, 0) for k in kres}
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on a main path: "
                             f"{missing}")
    table = (
        ("K1", "K1 fused window attention (wgmma form at head sizes 16 and "
         "64)", "attention_wgmma.cu", "fbanet_tpu/ops/attention_pallas.py:250"),
        ("K1-narrow", "K1 fused window attention (wgmma form at head sizes "
         "8 and 32: FBANet-32's five groups, enc0's C = 32 on one "
         "warpgroup)", "attention_wgmma.cu",
         "fbanet_tpu/ops/attention_pallas.py:250"),
        ("K1-base", "K1 fused window attention (first kernel: f32, K9 and "
         "K7-base base)", "attention.cu",
         "fbanet_tpu/ops/attention_pallas.py:250"),
        ("K2", "K2 fused LeFF (wgmma form, FBANet-32's enc0 at C = 32 "
         "too)", "leff.cu", "fbanet_tpu/ops/leff_pallas.py:172"),
        ("K2-base", "K2 fused LeFF (first kernel: f32, K8-base/K10-base "
         "base)",
         "leff.cu", "fbanet_tpu/ops/leff_pallas.py:172"),
        ("K3", "K3 fused window attention backward (wgmma form at head "
         "sizes 16 and 64)",
         "attention_bwd_wgmma.cu", "fbanet_tpu/ops/attention_pallas.py:334"),
        ("K3-narrow", "K3 fused window attention backward (wgmma form at "
         "head sizes 8 and 32: FBANet-32's five groups, enc0's C = 32 on "
         "one warpgroup)",
         "attention_bwd_wgmma.cu", "fbanet_tpu/ops/attention_pallas.py:334"),
        ("K3-base", "K3 fused window attention backward (first kernel: "
         "f32, K11-base base)", "attention_bwd.cu",
         "fbanet_tpu/ops/attention_pallas.py:334"),
        ("K4", "K4 fused LeFF backward (and K4b; wgmma form, FBANet-32's "
         "enc0 at C = 32 too)", "leff_bwd.cu",
         "fbanet_tpu/ops/leff_pallas.py:278 and :528"),
        ("K4-base", "K4 fused LeFF backward (and K4b; WMMA form: f32)",
         "leff_bwd.cu", "fbanet_tpu/ops/leff_pallas.py:278 and :528"),
        ("R1", "K3/K4 weight-gradient sums (token_matmul)", "reduce.cu",
         "fbanet_tpu/ops/attention_pallas.py:465 and leff_pallas.py:394"),
        ("R2", "K3/K4 partial sums (column_sum)", "reduce.cu",
         "fbanet_tpu/ops/attention_pallas.py:463 and leff_pallas.py:392"),
        ("K5", "K5 homography bilinear warp", "warp.cu",
         "fbanet_tpu/ops/warp_pallas.py:102"),
        ("K6", "K6 dense-coords bilinear warp", "warp.cu",
         "fbanet_tpu/ops/warp_pallas.py:128"),
        ("ECC", "ECC translation ECC over the pyramid, a block a frame "
         "(port only)", "ecc.cu",
         "none: fbanet_tpu/ops/registration.py's XLA loop"),
        ("K1b", "K1b fused window attention on [G, N, C] windows (K1's "
         "wgmma form, windowed entry)", "attention_wgmma.cu",
         "fbanet_tpu/ops/attention_pallas.py:234"),
        ("K9", "K9 attention ablation (measure_swin_rates; K1's wgmma "
         "form)", "attention_ablation_wgmma.cu",
         "scripts/measure_swin_rates.py:136"),
        ("K9-base", "K9 attention ablation (measure_swin_rates; K1's first "
         "kernel)", "attention.cu", "scripts/measure_swin_rates.py:136"),
        ("K10", "K10 LeFF ablation (measure_swin_rates; K2's wgmma form)",
         "leff_ablation.cu", "scripts/measure_swin_rates.py:253"),
        ("K10-base", "K10 LeFF ablation (measure_swin_rates; K2's first "
         "kernel)", "leff_ablation.cu", "scripts/measure_swin_rates.py:253"),
        ("K11", "K11 attention backward ablation (measure_bwd; K3's wgmma "
         "form)", "attention_bwd_wgmma_ablation.cu",
         "scripts/measure_bwd.py:182"),
        ("K11-base", "K11 attention backward ablation (measure_bwd; K3's "
         "first kernel)", "attention_bwd_ablation.cu",
         "scripts/measure_bwd.py:182"),
        ("K7", "K7 attention head-stage variants (measure_swin_variants; "
         "K1's wgmma form)", "attention_variants_wgmma.cu",
         "scripts/measure_swin_variants.py:241"),
        ("K7-base", "K7 attention head-stage variants (measure_swin_variants; "
         "K1's first kernel)", "attention_variants.cu",
         "scripts/measure_swin_variants.py:241"),
        ("K8", "K8 LeFF packed-bf16 variants (measure_swin_variants; K2's "
         "wgmma form)", "leff_variants.cu",
         "scripts/measure_swin_variants.py:355"),
        ("K8-base", "K8 LeFF packed-bf16 variants (measure_swin_variants; "
         "K2's first kernel)", "leff_variants.cu",
         "scripts/measure_swin_variants.py:355"),
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
