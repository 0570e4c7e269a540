"""Closed-form forward FLOPs of the flagship FBANet, per component: the
port's own copy of scripts/flops_accounting.py (the same counts, MACs x 2),
plus `mfu_fields`, the counterpart of bench.py's machine-readable efficiency
fields, against the H100's peak.

    python -m fbanet_tpu_torch.tools.flops_accounting [--batch 4]
        [--size 160] [--frames 14] [--embed 64]

prints a markdown table of GFLOP and share per component.
"""

from __future__ import annotations

import argparse

# NVIDIA H100 SXM, dense bf16 on the tensor cores, at its 700 W limit (the
# data sheet; the peak the port's bounds use)
H100_BF16_PEAK = 989e12


def conv(hw: int, cin: int, cout: int, k: int = 3, batch: int = 1) -> float:
    return batch * hw * hw * k * k * cin * cout * 2.0


def attention_layer(hw: int, c: int, ws: int, batch: int) -> float:
    """One SwinLayer's attention branch: qkv + logits + av + proj."""
    n = ws * ws
    tokens = batch * hw * hw
    qkv = tokens * c * (3 * c) * 2.0
    proj = tokens * c * c * 2.0
    nwin = tokens / n
    logits = nwin * n * n * c * 2.0
    av = nwin * n * n * c * 2.0
    return qkv + proj + logits + av


def leff_layer(hw: int, c: int, mlp: float, batch: int) -> float:
    tokens = batch * hw * hw
    ch = int(c * mlp)
    return (tokens * c * ch * 2.0) * 2 + conv(hw, 1, ch, 3, batch)  # dw-conv


def swin_group(hw: int, c: int, depth: int, ws: int, mlp: float,
               batch: int) -> float:
    per = attention_layer(hw, c, ws, batch) + leff_layer(hw, c, mlp, batch)
    return per * depth


def forward_flops(batch: int, size: int, frames: int, embed: int,
                  ws: int = 8, mlp: float = 4.0) -> dict[str, float]:
    """Closed-form per-component forward FLOPs (MACs x 2) for one batched
    FBANet forward. Sum the values for the model total."""
    b, s, f, d = batch, size, frames, embed

    comps: dict[str, float] = {}

    # per-frame head: conv 3->d + 2 ResBlocks (4 convs d->d), on B*F frames
    comps["per-frame heads"] = (
        conv(s, 3, d, 3, b * f) + 4 * conv(s, d, d, 3, b * f))

    # FAF block
    # 4x4 stride-2 down conv: MACs = out_hw^2 * 16 * cin * cout
    # 2x2 stride-2 deconv: exactly one kernel tap per output pixel ->
    #   MACs = out_hw^2 * cin * cout
    faf = 0.0
    faf += conv(s, d, 1, 3, b) + conv(s, d, 1, 3, b * f)  # channel-summed affinity
    faf += b * s * s * (f * d) * d * 2.0                  # feature_fusion einsum
    faf += 4 * conv(s, d, d, 3, b)                        # res0
    faf += b * (s // 2) ** 2 * 16 * d * 2 * d * 2.0       # down0
    faf += 4 * conv(s // 2, 2 * d, 2 * d, 3, b)           # res1
    faf += b * (s // 4) ** 2 * 16 * 2 * d * 4 * d * 2.0   # down1
    faf += 4 * conv(s // 4, 4 * d, 4 * d, 3, b)           # res2
    faf += b * (s // 2) ** 2 * 4 * d * 2 * d * 2.0        # up0 (2x2 deconv)
    faf += 4 * conv(s // 2, 4 * d, 4 * d, 3, b)           # res3
    faf += b * s * s * 4 * d * d * 2.0                    # up1 (4d -> d)
    faf += conv(s, 2 * d, 2 * d, 3, b) * 4                # res4
    faf += conv(s, 2 * d, d, 3, b)                        # fusion tail
    comps["FAF block"] = faf

    # input/output/cross projections (3x3 ConvProj)
    proj = conv(s, d, d, 3, b)                 # input_proj
    proj += conv(s, 2 * d, d, 3, b) * 2        # output_proj, output_proj_2
    proj += conv(s // 2, 8 * d, 4 * d, 3, b)   # HG2_proj0
    proj += conv(s, 4 * d, 2 * d, 3, b)        # HG2_proj1
    comps["projections"] = proj

    # hourglass swin groups (x2 hourglasses)
    hg = 0.0
    hg += swin_group(s, d, 2, ws, mlp, b)            # enc0
    hg += swin_group(s // 2, 2 * d, 2, ws, mlp, b)   # enc1
    hg += swin_group(s // 4, 4 * d, 2, ws, mlp, b)   # bottleneck
    hg += swin_group(s // 2, 4 * d, 2, ws, mlp, b)   # dec0
    hg += swin_group(s, 2 * d, 2, ws, mlp, b)        # dec1
    comps["attention+LeFF stacks (2 HGs)"] = 2 * hg

    # up/downsample convs inside hourglasses (x2)
    updown = 0.0
    updown += b * (s // 2) ** 2 * 16 * d * 2 * d * 2.0       # down0
    updown += b * (s // 4) ** 2 * 16 * 2 * d * 4 * d * 2.0   # down1
    updown += b * (s // 2) ** 2 * 4 * d * 2 * d * 2.0        # up0 (2x2 deconv)
    updown += b * s * s * 4 * d * d * 2.0                    # up1 (4d -> d)
    comps["hourglass up/down convs (2 HGs)"] = 2 * updown

    # fused x4 tail: conv d->4d@s, conv d->4d@2s, tail conv (4d->12)@2s
    comps["x4 tail (+out conv)"] = (
        conv(s, d, 4 * d, 3, b) + conv(2 * s, d, 4 * d, 3, b)
        + conv(2 * s, 4 * d, 12, 3, b))
    return comps


def mfu_fields(batch: int, frames: int, size: int, embed: int,
               t_fwd_s: float, train_rate: float | None,
               train_batch: int) -> dict:
    """Achieved TFLOP/s from the closed-form FLOP accounting over measured
    times (a forward of `batch` bursts in `t_fwd_s`; `train_rate` samples/s
    at `train_batch`), as fractions of the H100's dense bf16 peak. Train
    FLOPs take the usual 3x forward (backward ~= 2x forward); nothing is
    recomputed in the port's backward beyond what the kernels fold in, and
    that is not counted, so mfu_train is conservative. bench.py's third
    field, the fraction of a convolution ceiling measured on the TPU, has
    no counterpart: no such ceiling was measured on the card."""
    out: dict = {}
    fwd = sum(forward_flops(batch, size, frames, embed).values())
    tf_fwd = fwd / t_fwd_s
    out["tflops_forward"] = round(tf_fwd / 1e12, 2)
    out["mfu_forward"] = round(tf_fwd / H100_BF16_PEAK, 4)
    if train_rate:
        t_step = train_batch / train_rate
        fwd_tb = sum(forward_flops(train_batch, size, frames, embed).values())
        tf_train = 3.0 * fwd_tb / t_step
        out["tflops_train"] = round(tf_train / 1e12, 2)
        out["mfu_train"] = round(tf_train / H100_BF16_PEAK, 4)
    return out


def main(argv=None) -> dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--size", type=int, default=160)
    p.add_argument("--frames", type=int, default=14)
    p.add_argument("--embed", type=int, default=64)
    args = p.parse_args(argv)

    b, s, f, d = args.batch, args.size, args.frames, args.embed
    comps = forward_flops(b, s, f, d)
    total = sum(comps.values())
    print(f"B={b}, {s}px, F={f}, embed {d} — forward FLOPs by component\n")
    print("| component | GFLOP | share |")
    print("|---|---|---|")
    for k, v in sorted(comps.items(), key=lambda kv: -kv[1]):
        print(f"| {k} | {v / 1e9:.1f} | {100 * v / total:.1f}% |")
    print(f"| **total** | **{total / 1e9:.1f}** | |")
    return comps


if __name__ == "__main__":
    main()
