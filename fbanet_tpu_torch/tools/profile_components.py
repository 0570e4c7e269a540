"""Per-component timing of the FBANet forward and backward on the card: the
counterpart of scripts/profile_components.py.

    python -m fbanet_tpu_torch.tools.profile_components [loss heads faf swin
        tail model train align] [--batch 8] [--frames 14] [--size 160]
        [--embed 64] [--device cpu]

Components (default: all), at the published sizes (B = 8 bursts of 14
frames of 160 px, embed 64, bf16 compute, f32 parameters, parameters drawn
by `utils.weights.random_state_dict` from a seed):

- loss: Charbonnier + 3 x GW loss at [B, 4S, 4S, 3], forward + backward
  with respect to the prediction;
- heads: the per-frame conv + 2 ResBlocks on B x F frames;
- faf: the FAF block on [B, F, S, S, D];
- swin: the five SwinGroups (K1 + K2 forward, K3 + K4 backward);
- tail: `fused_tail_x4` (one composed 5x5 conv + the border repair, the
  JAX model's tail) and `tail_x4_direct` (the port's);
- model: the whole forward, no gradient;
- train: one `train.make_train_step` step with AdamW (forward, backward,
  update; drop_path 0, as the script's deterministic loop);
- align: translation `align_burst`, 3 levels x 10 iterations.

A component with a gradient is timed as forward + backward of
mean(module(x)) with respect to its parameters and its input, as the
script's `time_grad`. Each time is the median of ITERS calls after WARMUP,
each call between its own pair of CUDA events (the host clock for CPU
tensors). The script chains its iterations in one jitted `fori_loop`, adds
`acc * 1e-7` to the input so XLA cannot hoist the body, and takes the slope
between two loop lengths; eager PyTorch launches every call it is given, so
none of that is needed here. Each line also prints the component's GFLOP
(tools/flops_accounting.py: the forward count, x 3 with the backward; the
tails at the direct form's count) and TFLOP/s. `main` returns
{component: ms}.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch
from torch import nn

from fbanet_tpu_torch.tools.flops_accounting import forward_flops, swin_group

B, F, S, D = 8, 14, 160, 64
WARMUP, ITERS = 2, 10
COMPONENTS = ("loss", "heads", "faf", "swin", "tail", "model", "train",
              "align")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_call(fn, device: str) -> float:
    """Median ms of ITERS calls of fn() after WARMUP calls."""
    for _ in range(WARMUP):
        fn()
    if device == "cuda":
        torch.cuda.synchronize()
        marks = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(ITERS)]
        for start, end in marks:
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in marks)
    times = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _uniform(shape, seed: int, device: str) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(size=shape).astype(np.float32)).to(
        device)


def _seeded(module: nn.Module, device: str, seed: int = 0) -> nn.Module:
    from fbanet_tpu_torch.utils.weights import random_state_dict

    module.load_state_dict(random_state_dict(module, seed=seed), strict=True)
    return module.to(device)


def time_grad(module: nn.Module, x_shape, device: str) -> float:
    """ms of forward + backward of mean(module(x)) with respect to
    module's parameters and x (x uniform in [0, 1) from a seed)."""
    x0 = _uniform(x_shape, 1, device)
    params = list(module.parameters())

    def call():
        x = x0.clone().requires_grad_(True)
        val = module(x).float().mean()
        torch.autograd.grad(val, params + [x], allow_unused=True)

    return time_call(call, device)


class _Heads(nn.Module):
    """The model's per-frame head: conv 3 -> D and two ResBlocks."""

    def __init__(self, d: int, dtype):
        super().__init__()
        from fbanet_tpu_torch.models.blocks import ResBlock
        from fbanet_tpu_torch.models.layers import Conv

        self.dtype = dtype
        self.head = Conv(3, d, 3, padding=1)
        self.body0, self.body1 = ResBlock(d), ResBlock(d)

    def forward(self, x):
        dt = self.dtype
        return self.body1(self.body0(self.head(x, dt), dt), dt)


class _Cast(nn.Module):
    """`module(x.to(dtype), ...)` for a block that computes in its input's
    dtype (SwinGroup) or takes the compute dtype (FAFBlock)."""

    def __init__(self, module: nn.Module, dtype, pass_dtype: bool):
        super().__init__()
        self.module, self.dtype, self.pass_dtype = module, dtype, pass_dtype

    def forward(self, x):
        x = x.to(self.dtype)
        return self.module(x, self.dtype) if self.pass_dtype else self.module(x)


class _Tail(nn.Module):
    """The x4 tail's parameters (TailUpsampler, the final conv to 3) and one
    of its two forms."""

    def __init__(self, d: int, dtype, fused: bool):
        super().__init__()
        from fbanet_tpu_torch.models.blocks import TailUpsampler
        from fbanet_tpu_torch.models.layers import Conv

        self.dtype, self.fused = dtype, fused
        self.tail_upsampler = TailUpsampler(d)
        self.tail_conv = Conv(d, 3, 3, padding=1)

    def forward(self, x):
        from fbanet_tpu_torch.models.blocks import fused_tail_x4, tail_x4_direct

        t, c = self.tail_upsampler, self.tail_conv
        fn = fused_tail_x4 if self.fused else tail_x4_direct
        return fn(x.to(self.dtype), t.conv0.weight, t.conv0.bias,
                  t.conv1.weight, t.conv1.bias, c.weight, c.bias, self.dtype)


def swin_groups(s: int, d: int):
    """(key, dim, resolution, heads) of the five SwinGroups."""
    return [(f"enc0_d{d}@{s}", d, s, 1), (f"enc1_d{2 * d}@{s // 2}", 2 * d,
                                          s // 2, 2),
            (f"bott_d{4 * d}@{s // 4}", 4 * d, s // 4, 16),
            (f"dec0_d{4 * d}@{s // 2}", 4 * d, s // 2, 16),
            (f"dec1_d{2 * d}@{s}", 2 * d, s, 8)]


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("components", nargs="*", default=list(COMPONENTS))
    p.add_argument("--batch", type=int, default=B)
    p.add_argument("--frames", type=int, default=F)
    p.add_argument("--size", type=int, default=S)
    p.add_argument("--embed", type=int, default=D)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (the plain versions)")
    args = p.parse_args(argv)
    unknown = set(args.components) - set(COMPONENTS)
    if unknown:
        p.error(f"unknown components {sorted(unknown)}; pick from "
                f"{list(COMPONENTS)}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the kernels run on the card "
                         "(--device cpu times the plain versions)")
    return args


def main(argv=None) -> dict[str, float]:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    b, f, s, d, dev = args.batch, args.frames, args.size, args.embed, \
        args.device
    which = set(args.components)
    bf16 = torch.bfloat16
    name = torch.cuda.get_device_name(0) if dev == "cuda" else dev
    log(f"device: {dev} ({name}) B={b} F={f} {s}px embed {d} bf16")
    fwd = forward_flops(b, s, f, d)
    out: dict[str, float] = {}

    def report(key: str, ms: float, flops: float | None) -> None:
        out[key] = ms
        if flops is None:
            log(f"{key:24s} {ms:10.3f} ms")
        else:
            log(f"{key:24s} {ms:10.3f} ms {flops / 1e9:9.1f} GF "
                f"{flops / ms / 1e9:7.2f} TF/s")

    if "loss" in which:
        from fbanet_tpu_torch.losses import fbanet_training_loss

        pred0 = _uniform((b, 4 * s, 4 * s, 3), 0, dev)
        hr = _uniform((b, 4 * s, 4 * s, 3), 1, dev)

        def loss_call():
            pred = pred0.clone().requires_grad_(True)
            torch.autograd.grad(fbanet_training_loss(pred, hr), pred)

        report("loss", time_call(loss_call, dev), None)

    if "heads" in which:
        report("heads", time_grad(_seeded(_Heads(d, bf16), dev),
                                  (b * f, s, s, 3), dev),
               3 * fwd["per-frame heads"])

    if "faf" in which:
        from fbanet_tpu_torch.models.blocks import FAFBlock

        faf = _Cast(_seeded(FAFBlock(d, f), dev), bf16, pass_dtype=True)
        report("faf", time_grad(faf, (b, f, s, s, d), dev),
               3 * fwd["FAF block"])

    if "swin" in which:
        from fbanet_tpu_torch.models.blocks import SwinGroup

        for key, dim, res, heads in swin_groups(s, d):
            grp = _Cast(_seeded(SwinGroup(dim, (res, res), 2, heads, 8), dev),
                        bf16, pass_dtype=False)
            report(key, time_grad(grp, (b, res, res, dim), dev),
                   3 * swin_group(res, dim, 2, 8, 4.0, b))

    if "tail" in which:
        for key, fused in (("tail_fused", True), ("tail_direct", False)):
            report(key, time_grad(_seeded(_Tail(d, bf16, fused), dev),
                                  (b, s, s, d), dev),
                   3 * fwd["x4 tail (+out conv)"])

    if "model" in which or "train" in which:
        from fbanet_tpu_torch.config import ModelConfig
        from fbanet_tpu_torch.models import create_model

        cfg = ModelConfig(num_frames=f, img_size=s, embed_dim=d,
                          window_size=8, dtype="bfloat16", drop_path_rate=0.0)
        model = _seeded(create_model(cfg, device=dev, seed=0), dev)
        x = _uniform((b, f, s, s, 3), 1, dev)

    if "model" in which:
        def model_call():
            with torch.no_grad():
                model(x)

        report("model_fwd", time_call(model_call, dev), sum(fwd.values()))

    if "train" in which:
        from fbanet_tpu_torch.config import TrainConfig
        from fbanet_tpu_torch.train import make_optimizer, make_train_step

        tcfg = TrainConfig(batch_size=b, optimizer="adamw")
        step = make_train_step(model, make_optimizer(model.parameters(), tcfg),
                               tcfg)
        hr = _uniform((b, 4 * s, 4 * s, 3), 2, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        report("train", time_call(lambda: step(x, hr, gen, tcfg.lr_initial),
                                  dev), 3 * sum(fwd.values()))

    if "align" in which:
        from fbanet_tpu_torch.ops.registration import align_burst

        bursts = _uniform((b, f, s, s, 3), 0, dev)
        report("align", time_call(lambda: align_burst(
            bursts, motion="translation", levels=3, iters_per_level=10),
            dev), None)

    log(str({k: round(v, 3) for k, v in out.items()}))
    return out


if __name__ == "__main__":
    main()
