"""Batch-16 occupancy and the Downsample form, on the card (counterpart of
scripts/measure_downsample_b16.py).

    python -m fbanet_tpu_torch.tools.measure_downsample_b16 [fwd align pipe
        prof down ab] [--batches 4,8,16] [--frames 14 --size 160
        --embed 64] [--device cpu]

Modes (default: fwd align pipe):

- fwd: the FBANet-64 forward (14 frames, 160 px, bf16, parameters from a
  seed) at each batch: ms and bursts/s;
- align: translation `align_burst`, 3 levels x 10 iterations, eps 0;
- pipe: align, then the forward, in one call;
- prof: the forward of each component (per-frame heads, FAF, the five
  SwinGroups, the x4 tail) at each batch, to see which stage loses
  occupancy as the batch grows;
- down: the model's Downsample, a 4x4 stride-2 conv (`models/layers.py::
  Downsample`, cuDNN), against the pad + space-to-depth + matmul-taps form
  (`DownsampleS2D`, built here as the JAX script builds it: the same
  parameters, the same sum), at the two shapes the model runs it (B=8:
  160^2 C64->128, 80^2 C128->256), forward and forward + backward;
- ab: the whole forward at each batch with every Downsample in each form
  (the JAX script: B=8 and B=4).

Each time is the median of 10 calls after 2 warm-up calls, between CUDA
events on the card (the host clock on the CPU): `profile_components.
time_call`. The JAX script's chained fori_loop slope is XLA's and has no
counterpart here. `main` returns {line: ms}.
"""

from __future__ import annotations

import argparse

import torch
from torch import nn

from fbanet_tpu_torch.models.layers import Downsample
from fbanet_tpu_torch.tools.profile_components import (
    _Cast,
    _Heads,
    _seeded,
    _Tail,
    _uniform,
    swin_groups,
    time_call,
    time_grad,
)

MODES = ("fwd", "align", "pipe", "prof", "down", "ab")


class DownsampleS2D(Downsample):
    """Downsample's function and parameters (`Conv_0.weight` [O, I, 4, 4],
    `Conv_0.bias`) as pad + space-to-depth + four matmul taps:
    P2[y, x, (d, e, i)] = pad(x, 1)[2y + d, 2x + e, i] and out[y', x'] =
    sum over a, b of P2[y' + a, x' + b] @ K[2a + d, 2b + e, i, o]."""

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        conv = self.Conv_0
        b, h, w, c = x.shape
        o = conv.weight.shape[0]
        # [O, I, kh, kw] -> [a, d, b, e, i, o] with kh = 2a + d, kw = 2b + e
        kd = conv.weight.to(dtype).permute(2, 3, 1, 0).reshape(2, 2, 2, 2, c, o)
        h2, w2 = h // 2, w // 2
        p = nn.functional.pad(x.to(dtype), (0, 0, 1, 1, 1, 1))
        p2 = p.reshape(b, h2 + 1, 2, w2 + 1, 2, c).permute(0, 1, 3, 2, 4, 5)
        p2 = p2.reshape(b, h2 + 1, w2 + 1, 4 * c)
        out = conv.bias.to(dtype)
        for a in range(2):
            for bb in range(2):
                k_ab = kd[a, :, bb].reshape(4 * c, o)
                out = out + p2[:, a:a + h2, bb:bb + w2] @ k_ab
        return out


def _model(cfg, device: str):
    from fbanet_tpu_torch.models import create_model

    return _seeded(create_model(cfg, device=device, seed=0), device)


def main(argv: list[str] | None = None) -> dict[str, float]:
    from fbanet_tpu_torch.config import ModelConfig
    from fbanet_tpu_torch.models.blocks import FAFBlock, SwinGroup
    from fbanet_tpu_torch.ops.registration import align_burst
    from fbanet_tpu_torch.train import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("modes", nargs="*", default=["fwd", "align", "pipe"])
    p.add_argument("--batches", default="4,8,16")
    p.add_argument("--frames", type=int, default=14)
    p.add_argument("--size", type=int, default=160)
    p.add_argument("--embed", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without one) or cpu")
    args = p.parse_args(argv)
    unknown = set(args.modes) - set(MODES)
    if unknown:
        p.error(f"unknown modes {sorted(unknown)}; pick from {list(MODES)}")
    dev = str(resolve_device(args.device, "measure_downsample_b16"))
    which = set(args.modes)
    batches = [int(b) for b in args.batches.split(",")]
    f, s, d = args.frames, args.size, args.embed
    bf16 = torch.bfloat16
    name = torch.cuda.get_device_name(0) if dev == "cuda" else "cpu"
    print(f"device: {name}; F={f} {s}px embed {d} bf16, batches {batches}",
          flush=True)
    cfg = ModelConfig(num_frames=f, img_size=s, embed_dim=d, window_size=8,
                      dtype="bfloat16", drop_path_rate=0.0)
    out: dict[str, float] = {}

    def report(key: str, ms: float, batch: int | None = None) -> None:
        out[key] = ms
        rate = f" = {batch / ms * 1e3:.1f} bursts/s" if batch else ""
        print(f"{key}: {ms:.3f} ms{rate}", flush=True)

    if which & {"fwd", "pipe"}:
        model = _model(cfg, dev)
    for b in batches:
        if not which & {"fwd", "align", "pipe"}:
            break
        x = _uniform((b, f, s, s, 3), 1, dev)
        with torch.no_grad():
            if "fwd" in which:
                report(f"fwd B{b}", time_call(lambda: model(x), dev), b)
            align = lambda: align_burst(  # noqa: E731
                x, motion="translation", levels=3, iters_per_level=10)[0]
            if "align" in which:
                report(f"align B{b}", time_call(align, dev), b)
            if "pipe" in which:
                report(f"pipe B{b}", time_call(
                    lambda: model(align()).clamp(0, 1), dev), b)

    if "prof" in which:
        comps = [("heads", _Heads(d, bf16), lambda b: (b * f, s, s, 3)),
                 ("faf", _Cast(FAFBlock(d, f), bf16, pass_dtype=True),
                  lambda b: (b, f, s, s, d))]
        for key, dim, res, heads in swin_groups(s, d):
            comps.append((key, _Cast(SwinGroup(dim, (res, res), 2, heads, 8),
                                     bf16, pass_dtype=False),
                          lambda b, dim=dim, res=res: (b, res, res, dim)))
        comps.append(("tail", _Tail(d, bf16, fused=False),
                      lambda b: (b, s, s, d)))
        for key, mod, shape in comps:
            mod = _seeded(mod, dev)
            for b in batches:
                x = _uniform(shape(b), 1, dev)
                with torch.no_grad():
                    report(f"prof {key} B{b}", time_call(lambda: mod(x), dev))
        print(f"| component | {' | '.join(f'B{b} fwd ms' for b in batches)} |")
        print("|---|" + "---|" * len(batches))
        for key, _m, _s in comps:
            print(f"| {key} | " + " | ".join(
                f"{out[f'prof {key} B{b}']:.3f}" for b in batches) + " |")

    if "down" in which:
        print("| shape | form | fwd ms | fwd+bwd ms |")
        print("|---|---|---|---|")
        for (b, hw, c, fo) in [(8, s, d, 2 * d), (8, s // 2, 2 * d, 4 * d)]:
            conv = _seeded(Downsample(c, fo), dev)
            s2d = DownsampleS2D(c, fo).to(dev)
            s2d.load_state_dict(conv.state_dict())
            for tag, mod in (("conv", conv), ("s2d+mm", s2d)):
                m = _Cast(mod, bf16, pass_dtype=True)
                x = _uniform((b, hw, hw, c), 1, dev)
                with torch.no_grad():
                    fw = time_call(lambda: m(x), dev)
                fb = time_grad(m, (b, hw, hw, c), dev)
                key = f"down {tag} B{b} {hw}^2 C{c}->{fo}"
                out[f"{key} fwd"], out[f"{key} fwd+bwd"] = fw, fb
                print(f"| B{b} {hw}^2 {c}->{fo} | {tag} | {fw:.3f} | "
                      f"{fb:.3f} |", flush=True)

    if "ab" in which:
        model = _model(cfg, dev)
        downs = [m for m in model.modules() if isinstance(m, Downsample)]
        for b in batches:
            x = _uniform((b, f, s, s, 3), 1, dev)
            for tag, klass in (("s2d+mm", DownsampleS2D), ("conv", Downsample)):
                for m in downs:
                    m.__class__ = klass
                with torch.no_grad():
                    report(f"ab fwd B{b} {tag}", time_call(lambda: model(x),
                                                           dev), b)
    return out


if __name__ == "__main__":
    main()
