"""What the benchmark hands the program and the reference alike, made on
the device from `--seed`: the weights and the bursts.

Weights follow the model's init rule (truncated-normal lecun weights at 2
std, zero biases, unit LayerNorm scales, trunc-normal(0.02) bias tables,
PReLU slopes as constructed), drawn as one truncated-normal buffer on the
card and cut into leaves. One departure: `tail_conv.weight` is drawn like
every other conv, where the init rule zeroes it. A zero tail makes the
untrained model output its bilinear base whatever the rest computes, and
gives every other leaf a zero first gradient, so nothing but the tail
would be compared. It is drawn at a twentieth of the lecun scale: the
untrained residual over the bilinear base then has an RMS of ~0.05, as a
trained model's detail has, where at the full scale it is ~1.1 and most
of the output is clamped. The work of a step does not depend on the
values.

Bursts are photographic-like fields (16 random sinusoids per channel, as
the port's `data/synthetic.py::realistic_bursts`): frame f samples the
field at (y + dy_f, x + dx_f) with sub-pixel shifts in [-s, s) (frame 0
unshifted), plus sensor noise of std 0.01; the HR target is the noise-free
frame-0 field on the x4 grid. Both are stored as uint8, as the data path
ships them, and widened on the card by whoever reads them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_FIELD_TERMS = 16
_NOISE = 0.01
# tail_conv's draw against the lecun scale: an untrained residual of RMS
# ~0.05 (at the lecun scale ~1.1, and 60 % of the output clamped)
_TAIL_SCALE = 0.05


def key(*entropy: int) -> int:
    """A 63-bit generator seed from integers of any size (the seed, a batch
    index, a step, a rank)."""
    return int(np.random.SeedSequence([int(e) for e in entropy])
               .generate_state(1, np.uint64)[0] >> 1)


def generator(device, *entropy: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(key(*entropy))


def _init_rule(name: str, shape: tuple) -> tuple[str, float]:
    """('zero' | 'one' | 'const' | 'draw', value or std) of one leaf."""
    leaf = name.rsplit(".", 1)[-1]
    parent = name.rsplit(".", 2)[-2] if "." in name else ""
    if leaf == "bias":
        return "zero", 0.0
    if parent.startswith("norm"):
        return "one", 1.0
    if tuple(shape) == (1,):
        return "const", 0.1 if "feature_fusion_act" in name else 0.25
    if leaf == "relative_position_bias_table":
        return "draw", 0.02
    fan_in = math.prod(shape[1:])
    if "ConvTranspose" in name:  # [I, O, kh, kw]: fan-in kh * kw * I
        fan_in = shape[0] * shape[2] * shape[3]
    scale = _TAIL_SCALE if name == "tail_conv.weight" else 1.0
    return "draw", scale * math.sqrt(1.0 / fan_in) / 0.87962566103423978


def make_weights(shapes: dict[str, tuple], seed: int, device) -> dict:
    """{name: float32 tensor on `device`} for the leaves `shapes` (the
    model's named parameters), from `seed`; leaves draw in name order."""
    rules = {n: _init_rule(n, s) for n, s in shapes.items()}
    total = sum(math.prod(s) for n, s in shapes.items()
                if rules[n][0] == "draw")
    buf = torch.empty(total, device=device)
    torch.nn.init.trunc_normal_(buf, 0.0, 1.0, -2.0, 2.0,
                                generator=generator(device, seed, 0x77))
    out, at = {}, 0
    for name, shape in sorted(shapes.items()):
        kind, val = rules[name]
        n = math.prod(shape)
        if kind == "draw":
            out[name] = (buf[at:at + n] * val).reshape(shape)
            at += n
        else:
            out[name] = torch.full(shape, val, device=device)
    return out


def parameter_shapes(module: torch.nn.Module) -> dict[str, tuple]:
    return {n: tuple(p.shape) for n, p in module.named_parameters()}


@torch.no_grad()
def bursts(seed: int, index: int, batch: int, frames: int, size: int,
           channels: int, shift: float, device, scale: int = 4,
           chunk: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """(LR uint8 [B, F, S, S, C], HR uint8 [B, S*scale, S*scale, C]) of
    pool batch `index`, from (seed, index) alone."""
    g = generator(device, seed, index)
    k = _FIELD_TERMS

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo

    freq = uniform((batch, k, 2), -0.35, 0.35)
    phase = uniform((batch, k, channels), 0.0, 2 * math.pi)
    amp = uniform((batch, k), 0.3, 1.0) * (2.0 / k)
    shifts = uniform((batch, frames, 2), -shift, shift)
    shifts[:, 0] = 0.0
    noise = torch.randn((batch, frames, size, size, channels), generator=g,
                        device=device) * _NOISE
    ax = torch.arange(size, device=device, dtype=torch.float32)
    hax = (torch.arange(size * scale, device=device, dtype=torch.float32)
           + 0.5) / scale - 0.5

    def field(rows, ys, xs):
        """[r, F, Y, X, C]: the rows' fields sampled at rows ys [r, F, Y]
        and columns xs [r, F, X]."""
        fy, fx = freq[rows, :, 0], freq[rows, :, 1]  # [r, k]
        ty = fy[:, None, :, None, None] * ys[:, :, None, :, None]
        tx = fx[:, None, :, None, None] * xs[:, :, None, None, :]
        arg = (ty + tx)[..., None] + phase[rows][:, None, :, None, None, :]
        return torch.einsum("rk,rfkyxc->rfyxc", amp[rows], torch.sin(arg))

    lr = torch.empty((batch, frames, size, size, channels), device=device)
    hr = torch.empty((batch, size * scale, size * scale, channels),
                     device=device)
    for r0 in range(0, batch, chunk):
        rows = slice(r0, min(batch, r0 + chunk))
        ys = ax[None, None] + shifts[rows, :, 0, None]  # [r, F, S]
        xs = ax[None, None] + shifts[rows, :, 1, None]
        lr[rows] = field(rows, ys, xs)
        grid = hax.expand(rows.stop - r0, 1, -1)
        hr[rows] = field(rows, grid, grid)[:, 0]
    norm = torch.clamp(lr.abs().amax(), min=1.0)
    lr = torch.clamp(0.5 + 0.45 * lr / norm + noise, 0.0, 1.0)
    hr = torch.clamp(0.5 + 0.45 * hr / norm, 0.0, 1.0)

    def store(x):
        return torch.round(x * 255.0).to(torch.uint8)

    return store(lr), store(hr)
