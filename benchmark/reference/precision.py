"""The precision the reference computes its products in.

`F32` is the reference itself: every product in float32 (the caller turns
TF32 off). The control runs the reference in a lower precision in the
program's place: each operand of a product rounded to bfloat16 (`BF16`) or
to float8 e4m3 with a per-tensor scale (`FP8`, the step below the
configurations' bfloat16). The rounding passes gradients straight through,
so the control trains as the reference does, on rounded values.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_E4M3_MAX = 448.0


class _RoundFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().float().clamp(min=1e-12)
        scale = _E4M3_MAX / amax
        return ((x * scale).to(torch.float8_e4m3fn).to(x.dtype)) / scale

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundBF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


@dataclass(frozen=True)
class Precision:
    name: str

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return x
        if self.name == "bf16":
            return _RoundBF16.apply(x)
        if self.name == "fp8":
            return _RoundFP8.apply(x)
        raise ValueError(f"unknown precision {self.name!r}")


F32, BF16, FP8 = Precision("f32"), Precision("bf16"), Precision("fp8")
PRECISIONS = {p.name: p for p in (F32, BF16, FP8)}
