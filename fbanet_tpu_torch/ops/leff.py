"""K2 — fused LeFF (norm2 + dense -> GELU -> depthwise 3x3 -> GELU -> dense).

`fused_leff` is the dispatcher (the counterpart of
fbanet_tpu/ops/leff_pallas.py::fused_leff). For a CUDA tensor it launches the
hand-written kernel in `csrc/leff.cu`, which replaces the TPU kernel
`_leff_kernel`, or raises for a shape the kernel does not take. For a CPU
tensor, or with `plain=True`, it runs the plain PyTorch version below.

The plain version follows the TPU kernel's rounding points
(leff_pallas.py:172-222): LN in f32 rounded to the compute dtype;
h1 = gelu(f32 product + f32 bias) rounded; the depthwise conv with f32 taps
and bias on the rounded h1; h2 = gelu rounded; f32-accumulated dense2 +
f32 bias. GELU is the tanh approximation, jax.nn.gelu's default.

`fused_leff.launches` counts kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fbanet_tpu_torch.ops import _build
from fbanet_tpu_torch.ops.attention import _SMEM_LIMIT, _rounded
from fbanet_tpu_torch.ops.norm import layer_norm_f32


def _leff_math(x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2,
               cdtype: torch.dtype) -> torch.Tensor:
    """[B, H, W, C] -> f32 [B, H, W, C] branch. w1 [Ch, C], w2 [C, Ch]
    (torch Linear), wdw [Ch, 1, 3, 3] (torch depthwise Conv2d)."""
    ch = w1.shape[0]
    y = _rounded(layer_norm_f32(x, ln_scale, ln_bias), cdtype)
    h1 = _rounded(F.gelu(y @ _rounded(w1, cdtype).t() + b1.float(),
                         approximate="tanh"), cdtype)
    # depthwise 3x3, zero padding, f32 taps: an exact f32 sum of 9 shifted
    # products (no convolution library, whose f32 path may run in TF32)
    hp = F.pad(h1, (0, 0, 1, 1, 1, 1))
    hh, ww = x.shape[1], x.shape[2]
    taps = wdw.float().reshape(ch, 9)
    z2 = bdw.float().expand_as(h1)
    for ky in range(3):
        for kx in range(3):
            z2 = z2 + hp[:, ky:ky + hh, kx:kx + ww] * taps[:, ky * 3 + kx]
    h2 = _rounded(F.gelu(z2, approximate="tanh"), cdtype)
    return h2 @ _rounded(w2, cdtype).t() + b2.float()


def leff_reference(x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2
                   ) -> torch.Tensor:
    """Plain version: [B, H, W, C] -> [B, H, W, C] branch, pre-residual,
    computed in x's dtype (leff_pallas.py:48-69)."""
    return _leff_math(x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2,
                      x.dtype).to(x.dtype)


def _unsupported(why: str, x: torch.Tensor, ch: int):
    raise ValueError(f"fused_leff kernel does not take x {tuple(x.shape)} "
                     f"{x.dtype}, hidden {ch}: {why}")


def fused_leff(x: torch.Tensor, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2,
               *, residual: bool = False, plain: bool = False
               ) -> torch.Tensor:
    """Fused norm2 + LeFF on `[B, H, W, C]`, computed in x's dtype; with
    `residual=True` returns `x + branch`. `plain=True` forces the plain
    version on any device."""
    ch = w1.shape[0]
    if plain or x.device.type == "cpu":
        out = _leff_math(x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2,
                         x.dtype)
        if residual:
            out = out + x.float()
        return out.to(x.dtype)
    if x.device.type != "cuda":
        _unsupported(f"no kernel for device {x.device}", x, ch)
    if x.dtype not in (torch.float32, torch.bfloat16):
        _unsupported("dtype must be float32 or bfloat16", x, ch)
    if not x.is_contiguous():
        _unsupported("x must be contiguous", x, ch)
    b, h, w, c = x.shape
    if tuple(wdw.shape) != (ch, 1, 3, 3):
        _unsupported(f"depthwise weight {tuple(wdw.shape)}", x, ch)
    lib = _build.library()
    bf16 = int(x.dtype == torch.bfloat16)
    smem = lib.fbanet_leff_smem(c, ch, bf16)
    if smem == 0:
        _unsupported("in bfloat16 C and the hidden width must be multiples "
                     "of 16 (tensor-core tiles)", x, ch)
    if smem > _SMEM_LIMIT:
        _unsupported(f"needs {smem} B of shared memory per block "
                     f"(limit {_SMEM_LIMIT})", x, ch)

    def f32(t):
        return t.to(device=x.device, dtype=torch.float32).contiguous()

    def wt(t):
        return t.to(device=x.device, dtype=x.dtype).contiguous()

    args = [f32(ln_scale), f32(ln_bias), wt(w1), f32(b1), f32(wdw), f32(bdw),
            wt(w2), f32(b2)]
    out = torch.empty_like(x)
    err = lib.fbanet_leff(
        x.data_ptr(), out.data_ptr(), *[a.data_ptr() for a in args],
        b, h, w, c, ch, int(residual), bf16,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_leff")
    fused_leff.launches += 1
    return out


fused_leff.launches = 0
