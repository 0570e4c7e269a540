"""K2 and K4 — fused LeFF (norm2 + dense -> GELU -> depthwise 3x3 -> GELU ->
dense) and its backward.

`fused_leff` is the dispatcher (the counterpart of
fbanet_tpu/ops/leff_pallas.py::fused_leff). It is a `torch.autograd.Function`:
its forward is K2 and its backward K4. For CUDA tensors the forward launches
the hand-written kernel in `csrc/leff.cu` (which replaces the TPU kernel
`_leff_kernel`) and the backward the one in `csrc/leff_bwd.cu` (which
replaces both `_leff_bwd_kernel` and its column-blocked twin
`_leff_bwd2d_kernel`), followed by the fixed-order sums of `ops/reduce.py`;
either raises for a shape its kernel does not take. For CPU tensors, or with
`plain=True`, both run the plain PyTorch versions below. The forward saves
only the layer input and the parameters.

The plain forward follows the TPU kernel's rounding points
(leff_pallas.py:172-222): LN in f32 rounded to the compute dtype;
h1 = gelu(f32 product + f32 bias) rounded; the depthwise conv with f32 taps
and bias on the rounded h1; h2 = gelu rounded; f32-accumulated dense2 +
f32 bias. GELU is the tanh approximation, jax.nn.gelu's default. The plain
backward, `leff_bwd_reference`, follows `_leff_bwd_kernel`
(leff_pallas.py:278-401) on the whole map, with the exact derivative of the
tanh GELU.

Under differentiation the JAX package runs this kernel pair only at enc0,
enc1 and the bottleneck: at dec0/dec1 it takes an XLA forward that saves
the pre-activations and an XLA backward (`_pallas_bwd_shape`,
leff_pallas.py:737-745), because the blocked TPU backward does not fit VMEM
there. That is a TPU memory limit, not another function, and its bf16
training forward rounds differently there (ROADMAP Queue 3 item 1). The port
runs K2 + K4 at all five shapes.

`fused_leff.launches` counts K2 launches, `leff_bwd.launches` K4 launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fbanet_tpu_torch.ops import _build
from fbanet_tpu_torch.ops.attention import _SMEM_LIMIT, _rounded
from fbanet_tpu_torch.ops.norm import LN_EPS, layer_norm_f32
from fbanet_tpu_torch.ops.reduce import column_sum, token_matmul


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


def _gelu_grad(z: torch.Tensor) -> torch.Tensor:
    """d/dz of the tanh GELU x * cdf, cdf = 0.5 (1 + tanh(k (x + 0.044715
    x^3))), in the form autodiff of jax.nn.gelu takes."""
    k = 0.7978845608028654
    t = torch.tanh(k * (z + 0.044715 * (z * z * z)))
    cdf = 0.5 * (1.0 + t)
    return cdf + z * (0.5 * (1.0 - t * t)) * (k * (1.0 + 3.0 * 0.044715 * (z * z)))


def _taps(a: torch.Tensor):
    """The 3x3 neighbourhood of [B, H, W, Ch] with zero padding: yields
    (tap index ky * 3 + kx, a shifted by (ky - 1, kx - 1))."""
    hh, ww = a.shape[1], a.shape[2]
    ap = F.pad(a, (0, 0, 1, 1, 1, 1))
    for ky in range(3):
        for kx in range(3):
            yield ky * 3 + kx, ap[:, ky:ky + hh, kx:kx + ww]


def leff_bwd_reference(x, g, ln_scale, ln_bias, w1, b1, wdw, bdw, w2):
    """Plain backward on [B, H, W, C], computed in x's dtype, for the
    incoming gradient g of the branch. Follows `_leff_bwd_kernel`
    (leff_pallas.py:278-401): recompute z1, h1, z2, h2 in f32; dh2 = g W2;
    dz2 = gelu'(z2) dh2; dh1 and the tap gradients of the depthwise conv;
    dz1 = gelu'(z1) dh1, rounded for dy = dz1 W1; LN backward. Returns (dx in
    x's dtype, then f32 gradients of ln scale, ln bias, w1 [Ch, C], b1,
    wdw [Ch, 1, 3, 3], bdw, w2 [C, Ch], b2), torch layouts."""
    cd = x.dtype
    ch = w1.shape[0]
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    inv = torch.rsqrt(var + LN_EPS)
    xhat = (xf - mu) * inv
    lns = ln_scale.float()
    y = _rounded(xhat * lns + ln_bias.float(), cd)
    w1c, w2c = _rounded(w1, cd), _rounded(w2, cd)
    z1 = y @ w1c.t() + b1.float()
    h1 = F.gelu(z1, approximate="tanh")
    taps = wdw.float().reshape(ch, 9)
    z2 = bdw.float().expand_as(h1)
    for tap, h1s in _taps(h1):
        z2 = z2 + h1s * taps[:, tap]
    h2c = _rounded(F.gelu(z2, approximate="tanh"), cd)
    g2 = _rounded(g, cd)
    dz2 = _gelu_grad(z2) * (g2 @ w2c)
    dwdw = torch.zeros(ch, 9, device=x.device)
    # the transposed conv, taps in order: dh1 at p gathers dz2 at
    # p - (ky - 1, kx - 1), i.e. the shift of tap 8 - tap
    shifted = dict(_taps(dz2))
    dh1 = torch.zeros_like(dz2)
    for tap in range(9):
        dh1 = dh1 + shifted[8 - tap] * taps[:, tap]
    for tap, h1s in _taps(h1):
        dwdw[:, tap] = (h1s * dz2).reshape(-1, ch).sum(0)
    dz1 = _gelu_grad(z1) * dh1
    dz1c = _rounded(dz1, cd)
    dy = dz1c @ w1c
    dxh = dy * lns
    m1 = dxh.mean(-1, keepdim=True)
    m2 = (dxh * xhat).mean(-1, keepdim=True)
    dx = inv * (dxh - m1 - xhat * m2)

    def flat(a):
        return a.reshape(-1, a.shape[-1])

    return (dx.to(cd), flat(dy * xhat).sum(0), flat(dy).sum(0),
            flat(dz1c).t() @ flat(y), flat(dz1).sum(0),
            dwdw.reshape(ch, 1, 3, 3), flat(dz2).sum(0),
            flat(g2).t() @ flat(h2c), flat(g2).sum(0))


def _unsupported(why: str, x: torch.Tensor, ch: int):
    raise ValueError(f"fused_leff kernel does not take x {tuple(x.shape)} "
                     f"{x.dtype}, hidden {ch}: {why}")


def _check_kernel_shape(x, wdw, ch):
    if x.device.type != "cuda":
        _unsupported(f"no kernel for device {x.device}", x, ch)
    if x.dtype not in (torch.float32, torch.bfloat16):
        _unsupported("dtype must be float32 or bfloat16", x, ch)
    if not x.is_contiguous():
        _unsupported("x must be contiguous", x, ch)
    if tuple(wdw.shape) != (ch, 1, 3, 3):
        _unsupported(f"depthwise weight {tuple(wdw.shape)}", x, ch)


def _kernel_args(x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2):
    def f32(t):
        return t.to(device=x.device, dtype=torch.float32).contiguous()

    def wt(t):
        return t.to(device=x.device, dtype=x.dtype).contiguous()

    return [f32(ln_scale), f32(ln_bias), wt(w1), f32(b1), f32(wdw), f32(bdw),
            wt(w2), None if b2 is None else f32(b2)]


def _kernel_forward(x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2, residual):
    """Launch K2."""
    ch = w1.shape[0]
    _check_kernel_shape(x, wdw, ch)
    b, h, w, c = x.shape
    lib = _build.library()
    bf16 = int(x.dtype == torch.bfloat16)
    smem = lib.fbanet_leff_smem(c, ch, bf16)
    if smem == 0:
        _unsupported("in bfloat16 C and the hidden width must be multiples "
                     "of 16 (tensor-core tiles)", x, ch)
    if smem > _SMEM_LIMIT:
        _unsupported(f"needs {smem} B of shared memory per block "
                     f"(limit {_SMEM_LIMIT})", x, ch)
    args = _kernel_args(x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2)
    out = torch.empty_like(x)
    err = lib.fbanet_leff(
        x.data_ptr(), out.data_ptr(), *[a.data_ptr() for a in args],
        b, h, w, c, ch, int(residual), bf16,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_leff")
    fused_leff.launches += 1
    return out


def leff_bwd(x, g, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, *,
             residual: bool = False):
    """K4 on CUDA tensors: the backward of `fused_leff` for the incoming
    gradient g [B, H, W, C] (x's dtype). Returns what `leff_bwd_reference`
    returns (dx with g added when `residual`). The kernel writes dx,
    per-token scratch and per-tile partial sums; `ops.reduce` sums those in
    a fixed order."""
    ch = w1.shape[0]
    _check_kernel_shape(x, wdw, ch)
    b, h, w, c = x.shape
    if h % 8 or w % 8:
        _unsupported("the backward kernel needs H and W in multiples of its "
                     "8 x 8 tile", x, ch)
    lib = _build.library()
    bf16 = int(x.dtype == torch.bfloat16)
    if lib.fbanet_leff_bwd_chunk(c, ch, bf16) == 0:
        _unsupported("the backward kernel takes no hidden chunk of this "
                     "shape (bfloat16 needs C and the hidden width in "
                     "multiples of 16, and a chunk must fit shared memory)",
                     x, ch)
    g = g.to(x.dtype).contiguous()
    ln_s, ln_b, w1_, b1_, wdw_, bdw_, w2_, _ = _kernel_args(
        x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, None)
    tiles = b * (h // 8) * (w // 8)
    dx, ys = torch.empty_like(x), torch.empty_like(x)
    h2s, dz1s = (torch.empty(b, h, w, ch, device=x.device, dtype=x.dtype)
                 for _ in range(2))
    part = torch.empty(tiles, 3 * c + 11 * ch, device=x.device,
                       dtype=torch.float32)
    err = lib.fbanet_leff_bwd(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), ys.data_ptr(),
        h2s.data_ptr(), dz1s.data_ptr(), part.data_ptr(), ln_s.data_ptr(),
        ln_b.data_ptr(), w1_.data_ptr(), b1_.data_ptr(), wdw_.data_ptr(),
        bdw_.data_ptr(), w2_.data_ptr(), b, h, w, c, ch, int(residual), bf16,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "leff_bwd")
    leff_bwd.launches += 1
    t = b * h * w
    sums = column_sum(part)
    dw1 = token_matmul(dz1s.view(t, ch), ys.view(t, c))
    dw2 = token_matmul(g.view(t, c), h2s.view(t, ch))
    dlns, dlnb, db1, dwdw, dbdw, db2 = torch.split(
        sums, [c, c, ch, 9 * ch, ch, c])
    return (dx, dlns, dlnb, dw1, db1, dwdw.reshape(9, ch).t().reshape(
        ch, 1, 3, 3), dbdw, dw2, db2)


leff_bwd.launches = 0


class _FusedLeFF(torch.autograd.Function):
    """K2 forward, K4 backward (or both plain versions)."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2, residual,
                plain):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2)
        ctx.cfg = (residual, plain)
        if plain or x.device.type == "cpu":
            out = _leff_math(x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2,
                             x.dtype)
            if residual:
                out = out + x.float()
            return out.to(x.dtype)
        return _kernel_forward(x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2,
                               residual)

    @staticmethod
    def backward(ctx, g):
        x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2 = ctx.saved_tensors
        residual, plain = ctx.cfg
        if plain or x.device.type == "cpu":
            dx, *dparams = leff_bwd_reference(x, g.to(x.dtype), ln_scale,
                                              ln_bias, w1, b1, wdw, bdw, w2)
            if residual:
                dx = dx + g.to(dx.dtype)
        else:
            dx, *dparams = leff_bwd(x, g, ln_scale, ln_bias, w1, b1, wdw,
                                    bdw, w2, residual=residual)
        params = (ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2)
        return (dx, *(d.to(p.dtype) for d, p in zip(dparams, params)),
                None, None)


def fused_leff(x: torch.Tensor, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2,
               *, residual: bool = False, plain: bool = False
               ) -> torch.Tensor:
    """Fused norm2 + LeFF on `[B, H, W, C]`, computed in x's dtype and
    differentiable (backward: K4 on the card, the plain backward on the
    CPU); with `residual=True` returns `x + branch`. `plain=True` forces the
    plain versions on any device."""
    return _FusedLeFF.apply(x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2,
                            residual, plain)


fused_leff.launches = 0
