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

K2 has two forms, entered from `csrc/leff.cu`: the wgmma form
(`csrc/leff_wgmma.cuh`; bf16: TMA-staged W1 and W2^T chunks, wgmma
products with dense2's sums in registers, the depthwise stage on 16 warps,
16 x 8 or 8 x 8 tiles) and the first kernel (`csrc/leff.cuh`; 8 x 8
tiles, WMMA; f32 and bf16 shapes the wgmma form does not take).
`_leff_plan` picks the form and tile from the shapes alone; K8's and K10's
flags follow it onto either form.

K4 has two forms in `csrc/leff_bwd.cu`: the wgmma form (bf16: TMA-staged
weight chunks, wgmma products, 16 warps on the depthwise stages, 16 x 8 or
8 x 8 tiles, the hidden chunks split over blocks where the map has few
tiles) and the WMMA form (8 x 8 tiles; f32, and bf16 shapes the wgmma form
does not take). `_leff_bwd_plan` picks the form, tile, chunk and split
from the shapes alone.

`fused_leff.launches` counts K2 launches (`_leff_launch.wgmma` and
`_leff_launch.base` those of each form, explicit plans included),
`leff_bwd.launches` K4 launches.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from fbanet_tpu_torch.ops import _build
from fbanet_tpu_torch.ops.attention import _SMEM_LIMIT, _rounded
from fbanet_tpu_torch.ops.norm import LN_EPS, layer_norm_f32
from fbanet_tpu_torch.ops.reduce import (
    _SMS,
    _cdiv,
    column_sum,
    token_matmul,
)


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


# K2's wgmma form as csrc/leff.cu instantiates it: (tile rows, tile
# columns, hidden chunk), in the plan's order of preference. Measured at
# the five groups at B=8 (tools/measure_leff.py plans, NVIDIA H100 80GB
# HBM3 at 700 W): 64-wide chunks took 15-19 % less device time than
# 32-wide, 16 x 8 tiles 22-30 % less than 8 x 8 where both fit.
_K2_FORMS = ((16, 8, 64), (16, 8, 32), (8, 8, 64), (8, 8, 32))
_K2_BASE_PLAN = (0, 0, 0)  # the first kernel: 8 x 8 tiles, WMMA (bf16) or f32


def _leff_smem(c: int, th: int, tw: int, kc: int) -> int:
    """Dynamic shared memory of K2's wgmma form for C channels, th x tw
    tiles and hidden chunk kc, or 0 for one it does not take: a model of
    the kernel's `fbanet_leff_wgmma_smem` (the layout of `FwLayout` in
    csrc/leff.cu, byte for byte) that plans without the card, as the CPU
    tests do; on the card `fused_leff` plans with the kernel's own, and
    chip_smoke.py holds the two equal."""
    ni = th * tw
    if (c % 64 or c > 256 or (th, tw, kc) not in _K2_FORMS
            or (c // 64) * (ni // 64) > 4):
        return 0

    def a128(n):
        return _cdiv(n, 128) * 128

    atoms, ny = c // 64, (th + 2) * (tw + 2)
    wslot = atoms * kc * 128
    h1 = atoms * _cdiv(ny, 64) * 64 * 128 + 4 * wslot + ni // 64 * kc * 128
    bars = h1 + a128(2 * ny * (kc + 8)) + a128(36 * kc) + 2 * a128(4 * kc)
    if ni * (c + 4) * 4 > bars:  # out after the chunk loop
        return 0
    return bars + 16 + 1024


def _kernel_leff_smem(c: int, th: int, tw: int, kc: int) -> int:
    """The kernel's own `fbanet_leff_wgmma_smem` (builds the library on
    first use)."""
    return _build.library().fbanet_leff_wgmma_smem(c, th, tw, kc)


@functools.lru_cache(maxsize=256)
def _leff_plan(b: int, h: int, w: int, c: int, ch: int, bf16: bool = True,
               smem=_leff_smem) -> tuple[int, int, int]:
    """(tile rows, tile columns, hidden chunk) of K2 for x [b, h, w, c] and
    hidden width ch: in bf16 the first form of `_K2_FORMS` whose tile
    divides the map, whose chunk divides ch and that fits shared memory
    (`smem`: `_kernel_leff_smem`, the kernel's, or `_leff_smem`, its
    model); else `_K2_BASE_PLAN`, the first kernel (f32, or a bf16 shape
    the wgmma form does not take)."""
    if bf16:
        for th, tw, kc in _K2_FORMS:
            if (h % th == 0 and w % tw == 0 and ch % kc == 0
                    and 0 < smem(c, th, tw, kc) <= _SMEM_LIMIT):
                return th, tw, kc
    return _K2_BASE_PLAN


def _kernel_forward(x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2, residual):
    """Launch K2 under its plan (counted in `fused_leff.launches`)."""
    ch = w1.shape[0]
    _check_kernel_shape(x, wdw, ch)
    b, h, w, c = x.shape
    plan = _leff_plan(b, h, w, c, ch, x.dtype == torch.bfloat16,
                      smem=_kernel_leff_smem)
    out = _leff_launch(x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2,
                       residual, plan)
    fused_leff.launches += 1
    return out


def _leff_launch(x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2, residual,
                 plan):
    """Launch K2 with `plan` (see `_leff_plan`): the wgmma form, counted in
    `_leff_launch.wgmma`, or the first kernel, in `_leff_launch.base`."""
    ch = w1.shape[0]
    _check_kernel_shape(x, wdw, ch)
    b, h, w, c = x.shape
    th, tw, kc = plan
    lib = _build.library()
    bf16 = int(x.dtype == torch.bfloat16)
    args = _kernel_args(x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2)
    out = torch.empty_like(x)
    if th:
        if not bf16:
            _unsupported("the wgmma form takes bfloat16", x, ch)
        # W2 as W2^T [Ch, C], the MN-major A operand of out^T
        args[6] = w2.t().to(device=x.device, dtype=x.dtype,
                            memory_format=torch.contiguous_format)
        err = lib.fbanet_leff_wgmma(
            x.data_ptr(), out.data_ptr(), *[a.data_ptr() for a in args],
            b, h, w, c, ch, int(residual), th, tw, kc, _build.stream(x))
        _build.check(err, "fused_leff")
        _leff_launch.wgmma.launches += 1
        return out
    smem = lib.fbanet_leff_smem(c, ch, bf16)
    if smem == 0:
        _unsupported("in bfloat16 C and the hidden width must be multiples "
                     "of 16 (tensor-core tiles)", x, ch)
    if smem > _SMEM_LIMIT:
        _unsupported(f"needs {smem} B of shared memory per block "
                     f"(limit {_SMEM_LIMIT})", x, ch)
    err = lib.fbanet_leff(
        x.data_ptr(), out.data_ptr(), *[a.data_ptr() for a in args],
        b, h, w, c, ch, int(residual), bf16, _build.stream(x))
    _build.check(err, "fused_leff")
    _leff_launch.base.launches += 1
    return out


# launch counts per form, kept as the wrappers keep theirs
_leff_launch.wgmma = SimpleNamespace(launches=0)
_leff_launch.base = SimpleNamespace(launches=0)


# K4's wgmma form as csrc/leff_bwd.cu instantiates it: (tile rows, tile
# columns, hidden chunk), in the plan's order of preference. Measured at the
# five groups at B=8 (tools/measure_leff_bwd.py plans, H100): 16 x 8 tiles
# with 32-wide chunks led wherever they fit (C 64, 128) by 6-23 % over 8 x 8
# with 64-wide chunks, which no group then took; in an earlier build,
# 16 x 16 tiles (which fit only with 16-wide chunks) and 16-wide chunks
# trailed by 15-40 %. At C = 32 (FBANet-32's enc0, tiles of 64-byte rows)
# 16 x 16 tiles fit with 32-wide chunks (halo recompute 1.56x, not 1.88x):
# 0.6019 device ms a call at B=8 against 0.6968 for 16 x 8 and 1.5200 for
# the WMMA form (H100, 700 W). (8, 8, 32) is built for C >= 64 only,
# (16, 16, 32) for C = 32 only (`_k4_form`).
_K4_FORMS = ((16, 16, 32), (16, 8, 32), (8, 8, 32))
_WMMA_PLAN = (0, 0, 0, 1)  # the WMMA form: 8 x 8 tiles, its own chunk


def _k4_form(c: int, th: int, tw: int, kc: int) -> bool:
    """Whether csrc/leff_bwd.cu builds the wgmma form (th, tw, kc) for C
    channels (its `wgmma_form`)."""
    if (th, tw, kc) not in _K4_FORMS:
        return False
    if (th, tw) == (16, 16):
        return c == 32
    return th == 16 or c >= 64


def _leff_bwd_smem(c: int, th: int, tw: int, kc: int) -> int:
    """Dynamic shared memory of the wgmma form for C channels, th x tw
    tiles and hidden chunk kc, or 0 for one it does not take: a model of
    the kernel's `fbanet_leff_bwd_smem` (the layout of `WgLayout` in
    csrc/leff_bwd.cu, byte for byte) that plans without the card, as the
    CPU tests do; on the card `leff_bwd` plans with the kernel's own, and
    chip_smoke.py holds the two equal."""
    if ((c % 64 and c != 32) or c > 256 or 256 % c
            or not _k4_form(c, th, tw, kc)
            or max(c // 64, 1) * (th * tw // 64) > 4):
        return 0

    def a128(n):
        return _cdiv(n, 128) * 128

    row, kcp = 2 * c, kc + 4  # bytes of a row of C bf16 channels
    nx, ng, ni = (th + 4) * (tw + 4), (th + 2) * (tw + 2), th * tw
    nxr, ngr = _cdiv(nx, 8) * 8, _cdiv(ng, 8) * 8
    w1 = _cdiv((nxr + ngr) * row, 1024) * 1024
    h1 = w1 + 3 * kc * row + ni * kc * 2
    taps = h1 + a128(4 * nx * kcp) + a128(4 * ni * kcp) + a128(4 * ngr * kcp)
    mu = taps + a128(36 * kc) + 2 * a128(4 * kc)
    # dy after the chunk loop must end before h1; the partial sums' scratch
    # (16 warps x 16 channel pairs x 22 floats) fits from h1 to the taps
    if ni * (c + 4) * 4 > h1 or 16 * 16 * 22 * 4 > taps - h1:
        return 0
    return mu + 2 * a128(4 * ni) + 24 + 1024


def _kernel_smem(c: int, th: int, tw: int, kc: int) -> int:
    """The kernel's own `fbanet_leff_bwd_smem` (builds the library on
    first use)."""
    return _build.library().fbanet_leff_bwd_smem(c, th, tw, kc)


@functools.lru_cache(maxsize=256)
def _leff_bwd_plan(b: int, h: int, w: int, c: int, ch: int, bf16: bool = True,
                   sms: int = _SMS, smem=_leff_bwd_smem
                   ) -> tuple[int, int, int, int]:
    """(tile rows, tile columns, hidden chunk, splits) of K4 for x [b, h, w,
    c] and hidden width ch; `_WMMA_PLAN` for the WMMA form (f32, or bf16 at
    a shape the wgmma form does not take); None if neither takes it.

    bf16: the first form of `_K4_FORMS` whose tile divides the map, whose
    chunk divides ch and that fits shared memory (`smem`: `_kernel_smem`,
    the kernel's, or `_leff_bwd_smem`, its model), at C 32 (FBANet-32's
    enc0), 64, 128 or 256. With fewer
    tiles than half the card's `sms` (one block per SM), `_k4_splits`
    blocks share each tile's hidden chunks."""
    if bf16:
        for th, tw, kc in _K4_FORMS:
            if (h % th == 0 and w % tw == 0 and ch % kc == 0
                    and 0 < smem(c, th, tw, kc) <= _SMEM_LIMIT):
                tiles = b * (h // th) * (w // tw)
                return th, tw, kc, _k4_splits(tiles, ch // kc, sms)
    if h % 8 == 0 and w % 8 == 0:
        return _WMMA_PLAN
    return None


def _k4_splits(tiles: int, chunks: int, sms: int = _SMS) -> int:
    """Blocks per tile of the wgmma form: 1 from sms / 2 tiles up, else
    `_k4_splits_to_fill`. Measured (tools/measure_leff_bwd.py plans,
    H100): with 50 tiles (the bottleneck at B=2) 8 splits ran 20 % faster
    than none; with 100 or 200 tiles a split ran 3-30 % slower (each split
    repeats the LayerNorm and the halo loads and writes an f32 dy partial
    for a second pass)."""
    return 1 if 2 * tiles >= sms else _k4_splits_to_fill(tiles, chunks, sms)


def _k4_splits_to_fill(tiles: int, chunks: int, sms: int = _SMS) -> int:
    """The least power of two (dividing the tile's chunks) of blocks per
    tile that reaches 2 `sms` blocks."""
    splits = 1
    while tiles * splits < 2 * sms and chunks % (2 * splits) == 0:
        splits *= 2
    return splits


def leff_bwd(x, g, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, *,
             residual: bool = False):
    """K4 on CUDA tensors: the backward of `fused_leff` for the incoming
    gradient g [B, H, W, C] (x's dtype). Returns what `leff_bwd_reference`
    returns (dx with g added when `residual`). The kernel writes dx,
    per-token scratch and per-tile partial sums; `ops.reduce` sums those in
    a fixed order. `_leff_bwd_plan` picks the kernel's tile, hidden chunk
    and split."""
    ch = w1.shape[0]
    _check_kernel_shape(x, wdw, ch)
    b, h, w, c = x.shape
    plan = _leff_bwd_plan(b, h, w, c, ch, x.dtype == torch.bfloat16,
                          smem=_kernel_smem)
    if plan is None:
        _unsupported("the backward kernel needs H and W in multiples of its "
                     "8 x 8 tile", x, ch)
    return _leff_bwd_launch(x, g, ln_scale, ln_bias, w1, b1, wdw, bdw, w2,
                            residual, plan)


def _leff_bwd_launch(x, g, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, residual,
                     plan):
    """Launch K4 with `plan` (see `_leff_bwd_plan`), then the sums: the
    wgmma form counts in `_leff_bwd_launch.wgmma`, the WMMA form in
    `_leff_bwd_launch.base`."""
    ch = w1.shape[0]
    _check_kernel_shape(x, wdw, ch)
    b, h, w, c = x.shape
    th, tw, kc, splits = plan
    lib = _build.library()
    bf16 = int(x.dtype == torch.bfloat16)
    if th == 0 and lib.fbanet_leff_bwd_chunk(c, ch, bf16) == 0:
        _unsupported("the backward kernel takes no hidden chunk of this "
                     "shape (bfloat16 needs C and the hidden width in "
                     "multiples of 16, and a chunk must fit shared memory)",
                     x, ch)
    g = g.to(x.dtype).contiguous()
    ln_s, ln_b, w1_, b1_, wdw_, bdw_, w2_, _ = _kernel_args(
        x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, None)
    # the wgmma form reads W2 as W2^T [Ch, C] (K-major, like W1)
    w2t = w2.t().to(device=x.device, dtype=x.dtype,
                    memory_format=torch.contiguous_format) if th else w2_
    tiles = b * (h // (th or 8)) * (w // (tw or 8))
    dx, ys = torch.empty_like(x), torch.empty_like(x)
    h2s, dz1s = (torch.empty(b, h, w, ch, device=x.device, dtype=x.dtype)
                 for _ in range(2))
    part = torch.empty(tiles, 3 * c + 11 * ch, device=x.device,
                       dtype=torch.float32)
    dyp = torch.empty(splits, b, h, w, c, device=x.device,
                      dtype=torch.float32) if splits > 1 else part
    err = lib.fbanet_leff_bwd(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), ys.data_ptr(),
        h2s.data_ptr(), dz1s.data_ptr(), part.data_ptr(), dyp.data_ptr(),
        ln_s.data_ptr(), ln_b.data_ptr(), w1_.data_ptr(), b1_.data_ptr(),
        wdw_.data_ptr(), bdw_.data_ptr(), w2_.data_ptr(), w2t.data_ptr(), b,
        h, w, c, ch, int(residual), bf16, th, tw, kc, splits, _build.stream(x))
    _build.check(err, "leff_bwd")
    leff_bwd.launches += 1
    (_leff_bwd_launch.wgmma if th else _leff_bwd_launch.base).launches += 1
    t = b * h * w
    sums = column_sum(part)
    dw1 = token_matmul(dz1s.view(t, ch), ys.view(t, c))
    dw2 = token_matmul(g.view(t, c), h2s.view(t, ch))
    dlns, dlnb, db1, dwdw, dbdw, db2 = torch.split(
        sums, [c, c, ch, 9 * ch, ch, c])
    return (dx, dlns, dlnb, dw1, db1, dwdw.reshape(9, ch).t().reshape(
        ch, 1, 3, 3), dbdw, dw2, db2)


leff_bwd.launches = 0
_leff_bwd_launch.wgmma = SimpleNamespace(launches=0)
_leff_bwd_launch.base = SimpleNamespace(launches=0)


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
