"""K1, K1b and K3 — fused window attention (norm1 + W-MSA) on the 4-D
feature map and on pre-partitioned windows, and its backward.

`fused_window_attention_2d` is the dispatcher (the counterpart of
fbanet_tpu/ops/attention_pallas.py::fused_window_attention_2d). It is a
`torch.autograd.Function`: its forward is K1 and its backward K3. For CUDA
tensors the forward launches a hand-written kernel that replaces the TPU
kernel `_attention2d_kernel` and the backward one that replaces
`_attention_bwd_kernel`, followed by the fixed-order sums of
`ops/reduce.py`; either raises for a shape its kernel does not take. Each
has two forms: the bf16 wgmma form (`csrc/attention_wgmma.cu`,
`csrc/attention_bwd_wgmma.cu`) for the shapes of the main path, and the
first kernel (`csrc/attention.cu`, `csrc/attention_bwd.cu(h)`) for f32,
other shapes and the ablation and variant kernels built on it; the plans
`_attention_plan` and `_attention_bwd_plan` pick the form. For CPU
tensors, or with `plain=True`, both run the plain PyTorch versions below.
There is no silent fallback. As in the
JAX custom_vjp (`_fused2d_fwd`), the forward saves only the layer input and
the parameters; the backward recomputes the rest.

`fused_window_attention` (the counterpart of attention_pallas.py::
fused_window_attention) is the same pair on `[G, N, C]` windows: K1b, the
windowed entry of K1's two forms (which replaces `_attention_kernel`), and
K3's windowed entry as its backward. Its plain versions are
`window_attention_reference` and `window_attention_bwd_reference`.

The plain forward follows the TPU kernel's rounding points
(`_attn_block_math`, attention_pallas.py:153-231): LN in f32 rounded to the
compute dtype; q scaled in f32 after its bias, then rounded; f32 logits +
relative-position bias + shift mask; max-subtracted exp, probabilities
rounded for the AV product and the division by the f32 row sum applied after
it; f32-accumulated projections. Products of rounded operands are taken in
f32, which is what "bf16 inputs, f32 accumulation" means. The plain backward,
`window_attention_bwd_reference`, follows `_attention_bwd_kernel`
(attention_pallas.py:334-473) step by step at its own rounding points.

Gradients come back in torch Linear layouts ([out, in]); the bias gradient
is that of the gathered `[heads, N, N]` bias, which autograd carries to the
relative-position table through the index gather. The mask gets none.

Both entries follow JAX's shape rule first (`_supported`,
attention_pallas.py:62-64, 749, 785-788): windows whose token count or head
size is not a multiple of 8 (window 10's 100 tokens, say), or a map the
window does not divide, take the composed branch on every device,
`window_attention_composed`: JAX's composed `window_attention_reference`
in PyTorch ops, differentiated by autograd, counted in
`fused_window_attention_2d.composed` / `fused_window_attention.composed`.
It rounds where that function rounds (each Dense's product rounded to the
compute dtype before its bias is added, q scaled after), not where the
kernel does; its pieces `dense` and `heads_attention` are the composed
SwinLayer's too (models/layers.py).

`fused_window_attention_2d.launches` counts K1 launches,
`fused_window_attention.launches` K1b launches and
`window_attention_bwd.launches` K3 launches (both entries);
`fused_window_attention_2d.wgmma` / `.narrow` / `.base` count the launches
of K1's wgmma form at head sizes 16 and 64, of its instantiations at head
sizes 8 and 32 (embed 32's) and of its first kernel (K1b's and explicit
plans' included), `_attention_bwd_launch.wgmma` / `.narrow` / `.base`
K3's.
"""

from __future__ import annotations

import functools
import math
from types import SimpleNamespace

import torch

from fbanet_tpu_torch.ops import _build
from fbanet_tpu_torch.ops.norm import LN_EPS, layer_norm_f32
from fbanet_tpu_torch.ops.reduce import _SMS, _cdiv, column_sum, token_matmul

_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on the H100
_SM_SMEM = 233472  # bytes of shared memory on one H100 SM (228 KB)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nH * nW, ws*ws, C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * (h // ws) * (w // ws), ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int,
                   w: int) -> torch.Tensor:
    """Inverse of `window_partition`."""
    nh, nw = h // ws, w // ws
    b = windows.shape[0] // (nh * nw)
    x = windows.reshape(b, nh, nw, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, x.shape[-1])


def _rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`t` as stored in `dtype`, back in f32 (a no-op for f32)."""
    return t.to(dtype).float()


def _attention_math(x, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bproj,
                    bias, mask, heads: int, cdtype: torch.dtype
                    ) -> torch.Tensor:
    """[G, N, C] windows -> f32 [G, N, C] attention branch (pre-residual).
    Weights are torch Linear layouts ([out, in])."""
    g, n, c = x.shape
    dh = c // heads
    y = _rounded(layer_norm_f32(x, ln_scale, ln_bias), cdtype)
    q = _rounded((y @ _rounded(wq, cdtype).t() + bq.float()) * dh ** -0.5,
                 cdtype)
    kv = _rounded(y @ _rounded(wkv, cdtype).t() + bkv.float(), cdtype)
    k, v = kv[..., :c], kv[..., c:]
    q = q.reshape(g, n, heads, dh).transpose(1, 2)
    k = k.reshape(g, n, heads, dh).transpose(1, 2)
    v = v.reshape(g, n, heads, dh).transpose(1, 2)
    logits = q @ k.transpose(-1, -2) + bias.float()[None]
    if mask is not None:
        nw = mask.shape[0]
        logits = (logits.reshape(g // nw, nw, heads, n, n)
                  + mask.float()[None, :, None]).reshape(g, heads, n, n)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    sinv = 1.0 / e.sum(-1, keepdim=True)
    o = _rounded((_rounded(e, cdtype) @ v) * sinv, cdtype)
    o = o.transpose(1, 2).reshape(g, n, c)
    return o @ _rounded(wproj, cdtype).t() + bproj.float()


def window_attention_reference(x, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj,
                               bproj, bias, mask, *, heads: int
                               ) -> torch.Tensor:
    """Plain version on pre-partitioned windows: [G, N, C] -> [G, N, C]
    (attention_pallas.py:90-132), computed in x's dtype. `bias` is the
    gathered relative-position bias [heads, N, N]; `mask` the shift mask
    [nW, N, N] or None."""
    return _attention_math(x, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj,
                           bproj, bias, mask, heads, x.dtype).to(x.dtype)


def _supported(n: int, c: int, heads: int) -> bool:
    """JAX's shape rule for its Pallas attention (attention_pallas.py:62):
    windows of n tokens and heads of C / heads channels it takes; every
    other shape runs the composed branch."""
    return n % 8 == 0 and c % heads == 0 and (c // heads) % 8 == 0


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
          dtype: torch.dtype) -> torch.Tensor:
    """flax nn.Dense in `dtype` with a torch Linear weight [out, in]: the
    product rounded to `dtype`, then the bias added (a second rounding)."""
    y = x.to(dtype) @ weight.to(dtype).t()
    return y if bias is None else y + bias.to(dtype)


def heads_attention(q, k, v, bias, mask, heads: int, dtype: torch.dtype,
                    drop=None) -> torch.Tensor:
    """softmax(q k^T + bias [+ mask]) v per head on [G, N, C] windows, as
    JAX's composed attention rounds it (layers.py:386-414,
    attention_pallas.py:117-130): f32 logits of the dtype's q and k (q comes
    scaled), the f32 bias [heads, N, N] and the mask [nW, N, N] added, an
    f32 softmax cast to `dtype`, `drop` (the attention dropout) applied to
    it, the product with v in `dtype`."""
    g, n, c = q.shape
    dh = c // heads

    def split(t):  # [G, N, C] -> [G, heads, N, dh]
        return t.reshape(g, n, heads, dh).transpose(1, 2)

    logits = split(q).float() @ split(k).float().transpose(-1, -2) \
        + bias.float()[None]
    if mask is not None:
        nw = mask.shape[0]
        logits = (logits.reshape(g // nw, nw, heads, n, n)
                  + mask.float()[None, :, None]).reshape(g, heads, n, n)
    p = torch.softmax(logits, -1).to(dtype)
    if drop is not None:
        p = drop(p)
    o = p @ split(v).to(dtype)
    return o.transpose(1, 2).reshape(g, n, c)


def window_attention_composed(x, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj,
                              bproj, bias, mask, *, heads: int
                              ) -> torch.Tensor:
    """The composed branch of both entries: JAX's composed
    `window_attention_reference` (attention_pallas.py:90-132) on [G, N, C]
    windows in x's dtype, in PyTorch ops (autograd differentiates it):
    norm1 in f32 cast to the dtype, the Dense products, q scaled, then
    `heads_attention` and the output projection."""
    cd, c = x.dtype, x.shape[-1]
    y = layer_norm_f32(x, ln_scale, ln_bias).to(cd)
    q = dense(y, wq, bq, cd) * (c // heads) ** -0.5
    k, v = dense(y, wkv, bkv, cd).split(c, -1)
    return dense(heads_attention(q, k, v, bias, mask, heads, cd), wproj,
                 bproj, cd)


def _plain_2d(x4, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bproj, bias,
              mask, heads, ws, residual):
    b, h, w, _c = x4.shape
    out = _attention_math(window_partition(x4, ws), ln_scale, ln_bias, wq, bq,
                          wkv, bkv, wproj, bproj, bias, mask, heads, x4.dtype)
    out = window_reverse(out, ws, h, w)
    if residual:
        out = out + x4.float()
    return out.to(x4.dtype)


def window_attention_bwd_reference(x, g, ln_scale, ln_bias, wq, bq, wkv, bkv,
                                   wproj, bias, mask, *, heads: int):
    """Plain backward on pre-partitioned windows, computed in x's dtype:
    x and the incoming gradient g are [G, N, C]. Follows
    `_attention_bwd_kernel` (attention_pallas.py:334-473) step by step:
    recompute the forward, dp = do v^T, dv = p^T do, dlogits = p (dp -
    sum(dp p)), dq = dlogits k scaled, dk = dlogits^T q, dy = dq Wq + dkv Wkv,
    LN backward. Returns (dx [G, N, C] in x's dtype, then f32 gradients of
    ln scale, ln bias, wq [C, C], bq, wkv [2C, C], bkv, wproj [C, C], bproj,
    bias [heads, N, N]), weights in torch Linear layouts."""
    return attention_bwd_math(x, g, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj,
                              bias, mask, heads=heads)


def attention_bwd_math(x, g, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bias,
                       mask, *, heads: int, recompute: bool = True,
                       dsoftmax: bool = True, wgrads: bool = True,
                       dxchain: bool = True, core: bool = True):
    """`window_attention_bwd_reference` with stages removable, as the
    ablation copy scripts/measure_bwd.py::_abl_bwd_kernel removes them
    (wrong values by design; every switch True is the backward itself):
    recompute=False uses inv = 1, xhat = x, y = q = k = v = x; dsoftmax=False
    takes dlogits = dp / n; core=False skips the per-head stage (o = dq =
    dk = dv = do, bias gradient 0); dxchain=False gives dx = x and dy = x
    for the LN gradients; wgrads=False returns zero parameter gradients."""
    cd = x.dtype
    gsz, n, c = x.shape
    dh = c // heads
    scale = dh ** -0.5
    xf = x.float()
    lns = ln_scale.float()
    wq_c, wkv_c, wproj_c = (_rounded(w, cd) for w in (wq, wkv, wproj))
    if recompute:
        mu = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
        inv = torch.rsqrt(var + LN_EPS)
        xhat = (xf - mu) * inv
        y = _rounded(xhat * lns + ln_bias.float(), cd)
        q = _rounded((y @ wq_c.t() + bq.float()) * scale, cd)
        kv = _rounded(y @ wkv_c.t() + bkv.float(), cd)
    else:
        inv, xhat = 1.0, xf
        y = q = _rounded(xf, cd)
        kv = torch.cat([y, y], -1)
    g2 = _rounded(g, cd)
    do = g2 @ wproj_c

    def split(a):  # [G, N, C] -> [G, heads, N, dh]
        return a.reshape(gsz, n, heads, dh).transpose(1, 2)

    def merge(a):  # inverse of split
        return a.transpose(1, 2).reshape(gsz, n, c)

    if core:
        qh, kh, vh = split(q), split(kv[..., :c]), split(kv[..., c:])
        doh = split(_rounded(do, cd))
        logits = qh @ kh.transpose(-1, -2) + bias.float()[None]
        if mask is not None:
            nw = mask.shape[0]
            logits = (logits.reshape(gsz // nw, nw, heads, n, n)
                      + mask.float()[None, :, None]).reshape(gsz, heads, n, n)
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
        p = e * (1.0 / e.sum(-1, keepdim=True))
        pc = _rounded(p, cd)
        o = pc @ vh
        dp = doh @ vh.transpose(-1, -2)
        dv = pc.transpose(-1, -2) @ doh
        if dsoftmax:
            dlogits = p * (dp - (dp * p).sum(-1, keepdim=True))
        else:
            dlogits = dp * (1.0 / n)
        dlc = _rounded(dlogits, cd)
        dq = dlc @ kh
        dk = dlc.transpose(-1, -2) @ qh
        o2 = _rounded(merge(o), cd)
        dq2 = merge(dq) * scale
        dkv2 = torch.cat([merge(dk), merge(dv)], -1)
        dbias = dlogits.sum(0)
    else:
        o2 = _rounded(do, cd)
        dq2 = do
        dkv2 = torch.cat([do, do], -1)
        dbias = torch.zeros(heads, n, n, device=x.device)
    dq2c, dkv2c = _rounded(dq2, cd), _rounded(dkv2, cd)
    if dxchain:
        dy = dq2c @ wq_c + dkv2c @ wkv_c
        dxh = dy * lns
        m1 = dxh.mean(-1, keepdim=True)
        m2 = (dxh * xhat).mean(-1, keepdim=True)
        dx = (inv * (dxh - m1 - xhat * m2)).to(cd)
    else:
        dy, dx = xf, x

    def flat(a):
        return a.reshape(-1, a.shape[-1])

    grads = (flat(dy * xhat).sum(0), flat(dy).sum(0),
             flat(dq2c).t() @ flat(y), flat(dq2).sum(0),
             flat(dkv2c).t() @ flat(y), flat(dkv2).sum(0),
             flat(g2).t() @ flat(o2), flat(g2).sum(0), dbias)
    if not wgrads:
        grads = tuple(torch.zeros_like(t) for t in grads)
    return (dx, *grads)


def _plain_bwd_2d(x4, g4, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bias,
                  mask, heads, ws, residual):
    """The 4-D backward through the windowed one (`_fused2d_bwd`,
    attention_pallas.py:693-718): partition, backward, reverse dx, and with
    the residual add the incoming gradient in x's dtype."""
    _b, h, w, _c = x4.shape
    dxw, *rest = window_attention_bwd_reference(
        window_partition(x4, ws), window_partition(g4, ws), ln_scale, ln_bias,
        wq, bq, wkv, bkv, wproj, bias, mask, heads=heads)
    dx = window_reverse(dxw, ws, h, w)
    if residual:
        dx = dx + g4.to(dx.dtype)
    return (dx, *rest)


def _unsupported(why: str, x4: torch.Tensor, heads: int, ws: int):
    raise ValueError(
        f"fused_window_attention_2d kernel does not take x {tuple(x4.shape)} "
        f"{x4.dtype}, heads={heads}, window={ws}: {why}")


def _check_kernel_shape(x4, heads, ws, mask):
    """Raise for what neither K1 nor K3 takes (device, dtype, layout)."""
    if x4.device.type != "cuda":
        _unsupported(f"no kernel for device {x4.device}", x4, heads, ws)
    _b, h, w, c = x4.shape
    if x4.dtype not in (torch.float32, torch.bfloat16):
        _unsupported("dtype must be float32 or bfloat16", x4, heads, ws)
    if not x4.is_contiguous():
        _unsupported("x must be contiguous", x4, heads, ws)
    if h % ws or w % ws or c % heads:
        _unsupported("H and W must divide by the window and C by heads",
                      x4, heads, ws)
    n = ws * ws
    if mask is not None and tuple(mask.shape) != ((h // ws) * (w // ws), n, n):
        _unsupported(f"mask shape {tuple(mask.shape)}", x4, heads, ws)


def _kernel_args(x4, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bproj, bias,
                 mask):
    """Parameters as the kernels take them: f32 vectors and bias/mask,
    compute-dtype weights, all contiguous on x4's device (None stays
    None)."""
    def f32(t):
        return None if t is None else t.to(
            device=x4.device, dtype=torch.float32).contiguous()

    def wt(t):
        return None if t is None else t.to(
            device=x4.device, dtype=x4.dtype).contiguous()

    return [f32(ln_scale), f32(ln_bias), wt(wq), f32(bq), wt(wkv), f32(bkv),
            wt(wproj), f32(bproj), f32(bias), f32(mask)]


def _kernel_forward(x4, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bproj,
                    bias, mask, heads, ws, residual):
    """Launch K1 under `_attention_plan`."""
    _check_kernel_shape(x4, heads, ws, mask)
    b, h, w, c = x4.shape
    plan = _attention_plan(b, h, w, c, heads, ws, x4.dtype == torch.bfloat16,
                           smem=_kernel_attention_smem)
    out = _attention_launch(x4, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj,
                            bproj, bias, mask, heads, ws, residual, plan)
    fused_window_attention_2d.launches += 1
    return out


# K1's plans: (warpgroups per block, windows per block, weights staged).
# The wgmma form (csrc/attention_wgmma.cu) takes bf16 8 x 8 windows, C 64,
# 128 or 256 and head size 8, 16, 32 or 64, with two or four warpgroups and
# the weights staged once per block (where all 4 C^2 fit) or streamed per
# window, and C = 32 with one head (FBANet-32's enc0) on one warpgroup with
# the weights staged; warpgroups 0 is the first kernel (csrc/attention.cu:
# f32, every other shape), one window per block. K7's cores and K9's stages
# follow the plan onto either form where they are built (not at C = 32).
_K1_BASE_PLAN = (0, 1, 0)
# head sizes of the wgmma forms of K1 and K3; every other head size runs on
# their first kernels
_WGMMA_HEAD_SIZES = (8, 16, 32, 64)
# the head sizes of embed 32 (each head of 8 zero-padded to 16 columns in
# the forms' tiles), counted apart from 16 and 64 in the forms' counts
_NARROW_HEAD_SIZES = (8, 32)
# (warpgroups, staged) of the wgmma form, in the order the plan tries them
# (one warpgroup, staged, is C = 32's form and C = 32 takes no other)
_K1_FORMS = ((1, 1), (2, 1), (4, 1), (4, 0))
_K1_SLOTS = 4  # TMA ring slots per warpgroup when the weights stream


def _head_tiles_bytes(c: int, heads: int) -> int:
    """Bytes of one 64-token tensor held as the wgmma forms' per-head
    tiles: 64 x C bf16, or 64 x 2 C at head size 8, whose heads are
    zero-padded to 16 columns (csrc/common.cuh's `head_pitch`)."""
    return 128 * heads * (-(-(c // heads) // 16) * 16)


def _attention_smem(n: int, c: int, heads: int, nwg: int,
                    staged: int) -> int:
    """Dynamic shared memory of K1's wgmma form with `nwg` warpgroups and
    the weights staged (1) or streamed (0), for windows of n tokens, C
    channels and `heads` heads, or 0 for a shape it does not take: a model
    of the kernel's `fbanet_window_attention_wgmma_smem` (the layout of
    `AfLayout` in csrc/attention_wgmma.cuh, byte for byte: y, q, k, v as
    head tiles, the mask, the weights, the barriers, the alignment) that
    plans without the card, as the CPU tests do; on the card K1 plans with
    the kernel's own, and chip_smoke.py holds the two equal. C >= 64 takes
    two or four warpgroups, C = 32 one head on one warpgroup with the
    weights staged (the same layout: y / o is one tile of 64-byte rows)."""
    if n != 64 or (c % 64 and c != 32) or c > 256 or heads < 1 or c % heads:
        return 0
    if c == 32:
        if heads != 1 or nwg != 1 or staged != 1:
            return 0
    elif c // heads not in _WGMMA_HEAD_SIZES or nwg not in (2, 4) or \
            staged not in (0, 1):
        return 0
    weights = 8 * c * c if staged else nwg * _K1_SLOTS * 4096
    barriers = 8 * (1 if staged else nwg * _K1_SLOTS)
    total = (128 * c + 3 * _head_tiles_bytes(c, heads) + 4 * 64 * 64
             + weights + barriers + 1024)
    return total if total <= _SMEM_LIMIT else 0


def _kernel_attention_smem(n: int, c: int, heads: int, nwg: int,
                           staged: int) -> int:
    """The kernel's own `fbanet_window_attention_wgmma_smem` (builds the
    library on first use)."""
    return _build.library().fbanet_window_attention_wgmma_smem(
        n, c, heads, nwg, staged)


@functools.lru_cache(maxsize=256)
def _attention_plan(b: int, h: int, w: int, c: int, heads: int, ws: int = 8,
                    bf16: bool = True, sms: int = _SMS,
                    smem=_attention_smem) -> tuple[int, int, int]:
    """(warpgroups per block, windows per block, weights staged) of K1 for
    x [b, h, w, c] (or b windows of ws x ws tokens with h = w = ws) and
    `heads` heads.

    bf16: the wgmma form, the first of `_K1_FORMS` whose shared memory
    (`smem`: the kernel's `_kernel_attention_smem` or its model
    `_attention_smem`) lets 4 // warpgroups blocks share an SM (the
    kernel's launch bounds): the weights staged with two warpgroups at
    C = 64 (two blocks per SM) and four at C = 128 (one), streamed by four
    at C = 256 and at C = 128 with head size 8 (its padded head tiles
    leave the staged weights no room), staged by one at C = 32 (four
    blocks per SM, K3's plan there); the windows dealt in order to as many
    blocks as the card holds at once, each taking `wpb` consecutive
    windows (`_window_blocks`). Measured at the five groups at B=2, 4 and
    8 (tools/measure_attention.py `plans`, NVIDIA H100 80GB HBM3 at
    700 W): the fastest plan, or within 7 % of it, at every group (PERF.md
    §6); at embed 32's groups (`--embed 32`) within 6.3 % of the fastest
    at enc1 to dec1, and at enc0 the fastest at B=2 and 8.6 % behind one
    window a block at B=8. Else `_K1_BASE_PLAN`, the
    first kernel: f32, head sizes other than `_WGMMA_HEAD_SIZES`, C other
    than 32, 64, 128 and 256, and C = 32 with more than one head."""
    if bf16 and h % ws == 0 and w % ws == 0 and \
            c % heads == 0 and c // heads in _WGMMA_HEAD_SIZES:
        for nwg, staged in _K1_FORMS:
            size = smem(ws * ws, c, heads, nwg, staged)
            resident = min(_SM_SMEM // (size + 1024), 4 // nwg) if size else 0
            if 0 < size <= _SMEM_LIMIT and resident >= 4 // nwg:
                windows = b * (h // ws) * (w // ws)
                return nwg, _cdiv(windows, resident * sms), staged
    return _K1_BASE_PLAN


def _attention_launch(x4, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bproj,
                      bias, mask, heads, ws, residual, plan):
    """Launch K1 on the map with `plan` (see `_attention_plan`): the wgmma
    form, counted in `fused_window_attention_2d.wgmma` (`.narrow` at head
    sizes 8 and 32), or the first kernel, in `fused_window_attention_2d.
    base`."""
    _check_kernel_shape(x4, heads, ws, mask)
    b, h, w, c = x4.shape
    lib = _build.library()
    bf16 = _check_plan(lib, x4, ws * ws, c, heads, plan,
                       lambda why: _unsupported(why, x4, heads, ws))
    ptrs, _kept = _forward_operands(x4, ln_scale, ln_bias, wq, bq, wkv, bkv,
                                    wproj, bproj, bias, mask, plan)
    out = torch.empty_like(x4)
    nwg, wpb, staged = plan
    if nwg:
        err = lib.fbanet_window_attention_wgmma(
            x4.data_ptr(), out.data_ptr(), *ptrs, b, h, w, c, heads, ws,
            int(residual), nwg, wpb, staged, _build.stream(x4))
    else:
        err = lib.fbanet_window_attention(
            x4.data_ptr(), out.data_ptr(), *ptrs, b, h, w, c, heads, ws,
            int(residual), bf16, _build.stream(x4))
    _build.check(err, "fused_window_attention_2d")
    _form_count(fused_window_attention_2d, nwg, c, heads).launches += 1
    return out


def _form_count(counted, nwg: int, c: int, heads: int):
    """The count of `counted` (K1's `fused_window_attention_2d` or K3's
    `_attention_bwd_launch`) for a launch on `nwg` warpgroups (0: the first
    kernel, `.base`) at C channels and `heads` heads: `.narrow` for the
    wgmma form at `_NARROW_HEAD_SIZES`, else `.wgmma`."""
    if not nwg:
        return counted.base
    return counted.narrow if c // heads in _NARROW_HEAD_SIZES \
        else counted.wgmma


def _check_plan(lib, x, n: int, c: int, heads: int, plan, fail) -> int:
    """Call `fail(why)` (which raises) if K1's form under `plan` does not
    take windows of n tokens, C channels and `heads` heads in x's dtype;
    else return the first kernel's bf16 flag."""
    nwg, _wpb, staged = plan
    bf16 = int(x.dtype == torch.bfloat16)
    if nwg:
        if not bf16 or lib.fbanet_window_attention_wgmma_smem(
                n, c, heads, nwg, staged) == 0:
            fail(f"the wgmma form takes no plan {plan} of this shape "
                 f"(bfloat16, 64-token windows, C 64, 128 or 256 with head "
                 f"size 8, 16, 32 or 64 on 2 or 4 warpgroups, or C = 32 with "
                 f"one head on 1 warpgroup, weights staged; within shared "
                 f"memory)")
        return bf16
    smem = lib.fbanet_window_attention_smem(n, c, heads, bf16)
    if smem == 0:
        fail("in bfloat16 the window's token count and C must be multiples "
             "of 16, the head size of 8, and a group of heads must fill "
             "whole 16-column tensor-core tiles")
    if smem > _SMEM_LIMIT:
        fail(f"needs {smem} B of shared memory per block (limit "
             f"{_SMEM_LIMIT})")
    return bf16


def _forward_operands(x, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bproj,
                      bias, mask, plan):
    """(the parameter pointers of K1's entries under `plan` after x and
    out, the parameters' copies): the wgmma form takes [Wq; Wkv] as one
    [3C, C] weight (in wq's place), the first kernel wq and wkv apart."""
    if plan[0]:
        wq, wkv = torch.cat([wq, wkv]), None
    kept = _kernel_args(x, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bproj,
                        bias, mask)
    ptrs = [None if t is None else t.data_ptr() for t in kept]
    if plan[0]:
        del ptrs[4]  # no wkv apart
    # the caller holds the parameters' copies until the launch is queued
    return ptrs, kept


# K3's plans: (warpgroups per block, windows per block). The wgmma form
# (csrc/attention_bwd_wgmma.cuh) takes bf16 8 x 8 windows, C 64, 128 or 256
# and head size 8, 16, 32 or 64 on two or four warpgroups, and C = 32 with
# one head (embed 32's enc0) on one; warpgroups 0 is the first kernel
# (csrc/attention_bwd.cuh: f32, every other shape), one window per block.
# K11's flags follow the plan onto either form at head sizes 16 and 64.
_K3_BASE_PLAN = (0, 1)


def _attention_bwd_smem(n: int, c: int, heads: int, nwg: int) -> int:
    """Dynamic shared memory of K3's wgmma form with `nwg` warpgroups for
    windows of n tokens, C channels and `heads` heads, or 0 for a shape it
    does not take: a model of the kernel's
    `fbanet_window_attention_bwd_wgmma_smem` (the layout of `AbLayout` in
    csrc/attention_bwd_wgmma.cuh, byte for byte: y | g, then do, q, k, v
    as head tiles) that plans without the card, as the CPU tests do; on
    the card K3 plans with the kernel's own, and chip_smoke.py holds the
    two equal. C >= 64 takes two or four warpgroups, C = 32 one head on
    one warpgroup."""
    if n != 64 or (c % 64 and c != 32) or c > 256 or heads < 1 or c % heads:
        return 0
    if c == 32:
        if heads != 1 or nwg != 1:
            return 0
    elif c // heads not in _WGMMA_HEAD_SIZES or nwg not in (2, 4) or \
            c > 64 * nwg:
        return 0
    t = 128 * c  # one 64 x C bf16 tensor
    ring = t + 4 * _head_tiles_bytes(c, heads)
    cs = ring + nwg * 2 * 4096 + (nwg * 8192 if t < nwg * 8192 else 0)
    # dy [64][C + 4] f32 and the column sums' scratch must end before the
    # rings
    if _cdiv(256 * (c + 4), 128) * 128 + 3 * nwg * 128 * 4 > ring:
        return 0
    colp = cs + nwg * 1024  # the block's running column partials
    total = colp + _cdiv(24 * c, 128) * 128 + 2 * 256 + nwg * 16 + 1024
    return total if total <= _SMEM_LIMIT else 0


def _kernel_bwd_smem(n: int, c: int, heads: int, nwg: int) -> int:
    """The kernel's own `fbanet_window_attention_bwd_wgmma_smem` (builds
    the library on first use)."""
    return _build.library().fbanet_window_attention_bwd_wgmma_smem(
        n, c, heads, nwg)


@functools.lru_cache(maxsize=256)
def _attention_bwd_plan(b: int, h: int, w: int, c: int, heads: int,
                        ws: int = 8, bf16: bool = True, sms: int = _SMS,
                        smem=_attention_bwd_smem) -> tuple[int, int]:
    """(warpgroups per block, windows per block) of K3 for x [b, h, w, c]
    (or b windows of ws x ws tokens with h = w = ws) and `heads` heads.

    bf16: the wgmma form where its shared memory (`smem`: the kernel's
    `_kernel_bwd_smem` or its model `_attention_bwd_smem`) takes the shape:
    one warpgroup at C = 32 (four such blocks an SM), two where two such
    blocks share an SM's shared memory (C <= 128), else four (one block
    per SM); the windows dealt in order to as many blocks as the card
    holds at once, each taking `wpb` consecutive windows
    (`_window_blocks`), so each block writes one partial row.
    Measured at the five groups at B=8 (tools/measure_attention_bwd.py
    `plans`, NVIDIA H100 80GB HBM3 at 700 W): two warpgroups took 6-20 %
    less device time than four where both fit; one window per block (a
    partial row per window) ran 0-6 % faster per call, sums included, than
    this plan, whose partial at dec1 is 13x smaller (PERF.md §6). At embed
    32's four groups on the form (head sizes 32 and 8, `--embed 32`) the
    plan's call, sums included, was the fastest or within 0.6 % of it at
    enc1, bott and dec0; at dec1 one window per block ran 9 % faster with
    a partial 13x larger (424 MB against 33 MB at B=8), so the rule stays
    one for all head sizes. Else
    `_K3_BASE_PLAN`, the first kernel: f32, head sizes other than
    `_WGMMA_HEAD_SIZES`, C other than 32, 64, 128 and 256, and C = 32
    with more than one head."""
    if bf16 and h % ws == 0 and w % ws == 0 and \
            c % heads == 0 and c // heads in _WGMMA_HEAD_SIZES:
        for nwg in (1, 2, 4):
            size = smem(ws * ws, c, heads, nwg)
            per_sm = _SM_SMEM // (size + 1024) if size else 0
            if 0 < size <= _SMEM_LIMIT and per_sm >= 4 // nwg:
                windows = b * (h // ws) * (w // ws)
                return nwg, _cdiv(windows, (4 // nwg) * sms)
    return _K3_BASE_PLAN


def _partial_rows(windows: int, plan: tuple[int, int]) -> int:
    """Rows of K3's partial sums under `plan`: one per block of the wgmma
    form, one per window of the first kernel."""
    nwg, wpb = plan
    return _cdiv(windows, wpb) if nwg else windows


def _window_blocks(windows: int, wpb: int) -> list[range]:
    """The windows each block of K3's wgmma form walks, in order: block i
    takes windows i wpb .. min(windows, (i + 1) wpb) - 1 (the kernel's
    `w0`, `nwin`)."""
    return [range(i * wpb, min(windows, (i + 1) * wpb))
            for i in range(_cdiv(windows, wpb))]


def window_attention_bwd(x4, g4, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj,
                         bias, mask, *, heads: int, window_size: int,
                         residual: bool = False):
    """K3 on CUDA tensors: the backward of `fused_window_attention_2d` for
    the incoming gradient g4 [B, H, W, C] (x4's dtype). Returns what
    `_plain_bwd_2d` returns. The kernel writes dx, per-token scratch and
    per-block partial sums; `ops.reduce` sums those in a fixed order.
    `_attention_bwd_plan` picks the form and its blocks."""
    ws = window_size
    _check_kernel_shape(x4, heads, ws, mask)
    b, h, w, c = x4.shape
    plan = _attention_bwd_plan(b, h, w, c, heads, ws,
                               x4.dtype == torch.bfloat16,
                               smem=_kernel_bwd_smem)
    out = _attention_bwd_launch(x4, g4, ln_scale, ln_bias, wq, bq, wkv, bkv,
                                wproj, bias, mask, heads, ws, residual, plan)
    window_attention_bwd.launches += 1
    return out


def _attention_bwd_launch(x4, g4, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj,
                          bias, mask, heads, ws, residual, plan):
    """Launch K3 on the map with `plan` (see `_attention_bwd_plan`), then
    the sums: the wgmma form counts in `_attention_bwd_launch.wgmma`
    (`.narrow` at head sizes 8 and 32), the first kernel in
    `_attention_bwd_launch.base`."""
    _check_kernel_shape(x4, heads, ws, mask)
    b, h, w, c = x4.shape
    n = ws * ws
    g4 = g4.to(x4.dtype).contiguous()
    windows = b * (h // ws) * (w // ws)
    ptrs, scratch, _kept = _bwd_operands(
        x4, g4, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bias, mask, heads,
        n, windows, plan, True)
    geom = (b, h, w, c, heads, ws, int(residual))
    lib = _build.library()
    nwg, wpb = plan
    if nwg:
        err = lib.fbanet_window_attention_bwd_wgmma(
            *ptrs, *geom, nwg, wpb, _build.stream(x4))
    else:
        bf16 = int(x4.dtype == torch.bfloat16)
        if lib.fbanet_window_attention_bwd_group(n, c, heads, bf16, 0) == 0:
            _unsupported("the backward kernel takes no head group of this "
                         "shape (bfloat16 needs tokens and C in multiples of "
                         "16, the head size of 8, and a group of whole "
                         "16-column tiles that fits shared memory)", x4,
                         heads, ws)
        err = lib.fbanet_window_attention_bwd(*ptrs, *geom, bf16,
                                              _build.stream(x4))
    _build.check(err, "window_attention_bwd")
    _form_count(_attention_bwd_launch, nwg, c, heads).launches += 1
    return (scratch[0], *_bwd_sums(g4, *scratch[1:], heads, n))


# launch counts per form, kept as the wrappers keep theirs
_attention_bwd_launch.wgmma = SimpleNamespace(launches=0)
_attention_bwd_launch.narrow = SimpleNamespace(launches=0)
_attention_bwd_launch.base = SimpleNamespace(launches=0)
window_attention_bwd.launches = 0


def _bwd_operands(x, g, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bias,
                  mask, heads, n, windows, plan, wgrads):
    """(the pointer arguments of K3's entries under `plan`, (dx, ys, os,
    dqs, dkvs, part), the parameters' copies): the wgmma form takes
    [Wq; Wkv] as one [3C, C] weight and writes one partial row per block,
    the first kernel wq and wkv apart and one row per window."""
    ln_s, ln_b, wq_, bq_, wkv_, bkv_, wproj_, _, bias_, mask_ = _kernel_args(
        x, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, None, bias, mask)
    dx = torch.empty_like(x)
    ys, os_, dqs, dkvs, part = _bwd_scratch(
        x, _partial_rows(windows, plan), heads, n, wgrads)

    def ptr(t):
        return None if t is None else t.data_ptr()

    head = (x.data_ptr(), g.data_ptr(), dx.data_ptr(), ptr(ys), ptr(os_),
            dqs.data_ptr(), dkvs.data_ptr(), ptr(part), ln_s.data_ptr(),
            ln_b.data_ptr())
    tail = (bias_.data_ptr(), ptr(mask_))
    if plan[0]:
        w3 = torch.cat([wq, wkv]).to(device=x.device, dtype=x.dtype)
        ptrs = (*head, w3.data_ptr(), bq_.data_ptr(), bkv_.data_ptr(),
                wproj_.data_ptr(), *tail)
    else:
        w3 = None
        ptrs = (*head, wq_.data_ptr(), bq_.data_ptr(), wkv_.data_ptr(),
                bkv_.data_ptr(), wproj_.data_ptr(), *tail)
    # the caller holds the parameters' copies until the launch is queued
    kept = (ln_s, ln_b, wq_, bq_, wkv_, bkv_, wproj_, bias_, mask_, w3)
    return ptrs, (dx, ys, os_, dqs, dkvs, part), kept


def _bwd_scratch(x, rows: int, heads: int, n: int, wgrads: bool):
    """K3's per-token scratch (y, o, dq, dk|dv in x's dtype and layout) and
    `rows` rows of partial sums (one per block of the wgmma form, one per
    window of the first kernel); without `wgrads` only dq and dk|dv, which
    the first kernel's dx chain reads back."""
    c = x.shape[-1]
    dqs = torch.empty_like(x)
    dkvs = torch.empty(*x.shape[:-1], 2 * c, device=x.device, dtype=x.dtype)
    if not wgrads:
        return None, None, dqs, dkvs, None
    part = torch.empty(rows, 6 * c + heads * n * n, device=x.device,
                       dtype=torch.float32)
    return torch.empty_like(x), torch.empty_like(x), dqs, dkvs, part


def _bwd_sums(g, ys, os_, dqs, dkvs, part, heads: int, n: int):
    """The parameter gradients from K3's scratch, by the fixed-order sums
    of ops.reduce: (ln scale, ln bias, wq, bq, wkv, bkv, wproj, bproj,
    bias [heads, n, n])."""
    c = g.shape[-1]
    t = g.numel() // c
    sums = column_sum(part)
    dwq = token_matmul(dqs.view(t, c), ys.view(t, c))
    dwkv = token_matmul(dkvs.view(t, 2 * c), ys.view(t, c))
    dwproj = token_matmul(g.view(t, c), os_.view(t, c))
    dlns, dlnb, dbq, dbkv, dbproj, dbias = torch.split(
        sums, [c, c, c, 2 * c, c, heads * n * n])
    return (dlns, dlnb, dwq, dbq, dwkv, dbkv, dwproj, dbproj,
            dbias.reshape(heads, n, n))


def _unsupported_windows(why: str, x: torch.Tensor, heads: int):
    raise ValueError(
        f"fused_window_attention kernel does not take x {tuple(x.shape)} "
        f"{x.dtype}, heads={heads}: {why}")


def _check_windows(x, heads: int, mask, windows_per_image: int):
    """Raise for windows `fused_window_attention` does not take on any
    device: not [G, N, C], or a mask that does not fit."""
    if x.dim() != 3:
        _unsupported_windows("x must be [G, N, C]", x, heads)
    g, n, _c = x.shape
    if mask is not None and (
            tuple(mask.shape) != (windows_per_image, n, n)
            or g % windows_per_image):
        _unsupported_windows(
            f"mask {tuple(mask.shape)} must be [windows_per_image="
            f"{windows_per_image}, N, N] and G a multiple of it", x, heads)


def _check_windows_kernel(x, heads: int, mask, windows_per_image: int):
    """Raise for windows K1b and K3's windowed entry do not take."""
    _check_windows(x, heads, mask, windows_per_image)
    if x.device.type != "cuda":
        _unsupported_windows(f"no kernel for device {x.device}", x, heads)
    if x.dtype not in (torch.float32, torch.bfloat16):
        _unsupported_windows("dtype must be float32 or bfloat16", x, heads)
    if not x.is_contiguous():
        _unsupported_windows("x must be contiguous", x, heads)
    if x.shape[-1] % heads:
        _unsupported_windows("C must divide by heads", x, heads)


def _launch_windows(x, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bproj,
                    bias, mask, heads: int, windows_per_image: int,
                    plan=None):
    """Launch K1b under `plan` (default `_attention_plan` for its windows;
    see there), counted in its form's `fused_window_attention_2d` count."""
    _check_windows_kernel(x, heads, mask, windows_per_image)
    g, n, c = x.shape
    ws = math.isqrt(n)
    if plan is None:
        plan = (_attention_plan(g, ws, ws, c, heads, ws,
                                x.dtype == torch.bfloat16,
                                smem=_kernel_attention_smem)
                if ws * ws == n else _K1_BASE_PLAN)
    lib = _build.library()
    bf16 = _check_plan(lib, x, n, c, heads, plan,
                       lambda why: _unsupported_windows(why, x, heads))
    ptrs, _kept = _forward_operands(x, ln_scale, ln_bias, wq, bq, wkv, bkv,
                                    wproj, bproj, bias, mask, plan)
    out = torch.empty_like(x)
    nw = windows_per_image if mask is not None else 1
    nwg, wpb, staged = plan
    if nwg:
        err = lib.fbanet_window_attention_wgmma_windows(
            x.data_ptr(), out.data_ptr(), *ptrs, g, n, c, heads, nw, nwg,
            wpb, staged, _build.stream(x))
    else:
        err = lib.fbanet_window_attention_windows(
            x.data_ptr(), out.data_ptr(), *ptrs, g, n, c, heads, nw, bf16,
            _build.stream(x))
    _build.check(err, "fused_window_attention")
    _form_count(fused_window_attention_2d, nwg, c, heads).launches += 1
    return out


def launch_bwd_windows(x, g, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bias,
                       mask, *, heads: int, windows_per_image: int, plan,
                       skip: int = 0, what: str = "window_attention_bwd"):
    """K3's windowed entry on CUDA windows [G, N, C] under `plan` (see
    `_attention_bwd_plan`), uncounted: with `skip` 0 K1b's backward, else
    K11 on the plan's form, the variant without the stage in the bit
    `skip` (csrc/common.cuh's kNo* bits; bfloat16, no mask): on the wgmma
    form csrc/attention_bwd_wgmma_ablation.cu, on the first kernel
    (`_K3_BASE_PLAN`) csrc/attention_bwd_ablation.cu. Returns what
    `attention_bwd_math` returns; with the kNoWgrads bit the parameter
    gradients are zeros and no sums run."""
    _check_windows_kernel(x, heads, mask, windows_per_image)
    gsz, n, c = x.shape
    lib = _build.library()
    bf16 = int(x.dtype == torch.bfloat16)
    nwg, wpb = plan
    if not nwg and lib.fbanet_window_attention_bwd_group(
            n, c, heads, bf16, skip) == 0:
        _unsupported_windows(
            "the backward kernel takes no head group of this shape (bfloat16 "
            "needs tokens and C in multiples of 16, the head size of 8, and "
            "a group of whole 16-column tiles that fits shared memory)", x,
            heads)
    g = g.to(x.dtype).contiguous()
    wgrads = not skip & _NO_WGRADS
    ptrs, scratch, _kept = _bwd_operands(
        x, g, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bias, mask, heads, n,
        gsz, plan, wgrads)
    stream = _build.stream(x)
    nw = windows_per_image if mask is not None else 1
    if skip:
        if bf16 == 0 or mask is not None or skip not in _SKIP_BITS:
            _unsupported_windows("the ablation variants take bfloat16 "
                                 "windows without a mask, one stage off "
                                 f"(skip {skip})", x, heads)
        if nwg:
            err = lib.fbanet_window_attention_bwd_wgmma_ablation(
                *ptrs, gsz, n, c, heads, nwg, wpb, skip, stream)
        else:
            err = lib.fbanet_window_attention_bwd_ablation(
                *ptrs, gsz, n, c, heads, skip, stream)
    elif nwg:
        err = lib.fbanet_window_attention_bwd_wgmma_windows(
            *ptrs, gsz, n, c, heads, nw, nwg, wpb, stream)
    else:
        err = lib.fbanet_window_attention_bwd_windows(
            *ptrs, gsz, n, c, heads, nw, bf16, stream)
    _build.check(err, what)
    dx, ys, os_, dqs, dkvs, part = scratch
    if wgrads:
        return (dx, *_bwd_sums(g, ys, os_, dqs, dkvs, part, heads, n))
    zeros = [torch.zeros(s, device=x.device) for s in (
        (c,), (c,), (c, c), (c,), (2 * c, c), (2 * c,), (c, c), (c,),
        (heads, n, n))]
    return (dx, *zeros)


_NO_WGRADS = 4  # csrc/common.cuh: kNoWgrads
_SKIP_BITS = (1, 2, 4, 8, 16)  # kNoRecompute .. kNoCore, one at a time


def window_attention_bwd_windows(x, g, ln_scale, ln_bias, wq, bq, wkv, bkv,
                                 wproj, bias, mask, *, heads: int,
                                 windows_per_image: int):
    """K3's windowed entry on CUDA tensors: the backward of
    `fused_window_attention` for the incoming gradient g [G, N, C], under
    `_attention_bwd_plan`. Returns what `window_attention_bwd_reference`
    returns. Counts in `window_attention_bwd.launches` and its form's
    `_attention_bwd_launch` count."""
    _check_windows_kernel(x, heads, mask, windows_per_image)
    gsz, n, c = x.shape
    ws = math.isqrt(n)
    plan = (_attention_bwd_plan(gsz, ws, ws, c, heads, ws,
                                x.dtype == torch.bfloat16,
                                smem=_kernel_bwd_smem)
            if ws * ws == n else _K3_BASE_PLAN)
    out = launch_bwd_windows(x, g, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj,
                             bias, mask, heads=heads,
                             windows_per_image=windows_per_image, plan=plan)
    _form_count(_attention_bwd_launch, plan[0], c, heads).launches += 1
    window_attention_bwd.launches += 1
    return out


class _FusedAttention(torch.autograd.Function):
    """K1 forward, K3 backward (or both plain versions)."""

    @staticmethod
    def forward(ctx, x4, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bproj,
                bias, mask, heads, ws, residual, plain):
        ctx.save_for_backward(x4, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj,
                              bproj, bias, mask)
        ctx.cfg = (heads, ws, residual, plain)
        if plain or x4.device.type == "cpu":
            return _plain_2d(x4, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj,
                             bproj, bias, mask, heads, ws, residual)
        return _kernel_forward(x4, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj,
                               bproj, bias, mask, heads, ws, residual)

    @staticmethod
    def backward(ctx, g4):
        x4, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bproj, bias, mask = \
            ctx.saved_tensors
        heads, ws, residual, plain = ctx.cfg
        if plain or x4.device.type == "cpu":
            grads = _plain_bwd_2d(x4, g4.to(x4.dtype), ln_scale, ln_bias, wq,
                                  bq, wkv, bkv, wproj, bias, mask, heads, ws,
                                  residual)
        else:
            grads = window_attention_bwd(
                x4, g4, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bias,
                mask, heads=heads, window_size=ws, residual=residual)
        dx, *dparams = grads
        params = (ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bproj, bias)
        return (dx, *(d.to(p.dtype) for d, p in zip(dparams, params)),
                None, None, None, None, None)


def fused_window_attention_2d(x4: torch.Tensor, ln_scale, ln_bias, wq, bq,
                              wkv, bkv, wproj, bproj, bias, mask, *,
                              heads: int, window_size: int,
                              residual: bool = False,
                              plain: bool = False) -> torch.Tensor:
    """Fused norm1 + window attention on the post-roll map `[B, H, W, C]`,
    computed in x4's dtype (the model's compute dtype), differentiable
    (backward: K3 on the card, the plain backward on the CPU).

    Returns the attention branch in image layout, or `x4 + branch` with
    `residual=True` (valid for shifted layers too: the roll is a
    permutation). Weights are torch Linear layouts: wq [C, C], wkv [2C, C],
    wproj [C, C]. `plain=True` forces the plain versions on any device; the
    kernel-vs-plain comparisons use it. A shape JAX's kernel does not take
    (`_supported`) runs the composed branch, `plain` or not.
    """
    b, h, w, c = x4.shape
    ws = window_size
    if h % ws or w % ws or not _supported(ws * ws, c, heads):
        fused_window_attention_2d.composed.launches += 1
        out = window_reverse(window_attention_composed(
            window_partition(x4, ws), ln_scale, ln_bias, wq, bq, wkv, bkv,
            wproj, bproj, bias, mask, heads=heads), ws, h, w)
        return x4 + out if residual else out
    return _FusedAttention.apply(x4, ln_scale, ln_bias, wq, bq, wkv, bkv,
                                 wproj, bproj, bias, mask, heads, window_size,
                                 residual, plain)


fused_window_attention_2d.launches = 0
# launch counts per form, kept as the wrappers keep theirs, and the composed
# branch's calls
fused_window_attention_2d.wgmma = SimpleNamespace(launches=0)
fused_window_attention_2d.narrow = SimpleNamespace(launches=0)
fused_window_attention_2d.base = SimpleNamespace(launches=0)
fused_window_attention_2d.composed = SimpleNamespace(launches=0)


class _WindowAttention(torch.autograd.Function):
    """K1b forward, K3's windowed entry backward (or both plain versions)."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bproj,
                bias, mask, heads, windows_per_image, plain):
        ctx.save_for_backward(x, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj,
                              bproj, bias, mask)
        ctx.cfg = (heads, windows_per_image, plain)
        if plain or x.device.type == "cpu":
            return window_attention_reference(
                x, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bproj, bias,
                mask, heads=heads)
        out = _launch_windows(x, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj,
                              bproj, bias, mask, heads, windows_per_image)
        fused_window_attention.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        x, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bproj, bias, mask = \
            ctx.saved_tensors
        heads, nw, plain = ctx.cfg
        if plain or x.device.type == "cpu":
            grads = window_attention_bwd_reference(
                x, g.to(x.dtype), ln_scale, ln_bias, wq, bq, wkv, bkv, wproj,
                bias, mask, heads=heads)
        else:
            grads = window_attention_bwd_windows(
                x, g, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bias, mask,
                heads=heads, windows_per_image=nw)
        dx, *dparams = grads
        params = (ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bproj, bias)
        return (dx, *(d.to(p.dtype) for d, p in zip(dparams, params)),
                None, None, None, None)


def fused_window_attention(x: torch.Tensor, ln_scale, ln_bias, wq, bq, wkv,
                           bkv, wproj, bproj, bias, mask, *, heads: int,
                           windows_per_image: int,
                           plain: bool = False) -> torch.Tensor:
    """Fused norm1 + window attention on `[G, N, C]` windows (no residual),
    computed in x's dtype, differentiable (backward: K3's windowed entry on
    the card, the plain backward on the CPU). `mask` is the shift mask
    `[windows_per_image, N, N]` or None; window g takes mask[g %
    windows_per_image], so G must be a multiple of it. Weights are torch
    Linear layouts. `plain=True` forces the plain versions on any device.
    Windows JAX's kernel does not take (`_supported`) run the composed
    branch, `plain` or not."""
    _check_windows(x, heads, mask, windows_per_image)
    if not _supported(x.shape[1], x.shape[2], heads):
        fused_window_attention.composed.launches += 1
        return window_attention_composed(
            x, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bproj, bias, mask,
            heads=heads)
    return _WindowAttention.apply(x, ln_scale, ln_bias, wq, bq, wkv, bkv,
                                  wproj, bproj, bias, mask, heads,
                                  windows_per_image, plain)


fused_window_attention.launches = 0
fused_window_attention.composed = SimpleNamespace(launches=0)
