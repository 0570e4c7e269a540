"""K1 — fused window attention (norm1 + W-MSA) on the 4-D feature map.

`fused_window_attention_2d` is the dispatcher (the counterpart of
fbanet_tpu/ops/attention_pallas.py::fused_window_attention_2d). For a CUDA
tensor it launches the hand-written kernel in `csrc/attention.cu`, which
replaces the TPU kernel `_attention2d_kernel`, or raises for a shape the
kernel does not take. For a CPU tensor, or with `plain=True`, it runs the
plain PyTorch version below. There is no silent fallback.

The plain version follows the TPU kernel's rounding points
(`_attn_block_math`, attention_pallas.py:153-231): LN in f32 rounded to the
compute dtype; q scaled in f32 after its bias, then rounded; f32 logits +
relative-position bias + shift mask; max-subtracted exp, probabilities
rounded for the AV product and the division by the f32 row sum applied after
it; f32-accumulated projections. Products of rounded operands are taken in
f32, which is what "bf16 inputs, f32 accumulation" means.

`fused_window_attention_2d.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from fbanet_tpu_torch.ops import _build
from fbanet_tpu_torch.ops.norm import layer_norm_f32

_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on the H100


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


def _plain_2d(x4, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bproj, bias,
              mask, heads, ws, residual):
    b, h, w, _c = x4.shape
    out = _attention_math(window_partition(x4, ws), ln_scale, ln_bias, wq, bq,
                          wkv, bkv, wproj, bproj, bias, mask, heads, x4.dtype)
    out = window_reverse(out, ws, h, w)
    if residual:
        out = out + x4.float()
    return out.to(x4.dtype)


def _unsupported(why: str, x4: torch.Tensor, heads: int, ws: int):
    raise ValueError(
        f"fused_window_attention_2d kernel does not take x {tuple(x4.shape)} "
        f"{x4.dtype}, heads={heads}, window={ws}: {why}")


def fused_window_attention_2d(x4: torch.Tensor, ln_scale, ln_bias, wq, bq,
                              wkv, bkv, wproj, bproj, bias, mask, *,
                              heads: int, window_size: int,
                              residual: bool = False,
                              plain: bool = False) -> torch.Tensor:
    """Fused norm1 + window attention on the post-roll map `[B, H, W, C]`,
    computed in x4's dtype (the model's compute dtype).

    Returns the attention branch in image layout, or `x4 + branch` with
    `residual=True` (valid for shifted layers too: the roll is a
    permutation). Weights are torch Linear layouts: wq [C, C], wkv [2C, C],
    wproj [C, C]. `plain=True` forces the plain version on any device; the
    kernel-vs-plain comparisons use it.
    """
    ws = window_size
    if plain or x4.device.type == "cpu":
        return _plain_2d(x4, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj,
                         bproj, bias, mask, heads, ws, residual)
    if x4.device.type != "cuda":
        _unsupported(f"no kernel for device {x4.device}", x4, heads, ws)
    b, h, w, c = x4.shape
    if x4.dtype not in (torch.float32, torch.bfloat16):
        _unsupported("dtype must be float32 or bfloat16", x4, heads, ws)
    if not x4.is_contiguous():
        _unsupported("x must be contiguous", x4, heads, ws)
    if h % ws or w % ws or c % heads:
        _unsupported("H and W must divide by the window and C by heads",
                      x4, heads, ws)
    lib = _build.library()
    n = ws * ws
    bf16 = int(x4.dtype == torch.bfloat16)
    smem = lib.fbanet_window_attention_smem(n, c, heads, bf16)
    if smem == 0:
        _unsupported("in bfloat16 the window's token count, C and the head "
                     "size must be multiples of 16 (tensor-core tiles)",
                     x4, heads, ws)
    if smem > _SMEM_LIMIT:
        _unsupported(f"needs {smem} B of shared memory per block "
                     f"(limit {_SMEM_LIMIT})", x4, heads, ws)
    if mask is not None and tuple(mask.shape) != ((h // ws) * (w // ws), n, n):
        _unsupported(f"mask shape {tuple(mask.shape)}", x4, heads, ws)

    def f32(t):
        return t.to(device=x4.device, dtype=torch.float32).contiguous()

    def wt(t):
        return t.to(device=x4.device, dtype=x4.dtype).contiguous()

    args = [f32(ln_scale), f32(ln_bias), wt(wq), f32(bq), wt(wkv), f32(bkv),
            wt(wproj), f32(bproj), f32(bias),
            None if mask is None else f32(mask)]
    out = torch.empty_like(x4)
    err = lib.fbanet_window_attention(
        x4.data_ptr(), out.data_ptr(),
        *[None if a is None else a.data_ptr() for a in args],
        b, h, w, c, heads, ws, int(residual), bf16,
        torch.cuda.current_stream(x4.device).cuda_stream)
    _build.check(err, "fused_window_attention_2d")
    fused_window_attention_2d.launches += 1
    return out


fused_window_attention_2d.launches = 0
