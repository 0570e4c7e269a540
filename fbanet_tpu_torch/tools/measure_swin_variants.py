"""Candidate rewrites of the fused Swin attention (K1) and LeFF (K2)
kernels, timed against the production kernels on the card: the counterpart
of scripts/measure_swin_variants.py.

    python -m fbanet_tpu_torch.tools.measure_swin_variants [check | time |
        time-attn | time-leff] [--only=enc0,dec1] [--device cpu]

At the five SwinGroup shapes of the published model (the groups, inputs,
B = 8 and line format of `tools/measure_swin_rates.py`, which this tool
reuses):

- K7 (`variant_attention`): K1's function, mask-free, no residual, with
  the per-head stage as `loop` (softmax normalised before AV), `loop_ln`
  (K1's own order: the division by the row sum after AV), `stack3d` /
  `stack3d_ln` (heads stacked through each stage together), `lanepack`
  (heads in pairs, 2n-wide softmax rows, block-diagonal keys and values;
  even head counts), plus `ln+qkv1` (stack3d_ln with q, k, v from one
  weight panel) and, at enc0, `ln+nr2` (two windows per block). The cores
  run on the form K1's own plan picks for the shape (`attention_plan`:
  K1's wgmma form, csrc/attention_variants_wgmma.cu, the CORE parameter of
  attention_wgmma.cuh, at the five groups; its first kernel,
  csrc/attention_variants.cu, at the shapes the plan keeps there, or where
  a core's layout does not fit the wgmma form) or on the form of an
  explicit `plan`. On the wgmma form loop_ln is K1's own instantiation;
  stack3d(_ln) takes a warpgroup's heads two at a time (one logits and
  one p v wait per pair) and is loop(_ln) where a warpgroup holds one
  head (enc0, enc1); ln+qkv1 is stack3d_ln, since the form forms q | k | v
  in one product already; ln+nr2 is K1's plan with 2 windows per block;
  lanepack keeps k and v as [k_a, 0, k_b] per pair, so each block-diagonal
  operand is one 128-row wgmma operand (`wgmma_core`, `heads_per_stage`,
  `_variant_smem` model what the kernel runs and needs). On the first
  kernel the cores are pieces of K1's first kernel (a chunk of heads per
  stacked stage, qkv1 one [3 gw, C] panel, `nr` windows per block).
- K8 (`variant_leff`, csrc/leff_variants.cu): K2's function, no residual,
  with the depthwise 3x3 (`dwbf16`), both GELUs (`gelubf16`) or both
  (`bothbf16`) in packed bf16 arithmetic (`__nv_bfloat162`, two hidden
  channels per instruction), as flags of the form K2's own plan
  (`ops.leff._leff_plan`) picks for the shape: K2's wgmma form
  (csrc/leff_wgmma.cuh) at the five groups, its first kernel (leff.cuh)
  at the shapes the plan keeps there, or the form of an explicit `plan`.
  With no flag it is K2's instantiation of that form.

Modes: `check` holds every K7 core to the `loop` kernel of the same form
(`check` lines: K1's plan; `check-base`: K1's first kernel) within the
script's limit, max(4e-3, 2 * 2^-8 * max |out|) (two bf16 ulps at the
output's scale: the cores sum in another order, and late normalisation
rounds the probabilities elsewhere), says which are bitwise equal to it,
and holds each K8 variant within 0.05 of K8 with no flag (the script's
limit for trading precision for packing); `time` (`time-attn`,
`time-leff`) prints the script's lines `var/<group> <core>` and
`leffvar/<group> <variant>`, each beside `prod` (K1, or K8 with no flag),
and `var-base/<group> <core>` / `leffvar-base/<group> <variant>`, K7 / K8
on K1's / K2's first kernel (`_K1_BASE_PLAN` / `_K2_BASE_PLAN`, beside
that kernel as `prod`), so that both forms' answers come from one run.
Times are CUDA-event medians (`measure_swin_rates.time_fn`). With
`--device cpu` the same modes run the plain versions on the host (CPU
numbers; the header names the device).

On the card each wrapper launches its kernel or raises, naming the shape;
on the CPU (or with `plain=True`) it runs the plain version below, which
follows the script's `_var_kernel` / `_leff_var_kernel`. `.launches`
counts kernel launches, `attention_variant.wgmma` / `.base` and
`leff_variant.wgmma` / `.base` K7's and K8's per form.
"""

from __future__ import annotations

import functools
import math
import sys
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from fbanet_tpu_torch.ops import _build
from fbanet_tpu_torch.ops.attention import (
    _K1_BASE_PLAN,
    _attention_launch,
    _attention_plan,
    _attention_smem,
    _forward_operands,
    _kernel_args,
    _kernel_attention_smem,
    _rounded,
    fused_window_attention_2d,
    window_attention_reference,
    window_partition,
    window_reverse,
)
from fbanet_tpu_torch.ops.leff import _K2_BASE_PLAN, _taps, leff_reference
from fbanet_tpu_torch.ops.leff import _kernel_args as _leff_kernel_args
from fbanet_tpu_torch.ops.norm import layer_norm_f32
from fbanet_tpu_torch.tools.measure_swin_rates import (
    GROUPS,
    N,
    WS,
    _attn_args,
    _leff_args,
    attn_gflops,
    device_line,
    leff_gflops,
    parse_args,
    time_fn,
)
from fbanet_tpu_torch.tools import measure_swin_rates

# ---------------------------------------------------------------------------
# K7's plain version: the script's cores on windows [G, n, C]
# ---------------------------------------------------------------------------

def _split(a: torch.Tensor, heads: int) -> torch.Tensor:
    """[G, n, heads * dh] -> [G, heads, n, dh]."""
    g, n, c = a.shape
    return a.reshape(g, n, heads, c // heads).transpose(1, 2)


def _merge(a: torch.Tensor) -> torch.Tensor:
    """Inverse of `_split`."""
    g, h, n, dh = a.shape
    return a.transpose(1, 2).reshape(g, n, h * dh)


def _heads_stage(q, k, v, bias, cdtype, late_norm: bool) -> torch.Tensor:
    """softmax(q k^T + bias) v for stacked heads [G, h, n, dh], rounded to
    cdtype: normalised before AV (probabilities e / sum rounded), or with
    late_norm after it (e rounded, the f32 product times 1 / sum)."""
    logits = q @ k.transpose(-1, -2) + bias.float()[None]
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    if late_norm:
        o = (_rounded(e, cdtype) @ v) * (1.0 / e.sum(-1, keepdim=True))
    else:
        o = _rounded(e / e.sum(-1, keepdim=True), cdtype) @ v
    return _rounded(o, cdtype)


def _core_loop(q, kv, bias, *, heads: int, cdtype, late_norm: bool = False,
               chunk: int = 1) -> torch.Tensor:
    """One head at a time (the script's `_core_loop`): q [G, n, C] (scaled,
    rounded), kv [G, n, 2C], bias [heads, n, n] -> o [G, n, C]."""
    c = q.shape[-1]
    qh, kh, vh = _split(q, heads), _split(kv[..., :c], heads), \
        _split(kv[..., c:], heads)
    outs = [_heads_stage(qh[:, i:i + chunk], kh[:, i:i + chunk],
                         vh[:, i:i + chunk], bias[i:i + chunk], cdtype,
                         late_norm) for i in range(0, heads, chunk)]
    return _merge(torch.cat(outs, 1))


def _core_stack3d(q, kv, bias, *, heads: int, cdtype,
                  late_norm: bool = False) -> torch.Tensor:
    """Every head stacked through each stage together (the script's
    `_core_stack3d`). The same function as `_core_loop`: only the grouping
    differs (the kernel's chunk, which shared memory bounds, is no part of
    it)."""
    return _core_loop(q, kv, bias, heads=heads, cdtype=cdtype,
                      late_norm=late_norm, chunk=heads)


def pack_bias_pairs(bias: torch.Tensor) -> torch.Tensor:
    """[h, n, n] -> [h/2, n, 2n]: row m = [bias[2m] | bias[2m+1]]."""
    return torch.cat([bias[0::2], bias[1::2]], -1)


def _core_lanepack(q, kv, bias_pair, *, heads: int, cdtype) -> torch.Tensor:
    """Heads (2m, 2m+1) paired along the row (the script's
    `_core_lanepack`): logits [n, 2n] = [q_a | q_b] . [[k_a, 0], [0, k_b]]^T
    plus the packed bias, max and sum per n-wide half, e rounded times the
    block-diagonal [[v_a, 0], [0, v_b]], each half divided by its sum."""
    if heads % 2:
        raise ValueError(f"lanepack pairs heads; heads={heads} is odd")
    g, n, c = q.shape
    dh = c // heads
    p = heads // 2

    def pairs(a):  # [G, n, C] -> [G, p, n, 2 dh]
        return a.reshape(g, n, p, 2 * dh).transpose(1, 2)

    def blockdiag(a):  # [G, p, n, 2 dh] -> [G, p, 2n, 2 dh]
        lo, hi = a.clone(), a.clone()
        lo[..., dh:] = 0
        hi[..., :dh] = 0
        return torch.cat([lo, hi], -2)

    qp = pairs(q)
    kb, vb = blockdiag(pairs(kv[..., :c])), blockdiag(pairs(kv[..., c:]))
    logits = qp @ kb.transpose(-1, -2) + bias_pair.float()[None]
    ma = logits[..., :n].amax(-1, keepdim=True)
    mb = logits[..., n:].amax(-1, keepdim=True)
    e = torch.exp(logits - torch.cat([ma.expand(-1, -1, -1, n),
                                      mb.expand(-1, -1, -1, n)], -1))
    sa = e[..., :n].sum(-1, keepdim=True)
    sb = e[..., n:].sum(-1, keepdim=True)
    o = _rounded(e, cdtype) @ vb
    o = o * torch.cat([(1.0 / sa).expand(-1, -1, -1, dh),
                       (1.0 / sb).expand(-1, -1, -1, dh)], -1)
    return _rounded(o, cdtype).transpose(1, 2).reshape(g, n, c)


CORES = {
    "loop": _core_loop,
    "stack3d": _core_stack3d,
    "loop_ln": functools.partial(_core_loop, late_norm=True),
    "stack3d_ln": functools.partial(_core_stack3d, late_norm=True),
    "lanepack": _core_lanepack,  # pre-packed bias, even heads
}
# the kernel's compile-time core (csrc/attention_variants.cu: enum Core)
_CORE_IDS = {"loop": 0, "loop_ln": 1, "stack3d": 2, "stack3d_ln": 3,
             "lanepack": 4}


def _var_attention_plain(x4, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj,
                         bproj, bias, *, heads: int, core: str,
                         qkv1: bool = False) -> torch.Tensor:
    """The script's `_var_kernel` in plain PyTorch, computed in x4's dtype:
    LN rounded; q (+ bias, scaled) and k, v rounded, from one [3C, C]
    product with `qkv1`; the core; the f32-accumulated projection."""
    b, h, w, c = x4.shape
    cd = x4.dtype
    xw = window_partition(x4, WS)
    y = _rounded(layer_norm_f32(xw, ln_scale, ln_bias), cd)
    scale = (c // heads) ** -0.5
    if qkv1:
        qkv = y @ _rounded(torch.cat([wq, wkv]), cd).t() \
            + torch.cat([bq, bkv]).float()
        q, kv = _rounded(qkv[..., :c] * scale, cd), _rounded(qkv[..., c:], cd)
    else:
        q = _rounded((y @ _rounded(wq, cd).t() + bq.float()) * scale, cd)
        kv = _rounded(y @ _rounded(wkv, cd).t() + bkv.float(), cd)
    if core == "lanepack":
        o = _core_lanepack(q, kv, pack_bias_pairs(bias), heads=heads,
                           cdtype=cd)
    else:
        o = CORES[core](q, kv, bias, heads=heads, cdtype=cd)
    out = o @ _rounded(wproj, cd).t() + bproj.float()
    return window_reverse(out, WS, h, w).to(cd)


# K7 on K1's wgmma form: the (head size, warpgroups, staged) triples it is
# built for, those `_attention_plan` picks at the five groups
# (csrc/attention_variants_wgmma.cu)
_K7_TRIPLES = ((64, 2, 1), (64, 4, 1), (16, 4, 0), (16, 4, 1))


def _variant_smem(n: int, c: int, heads: int, cid: int, nwg: int,
                  staged: int) -> int:
    """Dynamic shared memory of K7's core `cid` on K1's wgmma form, or 0
    for a shape it does not take: a model of the kernel's
    `fbanet_attention_variant_wgmma_smem` (AfLayout in
    csrc/attention_wgmma.cuh: K1's layout, or for lanepack k and v as 1.5
    tensors each with zero tiles between the heads of a pair and no mask)
    for planning without the card; chip_smoke.py holds the two equal."""
    if (n != N or c % 64 or c > 256 or heads < 1 or c % heads
            or cid not in _CORE_IDS.values()):
        return 0
    if (c // heads, nwg, staged) not in _K7_TRIPLES or (
            cid == _CORE_IDS["lanepack"] and heads % 2):
        return 0
    if cid != _CORE_IDS["lanepack"]:
        return _attention_smem(n, c, heads, nwg, staged)
    weights = 8 * c * c if staged else nwg * 4 * 4096
    total = 5 * 128 * c + weights + 8 * (1 if staged else nwg * 4) + 1024
    return total if total <= 232448 else 0


def _kernel_variant_smem(n, c, heads, cid, nwg, staged) -> int:
    """The kernel's own `fbanet_attention_variant_wgmma_smem` (builds the
    library on first use)."""
    return _build.library().fbanet_attention_variant_wgmma_smem(
        n, c, heads, cid, nwg, staged)


def attention_plan(x4, heads: int, core: str = "loop",
                   smem=_kernel_attention_smem, vsmem=_kernel_variant_smem):
    """K7's form for a bf16 map x4 [B, H, W, C]: K1's own plan for it
    (`_attention_plan`, with the kernel's shared memory or `smem`, its
    model) where K7 builds that form and `core` fits it (`vsmem`: the
    kernel's `fbanet_attention_variant_wgmma_smem` or `_variant_smem`),
    else K1's first kernel, `_K1_BASE_PLAN`."""
    b, h, w, c = x4.shape
    plan = _attention_plan(b, h, w, c, heads, WS, True, smem=smem)
    if plan[0] and vsmem(N, c, heads, _CORE_IDS[core], plan[0],
                         plan[2]) == 0:
        return _K1_BASE_PLAN
    return plan


def wgmma_core(core: str, c: int, heads: int, nwg: int) -> str:
    """The core whose instantiation runs `core` on K1's wgmma form with
    `nwg` warpgroups (the kernel's `variant_core`): stack3d(_ln) is
    loop(_ln) where a warpgroup holds one head, and at head size 64;
    ln+qkv1 reaches this as stack3d_ln (the form forms q | k | v in one
    product already)."""
    if core in ("stack3d", "stack3d_ln") and (
            c // heads != 16 or -(-heads // nwg) < 2):
        return core.replace("stack3d", "loop")
    return core


def heads_per_stage(core: str, c: int, heads: int, nwg: int) -> int:
    """Heads a warpgroup takes through each stage of `core` on the wgmma
    form (the kernel's `fbanet_attention_variant_wgmma_stage`)."""
    return 1 if wgmma_core(core, c, heads, nwg) in ("loop", "loop_ln") \
        else 2


def variant_launch(core: str, qkv1: bool, nr, c: int, heads: int, plan):
    """(the core whose instantiation runs, its qkv1 flag, windows per
    block) of K7 under `plan`: on the wgmma form `wgmma_core`'s core without
    qkv1 (the form forms q | k | v in one product, so ln+qkv1 is
    stack3d_ln) and `nr` or the plan's windows per block; on the first
    kernel the core and flag as given and `nr` or one."""
    nwg, wpb, _staged = plan
    if nwg:
        return wgmma_core(core, c, heads, nwg), False, nr or wpb
    return core, qkv1, nr or 1


def attention_variant(x4, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bproj,
                      bias, *, heads: int, core: str, qkv1: bool = False,
                      nr: int | None = None, plain: bool = False,
                      plan=None) -> torch.Tensor:
    """K7 on a bf16 CUDA map [B, H, W, C] (window 8, mask-free, no
    residual) under `plan` (default `attention_plan`: K1's own plan, the
    wgmma form at the five groups; `_K1_BASE_PLAN` for the first kernel),
    or its plain version for CPU tensors or with `plain=True`. `core` one of
    CORES, `qkv1` with stack3d_ln only (on the wgmma form that is
    stack3d_ln itself), `nr` windows per block (default: the plan's, one on
    the first kernel). Weights in torch Linear layouts, bias [heads, n,
    n]."""
    if core not in CORES or (qkv1 and core != "stack3d_ln"):
        raise ValueError(f"attention_variant has no core {core!r} with "
                         f"qkv1={qkv1} (qkv1 goes with stack3d_ln)")
    if plain or x4.device.type == "cpu":
        return _var_attention_plain(x4, ln_scale, ln_bias, wq, bq, wkv, bkv,
                                    wproj, bproj, bias, heads=heads,
                                    core=core, qkv1=qkv1)
    b, h, w, c = x4.shape
    windows = b * (h // WS) * (w // WS)
    if (x4.device.type != "cuda" or x4.dtype != torch.bfloat16
            or not x4.is_contiguous() or h % WS or w % WS or c % heads):
        raise ValueError(
            f"attention_variant kernel does not take x {tuple(x4.shape)} "
            f"{x4.dtype} {x4.device}, heads={heads}: a contiguous bfloat16 "
            f"CUDA map with H, W multiples of {WS} and C of heads")
    if plan is None:
        plan = attention_plan(x4, heads, core)
    lib = _build.library()
    nwg, _wpb, staged = plan
    core, qkv1, nr = variant_launch(core, qkv1, nr, c, heads, plan)
    cid = _CORE_IDS[core]
    out = torch.empty_like(x4)
    if nwg:
        if lib.fbanet_attention_variant_wgmma_smem(N, c, heads, cid, nwg,
                                                   staged) == 0:
            raise ValueError(
                f"attention_variant's wgmma form does not take x "
                f"{tuple(x4.shape)}, heads={heads}, core={core}, plan "
                f"{plan}: triples (head size, warpgroups, staged) "
                f"{_K7_TRIPLES}, lanepack with even heads")
        ptrs, _kept = _forward_operands(x4, ln_scale, ln_bias, wq, bq, wkv,
                                        bkv, wproj, bproj, bias, None, plan)
        err = lib.fbanet_attention_variant_wgmma(
            x4.data_ptr(), out.data_ptr(), *ptrs[:-1], b, h, w, c, heads,
            WS, cid, nwg, nr, staged, _build.stream(x4))
        form = attention_variant.wgmma
    else:
        if windows % nr:
            raise ValueError(f"attention_variant kernel does not take x "
                             f"{tuple(x4.shape)}, nr={nr}: nr must divide "
                             f"its windows")
        if lib.fbanet_attention_variant_smem(N, c, heads, cid) == 0:
            raise ValueError(
                f"attention_variant kernel does not take C={c}, heads="
                f"{heads}, core={core}: C and the head size must be multiples "
                f"of 16 (lanepack: even heads) and a stage must fit shared "
                f"memory")
        if core == "lanepack":
            bias = pack_bias_pairs(bias)
        args = _kernel_args(x4, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj,
                            bproj, bias, None)[:-1]
        err = lib.fbanet_attention_variant(
            x4.data_ptr(), out.data_ptr(), *[a.data_ptr() for a in args],
            b, h, w, c, heads, WS, cid, int(qkv1), nr, _build.stream(x4))
        form = attention_variant.base
    _build.check(err, f"attention_variant (x {tuple(x4.shape)}, core "
                      f"{core}, plan {plan})")
    form.launches += 1
    attention_variant.launches += 1
    return out


attention_variant.launches = 0
# launch counts per form, kept as the wrappers keep theirs
attention_variant.wgmma = SimpleNamespace(launches=0)
attention_variant.base = SimpleNamespace(launches=0)


def variant_attention(c: int, res: int, heads: int, core: str, *,
                      qkv1: bool = False, nr_override: int | None = None,
                      plan=None):
    """The script's factory: call(x4, lns, lnb, wq, bq, wkv, bkv, wproj,
    bproj, bias) runs K7 (or its plain version on the CPU) on a
    [batch, res, res, c] map, mask-free, under K1's plan or `plan`, with
    `nr_override` windows per block (default the plan's)."""
    def call(x4, *params, plain: bool = False):
        if tuple(x4.shape[1:]) != (res, res, c):
            raise ValueError(f"variant_attention({c}, {res}, {heads}) got x "
                             f"{tuple(x4.shape)}")
        return attention_variant(x4, *params, heads=heads, core=core,
                                 qkv1=qkv1, nr=nr_override, plain=plain,
                                 plan=plan)
    return call


# ---------------------------------------------------------------------------
# K8: the LeFF variants and their plain version
# ---------------------------------------------------------------------------

def _gelu_in(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's tanh form with every constant and step in x's dtype
    (each product and sum of a bf16 array rounded to bf16)."""
    def const(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    x3 = (x * x) * x
    t = torch.tanh(const(math.sqrt(2 / math.pi)) * (x + const(0.044715) * x3))
    return x * (const(0.5) * (const(1.0) + t))


def _leff_var_plain(x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2, *,
                    dw_bf16: bool, gelu_bf16: bool) -> torch.Tensor:
    """The script's `_leff_var_kernel` in plain PyTorch, computed in x's
    dtype: LN rounded; h1 = gelu of the f32 dense1 (rounded after), or of
    its rounded value in the compute dtype (`gelu_bf16`); the depthwise 3x3
    with f32 taps and accumulator, or all in the compute dtype (`dw_bf16`);
    the second GELU likewise; the f32-accumulated dense2."""
    cd = x.dtype
    ch = w1.shape[0]

    def gelu(z):
        if gelu_bf16:
            return _gelu_in(z.to(cd)).float()
        return _rounded(F.gelu(z.float(), approximate="tanh"), cd)

    y = _rounded(layer_norm_f32(x, ln_scale, ln_bias), cd)
    h1 = gelu(y @ _rounded(w1, cd).t() + b1.float())
    adt = cd if dw_bf16 else torch.float32
    taps = wdw.reshape(ch, 9).to(adt)
    acc = bdw.to(adt).expand_as(h1)
    for tap, h1s in _taps(h1.to(adt)):
        acc = acc + h1s * taps[:, tap]
    h2 = gelu(acc)
    return (h2 @ _rounded(w2, cd).t() + b2.float()).to(cd)


# K8's form: K2's own plan for the map (the helper K10 shares)
variant_plan = measure_swin_rates.leff_plan


def leff_variant(x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2, *,
                 dw_bf16: bool = False, gelu_bf16: bool = False,
                 plain: bool = False, plan=None) -> torch.Tensor:
    """K8 on a bf16 CUDA map [B, H, W, C] (no residual) under `plan`
    (default K2's own `_leff_plan` for the map; `_K2_BASE_PLAN` for the
    first kernel), or its plain version for CPU tensors or with
    `plain=True`. With no flag the kernel is K2's own instantiation of the
    plan's form."""
    if plain or x.device.type == "cpu":
        return _leff_var_plain(x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2,
                               dw_bf16=dw_bf16, gelu_bf16=gelu_bf16)
    b, h, w, c = x.shape
    ch = w1.shape[0]
    if (x.device.type != "cuda" or x.dtype != torch.bfloat16
            or not x.is_contiguous() or tuple(wdw.shape) != (ch, 1, 3, 3)
            or c % 16 or ch % 16):
        raise ValueError(f"leff_variant kernel does not take x "
                         f"{tuple(x.shape)} {x.dtype} {x.device}, hidden {ch}: "
                         f"a contiguous bfloat16 CUDA map, C and the hidden "
                         f"width multiples of 16")
    if plan is None:
        plan = variant_plan(x, ch)
    args = _leff_kernel_args(x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2)
    if plan[0]:  # W2 as W2^T [Ch, C], as K2's wgmma form takes it
        args[6] = w2.t().to(device=x.device, dtype=x.dtype,
                            memory_format=torch.contiguous_format)
    out = torch.empty_like(x)
    err = _build.library().fbanet_leff_variant(
        x.data_ptr(), out.data_ptr(), *[a.data_ptr() for a in args],
        b, h, w, c, ch, int(dw_bf16) + 2 * int(gelu_bf16), *plan,
        _build.stream(x))
    _build.check(err, f"leff_variant (x {tuple(x.shape)}, plan {plan})")
    form = leff_variant.wgmma if plan[0] else leff_variant.base
    form.launches += 1
    leff_variant.launches += 1
    return out


leff_variant.launches = 0
# launch counts per form, kept as the wrappers keep theirs
leff_variant.wgmma = SimpleNamespace(launches=0)
leff_variant.base = SimpleNamespace(launches=0)


def variant_leff(c: int, res: int, *, dw_bf16: bool = False,
                 gelu_bf16: bool = False, plan=None):
    """The script's factory: call(x, lns, lnb, w1, b1, wdw, bdw, w2, b2)
    runs K8 (or its plain version on the CPU) on a [batch, res, res, c]
    map, under K2's plan or `plan`."""
    def call(x, *params, plain: bool = False):
        if tuple(x.shape[1:]) != (res, res, c):
            raise ValueError(f"variant_leff({c}, {res}) got x "
                             f"{tuple(x.shape)}")
        return leff_variant(x, *params, dw_bf16=dw_bf16, gelu_bf16=gelu_bf16,
                            plain=plain, plan=plan)
    return call


LEFF_VARIANTS = {
    "dwbf16": dict(dw_bf16=True),
    "gelubf16": dict(gelu_bf16=True),
    "bothbf16": dict(dw_bf16=True, gelu_bf16=True),
}


def _max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def attention_cases(name: str, c: int, res: int, heads: int):
    """(line name, factory kwargs) of every K7 variant the script times at
    a group: the CORES (lanepack at even heads), ln+qkv1 and, at enc0's
    shape, ln+nr2."""
    cases = [(core, dict(core=core)) for core in CORES
             if core != "lanepack" or heads % 2 == 0]
    cases.append(("ln+qkv1", dict(core="stack3d_ln", qkv1=True)))
    if res == 160 and c == 64:
        cases.append(("ln+nr2", dict(core="stack3d_ln", nr_override=2)))
    return cases


def check(groups, device: str = "cuda") -> dict:
    """Every K7 variant against the `loop` kernel on two images of the
    tool's inputs, on each form (K1's plan, `check` lines; K1's first
    kernel, `check-base` lines), within max(4e-3, 2 * 2^-8 * max |out|),
    and whether it is bitwise equal to it; `loop` itself against the plain
    reference (window_attention_reference: late-normalised, so it differs
    by bf16 rounding). Returns {group/variant[ base]: max abs
    difference}."""
    diffs = {}
    for name, c, res, heads in groups:
        x4, *rest = _attn_args(c, res, heads, batch=2, device=device)
        ref = window_reverse(window_attention_reference(
            window_partition(x4, WS), *rest, None, heads=heads), WS, res, res)
        for tag, plan in (("check", None), ("check-base", _K1_BASE_PLAN)):
            key = "" if plan is None else " base"
            oracle = variant_attention(c, res, heads, "loop", plan=plan)(
                x4, *rest)
            print(f"{tag} {name} loop vs plain reference: "
                  f"{_max_abs(oracle, ref):.3e} (bf16 rounding)", flush=True)
            tol = max(4e-3, 2 * 2.0 ** -8 * float(oracle.float().abs().max()))
            for vname, kw in attention_cases(name, c, res, heads):
                if vname == "loop":
                    continue
                kw = dict(kw)
                core = kw.pop("core")
                out = variant_attention(c, res, heads, core, plan=plan,
                                        **kw)(x4, *rest)
                diff = diffs[f"{name}/{vname}{key}"] = _max_abs(out, oracle)
                status = "OK" if diff <= tol else f"DIFF {diff:.3e}"
                print(f"{tag} {name} {vname:10s}: {status} ({diff:.1e}, tol "
                      f"{tol:.1e}) bitwise={torch.equal(out, oracle)}",
                      flush=True)
                assert diff <= tol, (tag, name, vname, diff)
    return diffs


def check_leff(groups, device: str = "cuda") -> dict:
    """Each K8 variant against K8 with no flag (K2) and the plain
    reference, on two images; within 0.05 of K2 (the script's limit: these
    variants trade precision for packing). Returns {group/variant: max abs
    difference from K2}."""
    diffs = {}
    for name, c, res, _heads in groups:
        x, *rest = _leff_args(c, res, batch=2, device=device)
        prod = variant_leff(c, res)(x, *rest)
        ref = leff_reference(x, *rest)
        print(f"leff {name} prod vs plain reference: "
              f"{_max_abs(prod, ref):.3e}", flush=True)
        for vname, kw in LEFF_VARIANTS.items():
            out = variant_leff(c, res, **kw)(x, *rest)
            d_prod = diffs[f"{name}/{vname}"] = _max_abs(out, prod)
            print(f"leff {name} {vname:9s}: vs prod {d_prod:.3e}  vs ref "
                  f"{_max_abs(out, ref):.3e}", flush=True)
            assert d_prod <= 0.05, (name, vname, d_prod)
    return diffs


def _first_kernel(args, heads: int):
    """K1's first kernel (mask-free, no residual) on the tool's inputs; its
    plain version on the CPU."""
    if args[0].device.type == "cpu":
        return fused_window_attention_2d(*args, None, heads=heads,
                                         window_size=WS)
    return _attention_launch(*args, None, heads, WS, False, _K1_BASE_PLAN)


def main(argv=None) -> dict:
    """Run the mode; returns {line name: ms} (`check`: {name: max abs
    difference})."""
    args = parse_args(sys.argv[1:] if argv is None else argv, ["check"],
                      __doc__)
    dev = args.device
    groups = [g for g in GROUPS
              if not args.only or g[0] in args.only.split(",")]
    print(f"backend={device_line(dev)} B={measure_swin_rates.B} "
          f"dtype=bfloat16", flush=True)
    out = {}
    for mode in args.modes:
        if mode == "check":
            out.update(check(groups, dev))
            out.update(check_leff(groups, dev))
            continue
        if mode not in ("time", "time-attn", "time-leff"):
            raise SystemExit(f"unknown mode {mode!r}")

        def run(name, fn, fargs, gf):
            out[name] = time_fn(name, fn, fargs, gf)

        if mode in ("time", "time-attn"):
            for name, c, res, heads in groups:
                a = _attn_args(c, res, heads, device=dev)
                gf = attn_gflops(c, res)
                run(f"var/{name} prod",
                    lambda *t, heads=heads: fused_window_attention_2d(
                        *t, None, heads=heads, window_size=WS), a, gf)
                for vname, kw in attention_cases(name, c, res, heads):
                    kw = dict(kw)
                    run(f"var/{name} {vname}", variant_attention(
                        c, res, heads, kw.pop("core"), **kw), a, gf)
                # the same cores on K1's first kernel, beside it
                run(f"var-base/{name} prod",
                    lambda *t, heads=heads: _first_kernel(t, heads), a, gf)
                for vname, kw in attention_cases(name, c, res, heads):
                    kw = dict(kw)
                    run(f"var-base/{name} {vname}", variant_attention(
                        c, res, heads, kw.pop("core"), plan=_K1_BASE_PLAN,
                        **kw), a, gf)
        if mode in ("time", "time-leff"):
            for name, c, res, _heads in groups:
                a = _leff_args(c, res, device=dev)
                gf = leff_gflops(c, res)
                for prefix, plan in (("leffvar", None),
                                     ("leffvar-base", _K2_BASE_PLAN)):
                    run(f"{prefix}/{name} prod",
                        variant_leff(c, res, plan=plan), a, gf)
                    for vname, kw in LEFF_VARIANTS.items():
                        run(f"{prefix}/{name} {vname}",
                            variant_leff(c, res, plan=plan, **kw), a, gf)
    return out


if __name__ == "__main__":
    main()
