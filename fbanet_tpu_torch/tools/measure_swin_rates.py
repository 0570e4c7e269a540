"""Per-kernel rates of the fused Swin attention (K1) and LeFF (K2) kernels on
the card, and the ablation kernels K9 and K10 that split their time by stage:
the counterpart of scripts/measure_swin_rates.py.

    python -m fbanet_tpu_torch.tools.measure_swin_rates [attn leff ablate]
        [--device cpu]

Modes (default `attn leff`), each at the five SwinGroup shapes of the
published model (embed 64, 160 px), B = 8, window 8, bf16 activations, f32
parameters, as the script:

- attn: K1 (`ops.attention.fused_window_attention_2d`, mask-free, no
  residual);
- leff: K2 (`ops.leff.fused_leff`, no residual);
- ablate: K9 full / nosoftmax / nocore / notrans and K10 full / nogelu /
  nodw (each on both of K1's / K2's forms), each line with its delta from
  `full` (the time the removed stage costs, and its share of the kernel).

Every line is the script's: name, ms per call, GFLOP of the unablated
function, TFLOP/s. `time_fn` times with CUDA events: three warm-up calls,
then the median of 20 launches, each between its own pair of events. The
script times the slope of a chained `fori_loop` instead, which only keeps XLA
from hoisting a loop-invariant kernel out of the loop; eager PyTorch launches
every call it is given, so no such device is needed here. With
`--device cpu` the same lines time the plain versions on the host clock (a
CPU number; the header line names the device).

Inputs come from `np.random.default_rng(key)` in the script's order and
scale (`_attn_args`, `_leff_args`), so both tools see the same numbers; the
dense kernels are transposed to torch Linear layouts ([out, in]) and the
depthwise kernel to a torch depthwise Conv2d weight.

The ablation kernels (wrong math by design; they bound where the time goes):

- K9, `ablation_attention`: K1 in bf16, mask-free, no residual, with one
  stage changed at compile time, as the script's `_abl_kernel`
  (measure_swin_rates.py:136-199): nosoftmax (p = logits / n, rounded),
  nocore (o = q + k + v in bf16, no per-head stage), notrans (window g is
  tokens g * 64 .. g * 64 + 63 of each image's row-major map, which is what
  the script's `x4.reshape(gb, n, c)` of a block of whole rows reads). Its
  variants are stages of the form K1's own plan picks for the map
  (`ablation_plan`: K1's wgmma form at the five groups,
  csrc/attention_ablation_wgmma.cu, the CORE slot of attention_wgmma.cuh:
  `full` is K1's own kernel, nosoftmax and nocore new cores, notrans K1b's
  windowed entry over the map's memory; its first kernel, csrc/
  attention.cu, fbanet_window_attention_ablation, at the shapes the plan
  keeps there) or of the form of an explicit `plan`; `ablate` times them
  under K1's plan (`abl-attn/` lines) and on K1's first kernel
  (`_K1_BASE_PLAN`, `abl-attn-base/` lines). Its plain version is
  `abl_attention` / `_abl_attention_plain`. The script's `full` normalises
  before the AV product (`jax.nn.softmax`, probabilities rounded to bf16),
  and so does the plain version; the kernels' `full` is K1's, which
  divides after it (attention_pallas.py:217-223). The two differ by bf16
  rounding only, within the bf16 limit.
- K10, `ablation_leff` (csrc/leff_ablation.cu, fbanet_leff_ablation): K2
  in bf16, no residual, as `_leff_abl_kernel` (measure_swin_rates.py:
  253-293): nogelu (both GELUs become x * 0.7), nodw (no depthwise 3x3:
  h2 = act(h1) on the tile's own tokens). Its variants are flags of the
  form K2's own plan picks for the map (`leff_plan`: K2's wgmma form,
  csrc/leff_wgmma.cuh, NOGELU / NODW, at the five groups; its first
  kernel, leff.cuh, at the shapes the plan keeps there) or of the form of
  an explicit `plan`; `ablate` times them under K2's plan (`abl-leff/`
  lines) and on K2's first kernel (`_K2_BASE_PLAN`, `abl-leff-base/`
  lines), so that one run answers for both forms. Plain version
  `abl_leff`.

Each kernel's variants are flags of a production kernel, so `full` is
bitwise K1 (K9) or K2 (K10) on the form it runs on, and each variant is
that kernel minus one stage: K9's and K10's stage shares describe both of
K1's and K2's forms.
On the card each wrapper launches its kernel or raises; on the CPU (or with
`plain=True`) it runs the plain version. `.launches` counts kernel launches,
`ablation_attention.wgmma` / `.base` and `ablation_leff.wgmma` / `.base`
K9's and K10's per form.
"""

from __future__ import annotations

import argparse
import functools
import statistics
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from fbanet_tpu_torch.ops import _build
from fbanet_tpu_torch.ops.attention import (
    _K1_BASE_PLAN,
    _attention_plan,
    _attention_smem,
    _forward_operands,
    _kernel_args,
    _kernel_attention_smem,
    _rounded,
    fused_window_attention_2d,
    window_partition,
    window_reverse,
)
from fbanet_tpu_torch.ops.leff import (
    _K2_BASE_PLAN,
    _kernel_leff_smem,
    _leff_plan,
    _taps,
    fused_leff,
)
from fbanet_tpu_torch.ops.leff import _kernel_args as _leff_kernel_args
from fbanet_tpu_torch.ops.norm import layer_norm_f32

B = 8
WS = 8
N = WS * WS

# (name, channels, resolution, heads): the five SwinGroups of the published
# model
GROUPS = [
    ("enc0", 64, 160, 1),
    ("enc1", 128, 80, 2),
    ("bott", 256, 40, 16),
    ("dec0", 256, 80, 16),
    ("dec1", 128, 160, 8),
]

WARMUP, ITERS = 3, 20


def attn_gflops(c: int, res: int) -> float:
    nw = (res // WS) ** 2
    return B * nw * (8 * N * c * c + 4 * N * N * c) / 1e9


def leff_gflops(c: int, res: int) -> float:
    ch = 4 * c
    return B * res * res * (4 * c * ch + 18 * ch) / 1e9


def _draw(key: int, device):
    """u(*shape): the script's 0.1 * N(0, 1) f32 draws, in call order."""
    rng = np.random.default_rng(key)
    return lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32) * 0.1).to(device)


def _attn_args(c: int, res: int, heads: int, key: int = 0, *,
               batch: int | None = None, device="cuda"):
    """(x4 bf16 [B, res, res, c], ln scale, ln bias, wq, bq, wkv, bkv,
    wproj, bproj, bias [heads, N, N]): the script's numbers, weights in
    torch Linear layouts."""
    u = _draw(key, device)
    x4 = u(batch or B, res, res, c).to(torch.bfloat16)
    lns, lnb, wq, bq, wkv, bkv, wproj, bproj, bias = (
        u(c), u(c), u(c, c), u(c), u(c, 2 * c), u(2 * c), u(c, c), u(c),
        u(heads, N, N))
    return (x4, lns, lnb, wq.t().contiguous(), bq, wkv.t().contiguous(), bkv,
            wproj.t().contiguous(), bproj, bias)


def _leff_args(c: int, res: int, key: int = 0, *, batch: int | None = None,
               device="cuda"):
    """(x bf16 [B, res, res, c], ln scale, ln bias, w1 [4c, c], b1,
    wdw [4c, 1, 3, 3], bdw, w2 [c, 4c], b2): the script's numbers in torch
    layouts."""
    u = _draw(key, device)
    ch = 4 * c
    x = u(batch or B, res, res, c).to(torch.bfloat16)
    lns, lnb, w1, b1, wdw, bdw, w2, b2 = (
        u(c), u(c), u(c, ch), u(ch), u(3, 3, 1, ch), u(ch), u(ch, c), u(c))
    return (x, lns, lnb, w1.t().contiguous(), b1,
            wdw.permute(3, 2, 0, 1).contiguous(), bdw, w2.t().contiguous(), b2)


def time_fn(name: str, fn, args, gf: float) -> float:
    """Median ms per call of fn(*args): CUDA events around each of ITERS
    launches after WARMUP calls (the host clock for CPU tensors). Prints the
    script's line and returns the ms."""
    cuda = args[0].is_cuda
    for _ in range(WARMUP):
        fn(*args)
    times = []
    if cuda:
        torch.cuda.synchronize()
        marks = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(ITERS)]
        for start, end in marks:
            start.record()
            fn(*args)
            end.record()
        torch.cuda.synchronize()
        times = [s.elapsed_time(e) for s, e in marks]
    else:
        for _ in range(ITERS):
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    print(f"{name:34s} {ms:8.4f} ms  {gf:7.1f} GF  {gf / ms:6.1f} TF/s",
          flush=True)
    return ms


# ---------------------------------------------------------------------------
# K9: the attention ablation kernel and its plain version
# ---------------------------------------------------------------------------

def _abl_attention_plain(x4, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj,
                         bproj, bias, *, heads: int, softmax: bool,
                         perhead: bool, trans: bool) -> torch.Tensor:
    """The script's `_abl_kernel` (measure_swin_rates.py:136-199) in plain
    PyTorch, computed in x4's dtype: LN, q (scaled) / kv rounded; per head
    softmax(q k^T + bias) (or logits / n) rounded, times v, rounded; or
    o = q + k + v; then the f32-accumulated projection."""
    b, h, w, c = x4.shape
    cd = x4.dtype
    dh = c // heads
    xw = window_partition(x4, WS) if trans else x4.reshape(-1, N, c)
    g = xw.shape[0]
    y = _rounded(layer_norm_f32(xw, ln_scale, ln_bias), cd)
    q = _rounded((y @ _rounded(wq, cd).t() + bq.float()) * dh ** -0.5, cd)
    kv = _rounded(y @ _rounded(wkv, cd).t() + bkv.float(), cd)
    if perhead:
        def split(a):
            return a.reshape(g, N, heads, dh).transpose(1, 2)

        logits = split(q) @ split(kv[..., :c]).transpose(-1, -2) \
            + bias.float()[None]
        p = _rounded(torch.softmax(logits, -1) if softmax
                     else logits * (1.0 / N), cd)
        o = _rounded(p @ split(kv[..., c:]), cd).transpose(1, 2).reshape(
            g, N, c)
    else:
        o = _rounded(_rounded(q + kv[..., :c], cd) + kv[..., c:], cd)
    out = o @ _rounded(wproj, cd).t() + bproj.float()
    out = window_reverse(out, WS, h, w) if trans else out.reshape(b, h, w, c)
    return out.to(cd)


_ATTN_VARIANTS = {(True, True, True): 0, (False, True, True): 1,
                  (True, False, True): 2, (True, True, False): 3}
# K9 on K1's wgmma form: the (head size, warpgroups, staged) triples it is
# built for, those `_attention_plan` picks at the five groups (K7's,
# csrc/attention_ablation_wgmma.cu)
_K9_TRIPLES = ((64, 2, 1), (64, 4, 1), (16, 4, 0), (16, 4, 1))


def _ablation_smem(n: int, c: int, heads: int, variant: int, nwg: int,
                   staged: int) -> int:
    """Dynamic shared memory of K9's `variant` on K1's wgmma form, or 0 for
    a shape it does not take: a model of the kernel's
    `fbanet_attention_ablation_wgmma_smem` (K1's own layout, at the triples
    it is built for) for planning without the card; chip_smoke.py holds
    the two equal."""
    if (variant not in _ATTN_VARIANTS.values() or heads < 1 or c % heads
            or (c // heads, nwg, staged) not in _K9_TRIPLES):
        return 0
    return _attention_smem(n, c, heads, nwg, staged)


def _kernel_ablation_smem(n, c, heads, variant, nwg, staged) -> int:
    """The kernel's own `fbanet_attention_ablation_wgmma_smem` (builds the
    library on first use)."""
    return _build.library().fbanet_attention_ablation_wgmma_smem(
        n, c, heads, variant, nwg, staged)


def ablation_plan(x4, heads: int, smem=_kernel_attention_smem,
                  asmem=_kernel_ablation_smem):
    """K9's form for a bf16 map x4 [B, H, W, C], the same for every
    variant: K1's own plan for it (`_attention_plan`, with the kernel's
    shared memory or `smem`, its model) where K9 builds that form (`asmem`:
    the kernel's `fbanet_attention_ablation_wgmma_smem` or
    `_ablation_smem`), else K1's first kernel, `_K1_BASE_PLAN`."""
    b, h, w, c = x4.shape
    plan = _attention_plan(b, h, w, c, heads, WS, True, smem=smem)
    if plan[0] and asmem(N, c, heads, 0, plan[0], plan[2]) == 0:
        return _K1_BASE_PLAN
    return plan


def ablation_attention(x4, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bproj,
                       bias, *, heads: int, softmax: bool = True,
                       perhead: bool = True, trans: bool = True,
                       plain: bool = False, plan=None) -> torch.Tensor:
    """K9 on a bf16 CUDA map [B, H, W, C] (at most one stage off) under
    `plan` (default `ablation_plan`: K1's own plan, the wgmma form at the
    five groups; `_K1_BASE_PLAN` for the first kernel), or its plain
    version for CPU tensors or with `plain=True`. `full` is K1's own
    kernel on the plan's form, mask-free, no residual."""
    key = (softmax, perhead, trans)
    if key not in _ATTN_VARIANTS:
        raise ValueError(f"ablation_attention takes one stage off at a time, "
                         f"not softmax={softmax} perhead={perhead} "
                         f"trans={trans}")
    if plain or x4.device.type == "cpu":
        return _abl_attention_plain(
            x4, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bproj, bias,
            heads=heads, softmax=softmax, perhead=perhead, trans=trans)
    b, h, w, c = x4.shape
    if (x4.device.type != "cuda" or x4.dtype != torch.bfloat16
            or not x4.is_contiguous() or h % WS or w % WS or c % heads):
        raise ValueError(
            f"ablation_attention kernel does not take x {tuple(x4.shape)} "
            f"{x4.dtype} {x4.device}, heads={heads}: a contiguous bfloat16 "
            f"CUDA map with H, W multiples of {WS} and C of heads")
    variant = _ATTN_VARIANTS[key]
    if plan is None:
        plan = ablation_plan(x4, heads)
    lib = _build.library()
    nwg, wpb, staged = plan
    out = torch.empty_like(x4)
    if nwg:
        if lib.fbanet_attention_ablation_wgmma_smem(N, c, heads, variant, nwg,
                                                    staged) == 0:
            raise ValueError(
                f"ablation_attention's wgmma form does not take x "
                f"{tuple(x4.shape)}, heads={heads}, plan {plan}: triples "
                f"(head size, warpgroups, staged) {_K9_TRIPLES}")
        ptrs, _kept = _forward_operands(x4, ln_scale, ln_bias, wq, bq, wkv,
                                        bkv, wproj, bproj, bias, None, plan)
        err = lib.fbanet_attention_ablation_wgmma(
            x4.data_ptr(), out.data_ptr(), *ptrs[:-1], b, h, w, c, heads,
            WS, variant, nwg, wpb, staged, _build.stream(x4))
        form = ablation_attention.wgmma
    else:
        if lib.fbanet_window_attention_smem(N, c, heads, 1) == 0:
            raise ValueError(f"ablation_attention kernel does not take C={c}, "
                             f"heads={heads}: C and the head size must be "
                             f"multiples of 16")
        args = _kernel_args(x4, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj,
                            bproj, bias, None)
        err = lib.fbanet_window_attention_ablation(
            x4.data_ptr(), out.data_ptr(),
            *[None if a is None else a.data_ptr() for a in args],
            b, h, w, c, heads, WS, variant, _build.stream(x4))
        form = ablation_attention.base
    _build.check(err, f"ablation_attention (x {tuple(x4.shape)}, plan "
                      f"{plan})")
    form.launches += 1
    ablation_attention.launches += 1
    return out


ablation_attention.launches = 0
# launch counts per form, kept as the wrappers keep theirs
ablation_attention.wgmma = SimpleNamespace(launches=0)
ablation_attention.base = SimpleNamespace(launches=0)


def abl_attention(c: int, res: int, heads: int, *, softmax: bool = True,
                  perhead: bool = True, trans: bool = True, plan=None):
    """The script's factory: call(x4, lns, lnb, wq, bq, wkv, bkv, wproj,
    bproj, bias) runs K9 (or its plain version on the CPU) on a
    [batch, res, res, c] map, mask-free, under K1's plan or `plan`."""
    def call(x4, *params, plain: bool = False):
        if tuple(x4.shape[1:]) != (res, res, c):
            raise ValueError(f"abl_attention({c}, {res}, {heads}) got x "
                             f"{tuple(x4.shape)}")
        return ablation_attention(x4, *params, heads=heads, softmax=softmax,
                                  perhead=perhead, trans=trans, plain=plain,
                                  plan=plan)
    return call


# ---------------------------------------------------------------------------
# K10: the LeFF ablation kernel and its plain version
# ---------------------------------------------------------------------------

def _abl_leff_plain(x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2, *,
                    gelu: bool, dw: bool) -> torch.Tensor:
    """The script's `_leff_abl_kernel` (measure_swin_rates.py:253-293) in
    plain PyTorch, computed in x's dtype: LN rounded; h1 = act(dense1)
    rounded; h2 = act(depthwise 3x3 of h1 + bias) rounded (or act(h1));
    the f32-accumulated dense2. act is the tanh GELU or x * 0.7."""
    cd = x.dtype
    ch = w1.shape[0]

    def act(v):
        return F.gelu(v, approximate="tanh") if gelu else v * 0.7

    y = _rounded(layer_norm_f32(x, ln_scale, ln_bias), cd)
    h1 = _rounded(act(y @ _rounded(w1, cd).t() + b1.float()), cd)
    if dw:
        taps = wdw.float().reshape(ch, 9)
        z2 = bdw.float().expand_as(h1)
        for tap, h1s in _taps(h1):
            z2 = z2 + h1s * taps[:, tap]
        h2 = _rounded(act(z2), cd)
    else:
        h2 = _rounded(act(h1), cd)
    return (h2 @ _rounded(w2, cd).t() + b2.float()).to(cd)


_LEFF_VARIANTS = {(True, True): 0, (False, True): 1, (True, False): 2}
# C K8's and K10's flags are built at on K2's wgmma form
# (csrc/leff_variants.cu, leff_ablation.cu); K2's own form also takes
# C = 32 (FBANet-32's enc0), where the flags keep the first kernel: their
# measurements are of FBANet-64
_FLAG_CHANNELS = (64, 128, 256)


def leff_plan(x, ch: int, smem=_kernel_leff_smem):
    """The form of K2's flags (K10 here, K8 in measure_swin_variants) for a
    bf16 map x [B, H, W, C] with hidden width ch: K2's own plan for it
    (`_leff_plan`, with the kernel's shared memory or `smem`, its Python
    model), so that each variant runs on the form K2 runs on at that
    shape; K2's first kernel, `_K2_BASE_PLAN`, at C the flags' wgmma form
    is not built for (`_FLAG_CHANNELS`)."""
    if x.shape[-1] not in _FLAG_CHANNELS:
        return _K2_BASE_PLAN
    return _leff_plan(*x.shape, ch, True, smem=smem)


def ablation_leff(x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2, *,
                  gelu: bool = True, dw: bool = True, plain: bool = False,
                  plan=None) -> torch.Tensor:
    """K10 on a bf16 CUDA map [B, H, W, C] (at most one stage off) under
    `plan` (default K2's own `_leff_plan` for the map, the wgmma form at
    the five groups; `_K2_BASE_PLAN` for the first kernel), or its plain
    version for CPU tensors or with `plain=True`. `full` is K2's own
    instantiation of the plan's form."""
    if (gelu, dw) not in _LEFF_VARIANTS:
        raise ValueError("ablation_leff takes one stage off at a time")
    if plain or x.device.type == "cpu":
        return _abl_leff_plain(x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2,
                               gelu=gelu, dw=dw)
    b, h, w, c = x.shape
    ch = w1.shape[0]
    if (x.device.type != "cuda" or x.dtype != torch.bfloat16
            or not x.is_contiguous() or tuple(wdw.shape) != (ch, 1, 3, 3)
            or c % 16 or ch % 16):
        raise ValueError(f"ablation_leff kernel does not take x "
                         f"{tuple(x.shape)} {x.dtype} {x.device}, hidden "
                         f"{ch}: a contiguous bfloat16 CUDA map, C and the "
                         f"hidden width multiples of 16")
    if plan is None:
        plan = leff_plan(x, ch)
    args = _leff_kernel_args(x, ln_scale, ln_bias, w1, b1, wdw, bdw, w2, b2)
    if plan[0]:  # W2 as W2^T [Ch, C], as K2's wgmma form takes it
        args[6] = w2.t().to(device=x.device, dtype=x.dtype,
                            memory_format=torch.contiguous_format)
    out = torch.empty_like(x)
    err = _build.library().fbanet_leff_ablation(
        x.data_ptr(), out.data_ptr(), *[a.data_ptr() for a in args],
        b, h, w, c, ch, _LEFF_VARIANTS[(gelu, dw)], *plan, _build.stream(x))
    _build.check(err, f"ablation_leff (x {tuple(x.shape)}, plan {plan})")
    form = ablation_leff.wgmma if plan[0] else ablation_leff.base
    form.launches += 1
    ablation_leff.launches += 1
    return out


ablation_leff.launches = 0
# launch counts per form, kept as the wrappers keep theirs
ablation_leff.wgmma = SimpleNamespace(launches=0)
ablation_leff.base = SimpleNamespace(launches=0)


def abl_leff(c: int, res: int, *, gelu: bool = True, dw: bool = True,
             plan=None):
    """The script's factory: call(x, lns, lnb, w1, b1, wdw, bdw, w2, b2)
    runs K10 (or its plain version on the CPU) on a [batch, res, res, c]
    map, under K2's plan or `plan`."""
    def call(x, *params, plain: bool = False):
        if tuple(x.shape[1:]) != (res, res, c):
            raise ValueError(f"abl_leff({c}, {res}) got x {tuple(x.shape)}")
        return ablation_leff(x, *params, gelu=gelu, dw=dw, plain=plain,
                             plan=plan)
    return call


ATTN_ABLATIONS = [("full", {}), ("nosoftmax", {"softmax": False}),
                  ("nocore", {"perhead": False}),
                  ("notrans", {"trans": False})]
LEFF_ABLATIONS = [("full", {}), ("nogelu", {"gelu": False}),
                  ("nodw", {"dw": False})]


def device_line(device: str) -> str:
    """The header's name for the device the numbers come from."""
    if device == "cuda":
        return f"cuda ({torch.cuda.get_device_name(0)})"
    return device


def parse_args(argv, default_modes, doc: str):
    parser = argparse.ArgumentParser(description=doc.splitlines()[0])
    parser.add_argument("modes", nargs="*", default=default_modes)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (the plain versions)")
    parser.add_argument("--only", default="",
                        help="comma-separated group names to keep")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the kernels run on the card "
                         "(--device cpu times the plain versions)")
    return args


def main(argv=None) -> dict:
    """Run the modes; returns {line name: ms}."""
    args = parse_args(sys.argv[1:] if argv is None else argv,
                      ["attn", "leff"], __doc__)
    dev, what = args.device, args.modes
    groups = [g for g in GROUPS
              if not args.only or g[0] in args.only.split(",")]
    print(f"backend={device_line(dev)} B={B} dtype=bfloat16", flush=True)
    ms = {}
    # each group's inputs drawn once per run (numpy takes ~0.3 s a map)
    attn_args = functools.cache(
        lambda c, res, heads: _attn_args(c, res, heads, device=dev))
    leff_args = functools.cache(lambda c, res: _leff_args(c, res, device=dev))

    def run(name, fn, fargs, gf):
        ms[name] = time_fn(name, fn, fargs, gf)
        return ms[name]

    if "attn" in what:
        for name, c, res, heads in groups:
            a = attn_args(c, res, heads)
            run(f"attn/{name}_c{c}@{res}h{heads}",
                lambda *t, heads=heads: fused_window_attention_2d(
                    *t, None, heads=heads, window_size=WS), a,
                attn_gflops(c, res))

    if "leff" in what:
        for name, c, res, _heads in groups:
            run(f"leff/{name}_c{c}@{res}", fused_leff, leff_args(c, res),
                leff_gflops(c, res))

    if "ablate" in what:
        # K9 and K10 on the forms K1's and K2's plans pick, then on their
        # first kernels (`abl-attn-base/`, `abl-leff-base/`)
        runs = []
        for prefix, plan in (("abl-attn", None),
                             ("abl-attn-base", _K1_BASE_PLAN)):
            runs.append((prefix, ATTN_ABLATIONS, attn_gflops,
                         lambda c, res, heads, kw, plan=plan: abl_attention(
                             c, res, heads, plan=plan, **kw),
                         lambda c, res, heads: attn_args(c, res, heads)))
        for prefix, plan in (("abl-leff", None),
                             ("abl-leff-base", _K2_BASE_PLAN)):
            runs.append((prefix, LEFF_ABLATIONS, leff_gflops,
                         lambda c, res, heads, kw, plan=plan: abl_leff(
                             c, res, plan=plan, **kw),
                         lambda c, res, heads: leff_args(c, res)))
        for prefix, table, gflops, make, inputs in runs:
            for name, c, res, heads in groups:
                a = inputs(c, res, heads)
                gf = gflops(c, res)
                full = None
                for vname, kw in table:
                    t = run(f"{prefix}/{name} {vname}",
                            make(c, res, heads, kw), a, gf)
                    if full is None:
                        full = t
                    else:
                        print(f"{'':34s} full - {vname}: {full - t:+.4f} ms "
                              f"({100 * (full - t) / full:+.1f} % of full)",
                              flush=True)
    return ms


if __name__ == "__main__":
    main()
