"""Backward-pass rates of the fused Swin kernels on the card, and the
ablation kernel K11 that splits the attention backward (K3) by stage: the
counterpart of scripts/measure_bwd.py.

    python -m fbanet_tpu_torch.tools.measure_bwd [check groups plainref
        leffabl merged ablate blocks] [--only=dec0,dec1] [--device cpu]

Modes (default `groups`), at the five SwinGroup shapes, B = 8, window 8,
bf16 activations, f32 parameters, as the script:

- check: K11's `full` against K3's windowed entry (the backward of
  `ops.attention.fused_window_attention`) on the script's small shape,
  every output; raises if they differ by more than 1e-5 of the largest
  value (on the card they are one kernel instantiation).
- groups: forward against forward + backward of K1 and K2 through their
  autograd Functions (the backward of 0.5 * sum(out^2) with respect to x
  and every parameter, as the script's `grad_wrapper`: the cotangent is the
  output, so nothing folds), then the script's table with "bwd ms @bound"
  (the backward's FLOPs at the card's 989 TFLOP/s bf16 peak) in place of
  its v5e conv-ceiling column.
- plainref (the script's xlaref): the plain PyTorch window attention
  (`window_attention_reference`), forward and forward + backward by
  autograd.
- leffabl: the plain-PyTorch counterpart of the script's saved-residual
  LeFF backward with stages removed (measure_bwd.py:552-648), at dec0 and
  dec1. It has no kernel. x, g and the weights are the script's numbers;
  the saved pre-activations z1, z2 come from a seeded torch generator on
  the device (no comparison reads them).
- merged: K11 with `merged=True`. The script fuses pairs of dots there; the
  function is the same, and so is the card's kernel: the line prints the
  parity and both times.
- ablate: the six K11 variants (full, norecompute, nodsoftmax, nowgrads,
  nodx, nocore), each line with its delta from `full`: `ablbwd/<group>` on
  the form K3's plan picks (the wgmma form at every group), then
  `ablbwd-base/<group>` on the first kernel (`_K3_BASE_PLAN`), so both
  forms' stage splits come from one run.

- blocks: the script's mode sweeps the TPU's VMEM budget and head-chunk
  cap; on Hopper it is K3's plan sweep (`measure_attention_bwd.plans`, card
  only): K3's device ms at each group under the first kernel and under the
  wgmma form with every number of warpgroups and three numbers of windows
  per block, each plan's gradients held against the plain backward.
`time_fn` and the inputs are `measure_swin_rates`'s. With `--device cpu`
the plain versions run on the host clock.

K11, `ablation_backward`: K3 on windows [8 nW, 64, C], bf16, mask-free,
with one stage removed at compile time, on the form K3's own plan
(`ops.attention._attention_bwd_plan`, as `window_attention_bwd_windows`
calls it) picks for the shape: K3's wgmma form
(csrc/attention_bwd_wgmma_ablation.cu, the SKIP bits of
attention_bwd_wgmma.cuh) at the five groups, its first kernel
(csrc/attention_bwd_ablation.cu, the kNo* bits of attention_bwd.cuh) at
the shapes the plan keeps there, such as `check`'s head size 32, or under
an explicit `plan`. Each switch as the script's `_abl_bwd_kernel`
(measure_bwd.py:182-357) gives it: norecompute (inv = 1, xhat = x, y = q
= x, kv = [x, x]), nodsoftmax (dlogits = dp / n), nocore (o = dq = dk = dv
= do, the bias gradient 0), nodx (dx = x, and dy = x for the LN
gradients), nowgrads (every parameter gradient 0: no o = p v product, no
per-token scratch, no partial sums, no R1/R2 sums, so a variant's time
includes the sums as K3's does). `full` is K3's windowed entry itself.
The first kernel keeps its dq and dk|dv rows in device memory for its dx
chain in every variant; the wgmma form keeps them in shared memory. Plain
version: `abl_backward` / `ops.attention.attention_bwd_math`. The wrapper
launches K11 on a CUDA tensor or raises; `.launches` counts its launches,
`.wgmma` / `.base` those of each form.
"""

from __future__ import annotations

import functools
import math
import sys
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from fbanet_tpu_torch.ops.attention import (
    _K3_BASE_PLAN,
    _attention_bwd_plan,
    _kernel_bwd_smem,
    attention_bwd_math,
    fused_window_attention_2d,
    launch_bwd_windows,
    window_attention_reference,
)
from fbanet_tpu_torch.ops.leff import _gelu_grad, fused_leff
from fbanet_tpu_torch.ops.norm import LN_EPS
from fbanet_tpu_torch.tools.measure_swin_rates import (
    _attn_args,
    _draw,
    _leff_args,
    device_line,
    parse_args,
    time_fn,
)

B = 8
WS = 8
N = WS * WS

GROUPS = [
    ("enc0", 64, 160, 1),
    ("enc1", 128, 80, 2),
    ("bott", 256, 40, 16),
    ("dec0", 256, 80, 16),
    ("dec1", 128, 160, 8),
]

PEAK_BF16_TFS = 989.0  # H100 SXM dense bf16 tensor-core peak at 700 W


def attn_fwd_gflops(c: int, res: int) -> float:
    nw = (res // WS) ** 2
    return B * nw * (8 * N * c * c + 4 * N * N * c) / 1e9


def attn_bwd_gflops(c: int, res: int) -> float:
    """22 N c^2 + 12 N^2 c per window: recompute qkv 6, do 2, dy 6, weight
    gradients 8; logits, AV, dP, dV, dQ, dK 2 each."""
    nw = (res // WS) ** 2
    return B * nw * (22 * N * c * c + 12 * N * N * c) / 1e9


def leff_fwd_gflops(c: int, res: int) -> float:
    ch = 4 * c
    return B * res * res * (4 * c * ch + 18 * ch) / 1e9


def leff_bwd_gflops(c: int, res: int) -> float:
    """An estimate, as the script labels it: the matmul share at the
    attention's 22/8 backward/forward ratio, the depthwise share at 3x."""
    ch = 4 * c
    return B * res * res * (4 * c * ch * 22 / 8 + 3 * 18 * ch) / 1e9


def grad_wrapper(fn, n_args: int):
    """The gradients of 0.5 * sum(out^2) with respect to the first `n_args`
    arguments (the script's cotangent: the output itself), each consumed in
    full as sum(grad^2), stacked."""
    def run(*args):
        leaves = [a.detach().requires_grad_() for a in args[:n_args]]
        out = fn(*leaves, *args[n_args:]).float()
        grads = torch.autograd.grad(0.5 * (out * out).sum(), leaves)
        return torch.stack([t.float().square().sum() for t in grads])
    return run


# ---------------------------------------------------------------------------
# K11: the attention-backward ablation kernel and its plain version
# ---------------------------------------------------------------------------

# csrc/attention_bwd.cuh's kNo* bits, by the script's switch names
_SKIP = {"recompute": 1, "dsoftmax": 2, "wgrads": 4, "dxchain": 8, "core": 16}


def ablation_plan(x, heads: int, smem=_kernel_bwd_smem):
    """K11's form for bf16 windows x [G, N, C]: K3's own plan for them
    (`_attention_bwd_plan`, as `window_attention_bwd_windows` asks it, with
    the kernel's shared memory or `smem`, its Python model), so that each
    variant runs on the form K3 runs on at that shape."""
    gsz, n, c = x.shape
    ws = math.isqrt(n)
    if ws * ws != n:
        return _K3_BASE_PLAN
    return _attention_bwd_plan(gsz, ws, ws, c, heads, ws, True, smem=smem)


def ablation_backward(x, g, ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bias,
                      *, heads: int, recompute: bool = True,
                      dsoftmax: bool = True, wgrads: bool = True,
                      dxchain: bool = True, core: bool = True,
                      merged: bool = False, plain: bool = False, plan=None):
    """K11 on bf16 CUDA windows [G, N, C] (mask-free, at most one stage
    off) under `plan` (default `ablation_plan`; `_K3_BASE_PLAN` for the
    first kernel), or its plain version for CPU tensors or with
    `plain=True`. `merged` names the script's fused-dot form of the same
    function, which is this same computation. Returns what the script's
    `call` returns, in its order and shapes ((1, D) bias rows), weight
    gradients in torch Linear layouts: (dx, dlns, dlnb, dwq [C, C], dbq,
    dwkv [2C, C], dbkv, dwproj [C, C], dbproj, dbias [heads, N, N])."""
    del merged
    flags = dict(recompute=recompute, dsoftmax=dsoftmax, wgrads=wgrads,
                 dxchain=dxchain, core=core)
    off = [k for k, on in flags.items() if not on]
    if len(off) > 1:
        raise ValueError(f"ablation_backward takes one stage off at a time, "
                         f"not {off}")
    params = (ln_scale, ln_bias, wq, bq, wkv, bkv, wproj, bias, None)
    if plain or x.device.type == "cpu":
        out = attention_bwd_math(x, g, *params, heads=heads, **flags)
    else:
        if x.dtype != torch.bfloat16 or x.device.type != "cuda":
            raise ValueError(f"ablation_backward kernel does not take x "
                             f"{tuple(x.shape)} {x.dtype} {x.device}: "
                             f"bfloat16 CUDA windows only")
        if plan is None:
            plan = ablation_plan(x, heads)
        out = launch_bwd_windows(x, g, *params, heads=heads,
                                 windows_per_image=1,
                                 skip=sum(_SKIP[k] for k in off),
                                 what="ablation_backward", plan=plan)
        form = ablation_backward.wgmma if plan[0] else ablation_backward.base
        form.launches += 1
        ablation_backward.launches += 1
    dx, dlns, dlnb, dwq, dbq, dwkv, dbkv, dwproj, dbproj, dbias = out
    return (dx, dlns[None], dlnb[None], dwq, dbq[None], dwkv, dbkv[None],
            dwproj, dbproj[None], dbias)


ablation_backward.launches = 0
# launch counts per form, kept as the wrappers keep theirs
ablation_backward.wgmma = SimpleNamespace(launches=0)
ablation_backward.base = SimpleNamespace(launches=0)


def abl_backward(c: int, res: int, heads: int, *, plan=None, **flags):
    """The script's factory, without its TPU block size (the card's blocks
    come from K3's plan, or `plan`): call(x, g, lns, lnb, wq, bq, wkv, bkv,
    wproj, bias) runs K11 (or its plain version on the CPU) on [G, N, c]
    windows."""
    def call(x, g, *params, plain: bool = False):
        if tuple(x.shape[1:]) != (N, c) or x.shape[0] % ((res // WS) ** 2):
            raise ValueError(f"abl_backward({c}, {res}, {heads}) got x "
                             f"{tuple(x.shape)}")
        return ablation_backward(x, g, *params, heads=heads, plain=plain,
                                 plan=plan, **flags)
    return call


BWD_ABLATIONS = [("full", {}), ("norecompute", {"recompute": False}),
                 ("nodsoftmax", {"dsoftmax": False}),
                 ("nowgrads", {"wgrads": False}),
                 ("nodx", {"dxchain": False}), ("nocore", {"core": False})]


def _win_args(c: int, res: int, heads: int, key: int = 0, *,
              batch: int | None = None, device="cuda"):
    """(x, g [B nW, N, c] bf16, ln scale, ln bias, wq, bq, wkv, bkv, wproj,
    bias): the script's numbers, weights in torch Linear layouts."""
    u = _draw(key, device)
    gsz = (batch or B) * (res // WS) ** 2
    x = u(gsz, N, c).to(torch.bfloat16)
    g = u(gsz, N, c).to(torch.bfloat16)
    lns, lnb, wq, bq, wkv, bkv, wproj, bias = (
        u(c), u(c), u(c, c), u(c), u(c, 2 * c), u(2 * c), u(c, c),
        u(heads, N, N))
    return (x, g, lns, lnb, wq.t().contiguous(), bq, wkv.t().contiguous(),
            bkv, wproj.t().contiguous(), bias)


NAMES = ["dx", "dlns", "dlnb", "dwq", "dbq", "dwkv", "dbkv", "dwproj",
         "dbproj", "dbias"]


def _rel_errs(got, ref) -> list[float]:
    return [float((a.float() - b.float()).abs().max())
            / max(1e-6, float(b.float().abs().max()))
            for a, b in zip(got, ref)]


def run_check(device: str) -> None:
    """K11's full variant against K3's windowed entry under the first
    kernel (the form K3's plan keeps for this head size, 32) on the
    script's shape, every output."""
    c, res, heads = 64, 16, 2
    x, g, *params = _win_args(c, res, heads, device=device)
    mine = abl_backward(c, res, heads)(x, g, *params)
    if device == "cpu":
        prod = attention_bwd_math(x, g, *params, None, heads=heads)
    else:
        prod = launch_bwd_windows(x, g, *params, None, heads=heads,
                                  windows_per_image=1, plan=_K3_BASE_PLAN)
    ok = True
    for nm, err in zip(NAMES, _rel_errs(mine, [p.reshape(m.shape) for p, m
                                               in zip(prod, mine)])):
        ok &= err < 1e-5
        print(f"check {nm:8s} vs production rel-err {err:.2e}  "
              f"{'OK' if err < 1e-5 else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the ablation kernel's full variant diverges "
                             "from the production backward")


def _leff_bwd_plain(x, g, lns, lnb, w1, wdw, w2, z1, z2, *, conv=True,
                    gelu=True, wg=True, dxc=True):
    """The script's saved-residual LeFF backward (measure_bwd.py:559-622) in
    plain PyTorch, with its stage switches; the script's layouts (w1 [c, ch],
    wdw [3, 3, 1, ch], w2 [ch, c]). bf16 products come back in bf16 here
    (the script asks XLA for f32 outputs); the work is the same. Returns
    sum(dx^2) + sum(dwdw^2) + sum(dw1^2) + sum(dw2^2), shape (1,)."""
    cd = x.dtype
    b, hh, ww, cc = x.shape
    ch = z1.shape[-1]
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    inv = torch.rsqrt(var + LN_EPS)
    xhat = (xf - mu) * inv
    lnsf = lns.float()
    y2 = (xhat * lnsf + lnb.float()).to(cd).reshape(-1, cc)
    h2 = F.gelu(z2, approximate="tanh")
    g2 = g.to(cd).reshape(-1, cc)
    dh2 = (g2 @ w2.to(cd).t()).float().reshape(z2.shape)
    if gelu:
        dz2 = (_gelu_grad(z2.float()) * dh2).to(z2.dtype)
    else:
        dz2 = dh2.to(z2.dtype) * 0.7
    wconv = wdw.to(cd).permute(3, 2, 0, 1)  # [ch, 1, 3, 3]
    if conv:
        h1 = F.gelu(z1, approximate="tanh").permute(0, 3, 1, 2)
        gout = dz2.permute(0, 3, 1, 2)
        dh1 = torch.nn.grad.conv2d_input(h1.shape, wconv, gout, padding=1,
                                         groups=ch).permute(0, 2, 3, 1)
        dwdw = torch.nn.grad.conv2d_weight(h1, wconv.shape, gout, padding=1,
                                           groups=ch)
    else:
        dh1, dwdw = dz2, torch.zeros_like(wconv)
    if gelu:
        dz1 = (_gelu_grad(z1.float()) * dh1.float()).to(z1.dtype)
    else:
        dz1 = dh1.to(z1.dtype) * 0.7
    dz1 = dz1.reshape(-1, ch)
    if wg:
        dw1 = y2.t() @ dz1.to(cd)
        dw2 = h2.reshape(-1, ch).t() @ g2
    else:
        dw1, dw2 = torch.zeros_like(w1), torch.zeros_like(w2)
    if dxc:
        dy = (dz1.to(cd) @ w1.to(cd).t()).float().reshape(b, hh, ww, cc)
        dxh = dy * lnsf
        m1 = dxh.mean(-1, keepdim=True)
        m2 = (dxh * xhat).mean(-1, keepdim=True)
        dx = (inv * (dxh - m1 - xhat * m2)).to(cd)
    else:
        dx = x
    return sum(t.float().square().sum() for t in (dx, dwdw, dw1, dw2)
               ).reshape(1)


LEFF_BWD_ABLATIONS = [("full", {}), ("noconv", {"conv": False}),
                      ("nogelu", {"gelu": False}), ("nowgrads", {"wg": False}),
                      ("nodx", {"dxc": False})]


def _timed_variants(prefix, table, fns, args, gf, ms) -> None:
    """Time each variant, printing its delta from the first (full)."""
    full = None
    for (vname, _kw), fn in zip(table, fns):
        name = f"{prefix} {vname}"
        ms[name] = t = time_fn(name, fn, args, gf)
        if full is None:
            full = t
        else:
            print(f"{'':34s} full - {vname}: {full - t:+.4f} ms "
                  f"({100 * (full - t) / full:+.1f} % of full)", flush=True)


def main(argv=None) -> dict:
    """Run the modes; returns {line name: ms}."""
    args = parse_args(sys.argv[1:] if argv is None else argv, ["groups"],
                      __doc__)
    dev, what = args.device, args.modes
    groups = [g for g in GROUPS
              if not args.only or g[0] in args.only.split(",")]
    print(f"backend={device_line(dev)} B={B} dtype=bfloat16", flush=True)
    ms = {}
    # each group's inputs drawn once per run (numpy takes ~0.3 s a map)
    attn_args = functools.cache(
        lambda c, res, heads: _attn_args(c, res, heads, batch=B, device=dev))
    leff_args = functools.cache(
        lambda c, res: _leff_args(c, res, batch=B, device=dev))
    win_args = functools.cache(
        lambda c, res, heads: _win_args(c, res, heads, batch=B, device=dev))

    def run(name, fn, fargs, gf):
        ms[name] = time_fn(name, fn, fargs, gf)
        return ms[name]

    if "check" in what:
        run_check(dev)

    if "groups" in what:
        print("\n== per-kernel fwd vs fwd+bwd (grad w.r.t. x + all params)",
              flush=True)
        rows = []
        for name, c, res, heads in groups:
            a = attn_args(c, res, heads)

            def fwd(*t, heads=heads):
                return fused_window_attention_2d(*t, None, heads=heads,
                                                 window_size=WS)
            ms_f = run(f"attn/{name} fwd", fwd, a, attn_fwd_gflops(c, res))
            ms_fb = run(f"attn/{name} fwd+bwd", grad_wrapper(fwd, 10), a,
                        attn_fwd_gflops(c, res) + attn_bwd_gflops(c, res))
            rows.append(("attn", name, c, res, ms_f, ms_fb,
                         attn_bwd_gflops(c, res)))
        for name, c, res, _heads in groups:
            a = leff_args(c, res)
            ms_f = run(f"leff/{name} fwd", fused_leff, a,
                       leff_fwd_gflops(c, res))
            ms_fb = run(f"leff/{name} fwd+bwd", grad_wrapper(fused_leff, 9),
                        a, leff_fwd_gflops(c, res) + leff_bwd_gflops(c, res))
            rows.append(("leff", name, c, res, ms_f, ms_fb,
                         leff_bwd_gflops(c, res)))
        print("\n| kernel | group | fwd ms | f+b ms | bwd ms | bwd GF | "
              "bwd TF/s | bwd ms @bound |", flush=True)
        print("|---|---|---|---|---|---|---|---|", flush=True)
        for kind, name, c, res, ms_f, ms_fb, gf_b in rows:
            bwd = ms_fb - ms_f
            tf = gf_b / bwd if bwd > 0 else float("nan")
            print(f"| {kind} | {name} c{c}@{res} | {ms_f:.4f} | {ms_fb:.4f} "
                  f"| {bwd:.4f} | {gf_b:.1f} | {tf:.1f} | "
                  f"{gf_b / PEAK_BF16_TFS:.4f} |", flush=True)

    if "plainref" in what:
        print("\n== plain window_attention_reference fwd / fwd+bwd "
              "(windows in)", flush=True)
        for name, c, res, heads in groups:
            x, _g, lns, lnb, wq, bq, wkv, bkv, wproj, bias = win_args(
                c, res, heads)
            a = (x, lns, lnb, wq, bq, wkv, bkv, wproj,
                 torch.zeros(c, device=dev), bias)

            def ref(*t, heads=heads):
                return window_attention_reference(*t, None, heads=heads)
            run(f"plainref/{name} fwd", ref, a, attn_fwd_gflops(c, res))
            run(f"plainref/{name} fwd+bwd", grad_wrapper(ref, 10), a,
                attn_fwd_gflops(c, res) + attn_bwd_gflops(c, res))

    if "leffabl" in what:
        print("\n== saved-residual LeFF plain backward, stages removed "
              "(wrong math; deltas bound the cost)", flush=True)
        for name, c, res, _heads in groups:
            if name not in ("dec0", "dec1"):
                continue
            ch = 4 * c
            u = _draw(3, dev)
            x = u(B, res, res, c).to(torch.bfloat16)
            g = u(B, res, res, c).to(torch.bfloat16)
            a = (x, g, u(c), u(c), u(c, ch), u(3, 3, 1, ch), u(ch, c))
            # the saved pre-activations z1, z2 (4C wide) from a seeded torch
            # generator on the device: numpy would take seconds for them,
            # and no comparison reads their values
            gen = torch.Generator(dev).manual_seed(3)
            a += tuple((0.1 * torch.randn(B, res, res, ch, generator=gen,
                                          device=dev)).to(torch.bfloat16)
                       for _ in range(2))
            fns = [lambda *t, kw=kw: _leff_bwd_plain(*t, **kw)
                   for _v, kw in LEFF_BWD_ABLATIONS]
            _timed_variants(f"leffabl/{name}", LEFF_BWD_ABLATIONS, fns, a,
                            leff_bwd_gflops(c, res), ms)

    if "merged" in what:
        print("\n== merged-dot bwd core: the same function, so the card runs "
              "the same kernel for both", flush=True)
        for name, c, res, heads in groups:
            a = win_args(c, res, heads)
            gf = attn_bwd_gflops(c, res)
            full_fn = abl_backward(c, res, heads)
            mrg_fn = abl_backward(c, res, heads, merged=True)
            errs = _rel_errs(full_fn(*a), mrg_fn(*a))
            print(f"mrgbwd/{name} parity max-rel {max(errs):.2e} (one "
                  f"kernel)", flush=True)
            run(f"mrgbwd/{name} full", full_fn, a, gf)
            run(f"mrgbwd/{name} merged", mrg_fn, a, gf)

    if "ablate" in what:
        print("\n== attention bwd-kernel ablations (wrong math; deltas only)",
              flush=True)
        for name, c, res, heads in groups:
            a = win_args(c, res, heads)
            for prefix, plan in (("ablbwd", None),
                                 ("ablbwd-base", _K3_BASE_PLAN)):
                fns = [abl_backward(c, res, heads, plan=plan, **kw)
                       for _v, kw in BWD_ABLATIONS]
                _timed_variants(f"{prefix}/{name}", BWD_ABLATIONS, fns, a,
                                attn_bwd_gflops(c, res), ms)

    if "blocks" in what:
        print(f"\n== K3's plans at B={B} (device ms of the K3 kernel alone)",
              flush=True)
        from fbanet_tpu_torch.ops.attention import _attention_bwd_smem
        from fbanet_tpu_torch.tools import measure_attention_bwd

        if dev != "cuda":  # no CPU kernel: the plans the card would time
            for name, c, res, heads in groups:
                cands = measure_attention_bwd.candidates(
                    B, res, c, heads, 132, smem=_attention_bwd_smem)
                print(f"blocks/{name}: K3 has no CPU kernel; plans on the "
                      f"card {cands}", flush=True)
        else:
            for grp in measure_attention_bwd.plans(B):
                for row in grp["plans"]:
                    ms[f"blocks/{grp['group']} {row['plan']}"] = \
                        row["device_ms"]
    return ms


if __name__ == "__main__":
    main()
