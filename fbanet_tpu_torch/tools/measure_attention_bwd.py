"""K3 (`window_attention_bwd`, the attention backward with its fixed-order
sums) at the five SwinGroup shapes of the published model (`--embed
32`: of the configuration's default width), on the card.

    python fbanet_tpu_torch/tools/measure_attention_bwd.py [shapes] [plans]
        [--batch 8] [--embed 64]

- shapes: per group, bf16, shift mask and residual on: K3's ms (CUDA
  events around 10 back-to-back calls, the sums included), its device ms
  (every kernel of the call in a torch.profiler trace: K3, R1, R2 and the
  weights' conversions), the plain backward's ms, the bound (`work`) and
  the share of it the device time reaches, the plan, every gradient
  against the plain backward (3e-2, relative as chip_smoke.py holds it)
  and a bitwise repeat. Raises if one is off.
- plans: K3's device ms (the K3 kernel alone, and the whole call: K3 with
  the sums of its partial rows and scratch) at each group under the first
  kernel and under the wgmma form with each number of warpgroups its
  shared memory takes and four numbers of windows per block (the plan's,
  a half and a quarter of it, and one); the plan `window_attention_bwd`
  picks is marked.
  Each plan's gradients are held against the plain backward as in shapes
  (raises if one is off). `measure_bwd.py blocks` runs this mode.

K3 has no CPU kernel (its wrapper raises off the card), so the tool runs
on the card only. Inputs are drawn on the device from fixed seeds. Prints
one line per row and a JSON line of the results; `main` returns them.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

if "fbanet_tpu_torch" not in sys.modules:  # run by its path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from fbanet_tpu_torch.tools import measure_reduce  # noqa: E402
from fbanet_tpu_torch.tools.measure_reduce import (  # noqa: E402
    GROUPS,
    WS,
    bound_ms,
    device_ms,
    log,
    rel_errors,
    shape_sums,
    time_ms,
)

TOL = 3e-2  # bf16: both versions round at the same points (chip_smoke.py)
# kernel names in a profiler trace: K3's wgmma form and its first kernel
K3_KEYS = ("attention_bwd_wgmma", "window_attention_bwd_kernel")


def work(batch: int, h: int, c: int, heads: int, masked: bool,
         backward: bool = True) -> tuple[float, float, float]:
    """(tensor-core flops, CUDA-core flops, bytes) of one K1 (or K3, with
    its sums) call on [batch, h, h, c], bf16 activations, f32 parameters:
    each input read once, each output written once. Forward: Q, K, V,
    proj 8 T C^2, logits and AV 4 T n C. Backward: recompute 6 T C^2 +
    4 T n C, do 2 T C^2, dv, dp, dq, dk 8 T n C, dy 6 T C^2, dWq, dWkv,
    dWproj 8 T C^2."""
    t, n = batch * h * h, WS * WS
    params = 4 * (4 * c * c + 6 * c + heads * n * n
                  + (h // WS) ** 2 * n * n * masked)
    if not backward:
        return 8 * t * c * c + 4 * t * n * c, 5 * t * n * heads, \
            4 * t * c + params
    return 22 * t * c * c + 12 * t * n * c, 10 * t * n * heads, \
        6 * t * c + params + 4 * (4 * c * c + 6 * c + heads * n * n)


def case(batch: int, h: int, c: int, heads: int, device: str, seed: int):
    """(x, g, parameters) of one K3 call with the shift mask, bf16
    activations, f32 parameters."""
    from fbanet_tpu_torch.models.layers import shift_attention_mask

    gen = torch.Generator(device=device).manual_seed(seed)
    n = WS * WS

    def nrm(shape, scale):
        return torch.randn(*shape, generator=gen, device=device) * scale

    x = nrm((batch, h, h, c), 1.0).bfloat16()
    g = nrm((batch, h, h, c), 1.0).bfloat16()
    p = dict(ln_scale=1 + nrm((c,), 0.1), ln_bias=nrm((c,), 0.1),
             wq=nrm((c, c), c ** -0.5), bq=nrm((c,), 0.1),
             wkv=nrm((2 * c, c), c ** -0.5), bkv=nrm((2 * c,), 0.1),
             wproj=nrm((c, c), c ** -0.5), bias=nrm((heads, n, n), 0.5),
             mask=torch.from_numpy(shift_attention_mask(
                 h, h, WS, WS // 2)).to(device))
    return x, g, p


def _plain(x, g, p, heads):
    from fbanet_tpu_torch.ops import attention

    return attention._plain_bwd_2d(x, g, *p.values(), heads, WS, True)


def shapes(batch: int = 8, groups: tuple = GROUPS) -> dict:
    """At each of `groups` (measure_reduce.groups): {"rows": one dict per
    group, "sums": ms, device_ms, plain_ms, bound_ms, bound_by summed over
    the groups}."""
    from fbanet_tpu_torch.ops import attention

    rows = []
    for i, (name, h, c, heads) in enumerate(groups):
        x, g, p = case(batch, h, c, heads, "cuda", 700 + i)

        def k3():
            return attention.window_attention_bwd(
                x, g, **p, heads=heads, window_size=WS, residual=True)

        got, again, ref = k3(), k3(), _plain(x, g, p, heads)
        errs = rel_errors(got, ref)
        bound, by = bound_ms(*work(batch, h, c, heads, True))
        row = dict(group=name, shape=f"B={batch} H={h} C={c} heads={heads}",
                   plan=attention._attention_bwd_plan(
                       batch, h, h, c, heads, smem=attention._kernel_bwd_smem),
                   max_rel_err=max(errs),
                   bitwise_repeat=all(torch.equal(a, b)
                                      for a, b in zip(got, again)),
                   ms=time_ms(k3, "cuda"),
                   plain_ms=time_ms(lambda: _plain(x, g, p, heads), "cuda",
                                    iters=3),
                   device_ms=device_ms(k3), bound_ms=bound, bound_by=by)
        row["share_of_bound"] = bound / row["device_ms"]
        del got, again, ref
        log(f"K3 {name} {row['shape']}: " + " ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items() if k not in ("group", "shape")))
        rows.append(row)
        del x, g, p
    sums = shape_sums("K3", rows, batch)
    bad = [r["group"] for r in rows
           if not (r["max_rel_err"] <= TOL and r["bitwise_repeat"])]
    if bad:
        raise AssertionError(f"K3 disagrees with its plain backward beyond "
                             f"{TOL} or does not repeat at {bad}")
    return {"rows": rows, "sums": sums}


def candidates(batch: int, h: int, c: int, heads: int, sms: int,
               smem=None) -> list:
    """The plans `plans` times: the first kernel, then per number of
    warpgroups the kernel's shared memory (`smem`, default the kernel's
    own) takes, the windows per block that give as many blocks as the card
    holds at once, a half and a quarter of it, and one."""
    from fbanet_tpu_torch.ops import attention

    smem_fn = smem or attention._kernel_bwd_smem
    out = [attention._K3_BASE_PLAN]
    windows = batch * (h // WS) ** 2
    for nwg in (4, 2, 1):
        if not 0 < smem_fn(WS * WS, c, heads, nwg) <= attention._SMEM_LIMIT:
            continue
        fill = -(-windows // ((4 // nwg) * sms))
        out += [(nwg, wpb) for wpb in sorted(
            {fill, max(1, fill // 2), max(1, fill // 4), 1}, reverse=True)]
    return out


def plans(batch: int = 8, groups: tuple = GROUPS) -> list[dict]:
    """K3's device ms and error per group under every plan of
    `candidates`."""
    from fbanet_tpu_torch.ops import attention

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out, bad = [], []
    for i, (name, h, c, heads) in enumerate(groups):
        x, g, p = case(batch, h, c, heads, "cuda", 700 + i)
        chosen = attention._attention_bwd_plan(
            batch, h, h, c, heads, sms=sms, smem=attention._kernel_bwd_smem)
        ref = _plain(x, g, p, heads)
        rows = []
        for plan in candidates(batch, h, c, heads, sms):
            def run(plan=plan):
                return attention._attention_bwd_launch(
                    x, g, *p.values(), heads, WS, True, plan)
            got, again = run(), run()
            row = dict(plan=plan, chosen=plan == chosen,
                       max_rel_err=max(rel_errors(got, ref)),
                       bitwise_repeat=all(torch.equal(a, b)
                                          for a, b in zip(got, again)),
                       device_ms=device_ms(run, keys=K3_KEYS),
                       call_device_ms=device_ms(run))
            if not (row["max_rel_err"] <= TOL and row["bitwise_repeat"]):
                bad.append((name, plan))
            rows.append(row)
            del got, again
        rows.sort(key=lambda r: r["device_ms"])
        out.append(dict(group=name, plans=rows))
        log(f"K3 plans {name} B={batch}: " + "; ".join(
            f"{r['plan']}{'*' if r['chosen'] else ''} {r['device_ms']:.4f} "
            f"(call {r['call_device_ms']:.4f}, err {r['max_rel_err']:.2e}, "
            f"repeat {r['bitwise_repeat']})"
            for r in rows))
        del x, g, p, ref
    if bad:
        raise AssertionError(f"K3 disagrees with its plain backward beyond "
                             f"{TOL} or does not repeat under {bad}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("modes", nargs="*", default=["shapes"],
                    choices=["shapes", "plans"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--embed", type=int, default=64,
                    help="the model width whose five groups are measured "
                         "(measure_reduce.groups: 64 published, 32 the "
                         "configuration's default)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("measure_attention_bwd: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 plain products
    res = {}
    groups = measure_reduce.groups(args.embed)
    if "shapes" in args.modes:
        res["shapes"] = shapes(args.batch, groups)
    if "plans" in args.modes:
        res["plans"] = plans(args.batch, groups)
    res["device"] = torch.cuda.get_device_name(0)
    log(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
