"""K1 (`fused_window_attention_2d`'s forward, the fused window attention)
at the five SwinGroup shapes of the published model (`--embed
32`: of the configuration's default width), on the card.

    python fbanet_tpu_torch/tools/measure_attention.py [shapes] [plans]
        [--batch 8] [--embed 64]

- shapes: per group, bf16, shift mask and residual on: K1's ms (CUDA
  events around 10 back-to-back calls), its device ms (every kernel of the
  call in a torch.profiler trace: K1 and the weights' conversions), the
  plain version's ms, the bound (`measure_attention_bwd.work(...,
  backward=False)`) and the share of it the device time reaches, the plan,
  the output against the plain version (3e-2 of max(1, max |plain|), as
  chip_smoke.py holds it) and a bitwise repeat. Raises if one is off.
- plans: K1's device ms (the K1 kernel alone) at each group under the
  first kernel and under the wgmma form with two or four warpgroups on
  staged or streamed weights (one warpgroup, staged, at C = 32), each that
  its shared memory takes, and three
  numbers of windows per block (the plan's, half of it, and one); the plan
  `fused_window_attention_2d` picks is marked. Each plan's output is held
  against the plain version as in shapes (raises if one is off).

K1 has no CPU kernel (its wrapper raises off the card), so the tool runs
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

from fbanet_tpu_torch.tools.measure_attention_bwd import (  # noqa: E402
    case,
    work,
)
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
# kernel names in a profiler trace: K1's wgmma form and its first kernel
K1_KEYS = ("attention_wgmma_kernel", "window_attention_bf16_kernel")


def _inputs(batch: int, h: int, c: int, heads: int, seed: int):
    """(x, K1's parameters) with the shift mask: `measure_attention_bwd.
    case`'s x and parameters with a bproj."""
    x, _g, p = case(batch, h, c, heads, "cuda", seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    p = dict(p, bproj=torch.randn(c, generator=gen, device="cuda") * 0.1)
    order = ("ln_scale", "ln_bias", "wq", "bq", "wkv", "bkv", "wproj",
             "bproj", "bias", "mask")
    return x, {k: p[k] for k in order}


def shapes(batch: int = 8, groups: tuple = GROUPS) -> dict:
    """At each of `groups` (measure_reduce.groups): {"rows": one dict per
    group, "sums": ms, device_ms, plain_ms, bound_ms, bound_by summed over
    the groups}."""
    from fbanet_tpu_torch.ops import attention

    rows = []
    for i, (name, h, c, heads) in enumerate(groups):
        x, p = _inputs(batch, h, c, heads, 720 + i)

        def k1():
            return attention.fused_window_attention_2d(
                x, **p, heads=heads, window_size=WS, residual=True)

        def plain():
            return attention.fused_window_attention_2d(
                x, **p, heads=heads, window_size=WS, residual=True,
                plain=True)

        got, again = k1(), k1()
        bound, by = bound_ms(*work(batch, h, c, heads, True, backward=False))
        row = dict(group=name, shape=f"B={batch} H={h} C={c} heads={heads}",
                   plan=attention._attention_plan(
                       batch, h, h, c, heads,
                       smem=attention._kernel_attention_smem),
                   max_rel_err=rel_errors((got,), (plain(),))[0],
                   bitwise_repeat=bool(torch.equal(got, again)),
                   ms=time_ms(k1, "cuda"),
                   plain_ms=time_ms(plain, "cuda", iters=3),
                   device_ms=device_ms(k1), bound_ms=bound, bound_by=by)
        row["share_of_bound"] = bound / row["device_ms"]
        del got, again
        log(f"K1 {name} {row['shape']}: " + " ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items() if k not in ("group", "shape")))
        rows.append(row)
        del x, p
    sums = shape_sums("K1", rows, batch)
    bad = [r["group"] for r in rows
           if not (r["max_rel_err"] <= TOL and r["bitwise_repeat"])]
    if bad:
        raise AssertionError(f"K1 disagrees with its plain version beyond "
                             f"{TOL} or does not repeat at {bad}")
    return {"rows": rows, "sums": sums}


def candidates(batch: int, h: int, c: int, heads: int, sms: int,
               smem=None) -> list:
    """The plans `plans` times: the first kernel, then per (warpgroups,
    staged weights) that the kernel's shared memory (`smem`, default the
    kernel's own) takes, the windows per block that fill the card once at
    the form's residency, half of it and one."""
    from fbanet_tpu_torch.ops import attention

    smem_fn = smem or attention._kernel_attention_smem
    out = [attention._K1_BASE_PLAN]
    windows = batch * (h // WS) ** 2
    for nwg, staged in ((1, 1), (2, 1), (2, 0), (4, 1), (4, 0)):
        size = smem_fn(WS * WS, c, heads, nwg, staged)
        if not 0 < size <= attention._SMEM_LIMIT:
            continue
        resident = max(1, min(attention._SM_SMEM // (size + 1024), 4 // nwg))
        fill = -(-windows // (resident * sms))
        out += [(nwg, wpb, staged)
                for wpb in sorted({fill, max(1, fill // 2), 1}, reverse=True)]
    return out


def plans(batch: int = 8, groups: tuple = GROUPS) -> list[dict]:
    """K1's device ms and error per group under every plan of
    `candidates`."""
    from fbanet_tpu_torch.ops import attention

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out, bad = [], []
    for i, (name, h, c, heads) in enumerate(groups):
        x, p = _inputs(batch, h, c, heads, 720 + i)
        chosen = attention._attention_plan(
            batch, h, h, c, heads, sms=sms,
            smem=attention._kernel_attention_smem)
        ref = attention.fused_window_attention_2d(
            x, **p, heads=heads, window_size=WS, residual=True, plain=True)
        rows = []
        for plan in candidates(batch, h, c, heads, sms):
            def run(plan=plan):
                return attention._attention_launch(
                    x, *p.values(), heads, WS, True, plan)
            got, again = run(), run()
            row = dict(plan=plan, chosen=plan == chosen,
                       max_rel_err=rel_errors((got,), (ref,))[0],
                       bitwise_repeat=bool(torch.equal(got, again)),
                       device_ms=device_ms(run, keys=K1_KEYS))
            if not (row["max_rel_err"] <= TOL and row["bitwise_repeat"]):
                bad.append((name, plan))
            rows.append(row)
            del got, again
        rows.sort(key=lambda r: r["device_ms"])
        out.append(dict(group=name, plans=rows))
        log(f"K1 plans {name} B={batch}: " + "; ".join(
            f"{r['plan']}{'*' if r['chosen'] else ''} {r['device_ms']:.4f} "
            f"(err {r['max_rel_err']:.2e}, repeat {r['bitwise_repeat']})"
            for r in rows))
        del x, p, ref
    if bad:
        raise AssertionError(f"K1 disagrees with its plain version beyond "
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
        raise SystemExit("measure_attention: no CUDA device")
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
