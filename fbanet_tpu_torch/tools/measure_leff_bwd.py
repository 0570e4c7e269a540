"""K4 (`leff_bwd`, the LeFF backward with its fixed-order sums) at the five
SwinGroup shapes of the published model (`--embed 32`: of the
configuration's default width), on the card.

    python fbanet_tpu_torch/tools/measure_leff_bwd.py [shapes] [plans]
        [--batch 8] [--embed 64]

- shapes: per group, bf16 with the residual: K4's ms (CUDA events around
  10 back-to-back calls, the sums included), its device ms (the kernels'
  own time in a torch.profiler trace: K4, R1, R2), the plain backward's
  ms, the bound and the share of it the device time reaches, the plan,
  every gradient against the plain backward (3e-2, relative as
  chip_smoke.py holds it) and a bitwise repeat. Raises if one is off.
- plans: K4's device ms (the K4 kernels alone) at each group
  under every form of the wgmma kernel that takes it (`leff._K4_FORMS`),
  unsplit and with as many splits as reach two blocks per SM, and under
  the WMMA form; the plan `leff_bwd` picks is marked. Each plan's
  gradients are held against the plain backward as in shapes (raises if
  one is off).

K4 has no CPU kernel (its wrapper raises off the card), so the tool runs
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
    bound_ms,
    device_ms,
    log,
    rel_errors,
    shape_sums,
    time_ms,
)

TOL = 3e-2  # bf16: both versions round at the same points (chip_smoke.py)


def work(batch: int, h: int, c: int) -> tuple[float, float, float]:
    """(tensor-core flops, CUDA-core flops, bytes) of one K4 call with its
    sums on [batch, h, h, c], hidden 4c: the recomputed dense1, dh2, dy and
    the two weight gradients 10 T C Ch, the depthwise forward, its
    transpose and the tap gradients 54 T Ch; x, g, dx in bf16 and the
    f32 parameters and their gradients read or written once."""
    t, ch = batch * h * h, 4 * c
    params = 4 * (2 * c * ch + 11 * ch + 3 * c)
    return 10 * t * c * ch, 54 * t * ch, 6 * t * c + 2 * params


def case(batch: int, h: int, c: int, device: str, seed: int):
    """(x, g, parameters) of one K4 call, bf16 activations, f32 params."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ch = 4 * c

    def nrm(shape, scale):
        return torch.randn(*shape, generator=gen, device=device) * scale

    x = nrm((batch, h, h, c), 1.0).bfloat16()
    g = nrm((batch, h, h, c), 1.0).bfloat16()
    p = dict(ln_scale=1 + nrm((c,), 0.1), ln_bias=nrm((c,), 0.1),
             w1=nrm((ch, c), c ** -0.5), b1=nrm((ch,), 0.1),
             wdw=nrm((ch, 1, 3, 3), 1 / 3), bdw=nrm((ch,), 0.1),
             w2=nrm((c, ch), ch ** -0.5))
    return x, g, p


def shapes(batch: int = 8, groups: tuple = GROUPS) -> dict:
    """At each of `groups` (measure_reduce.groups): {"rows": one dict per
    group, "sums": ms, device_ms, plain_ms, bound_ms, bound_by summed over
    the groups}."""
    from fbanet_tpu_torch.ops import leff

    rows = []
    for i, (name, h, c, _heads) in enumerate(groups):
        x, g, p = case(batch, h, c, "cuda", 800 + i)

        def k4():
            return leff.leff_bwd(x, g, **p, residual=True)

        def plain():
            dx, *rest = leff.leff_bwd_reference(x, g, **p)
            return (dx + g, *rest)

        got, again, ref = k4(), k4(), plain()
        errs = rel_errors(got, ref)
        bound, by = bound_ms(*work(batch, h, c))
        row = dict(group=name, shape=f"B={batch} H={h} C={c} Ch={4 * c}",
                   plan=leff._leff_bwd_plan(batch, h, h, c, 4 * c,
                                            smem=leff._kernel_smem),
                   max_rel_err=max(errs),
                   bitwise_repeat=all(torch.equal(a, b)
                                      for a, b in zip(got, again)),
                   ms=time_ms(k4, "cuda"), plain_ms=time_ms(plain, "cuda"),
                   device_ms=device_ms(k4), bound_ms=bound, bound_by=by)
        row["share_of_bound"] = bound / row["device_ms"]
        del got, again, ref
        log(f"K4 {name} {row['shape']}: " + " ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items() if k not in ("group", "shape")))
        rows.append(row)
        del x, g, p
    sums = shape_sums("K4", rows, batch)
    bad = [r["group"] for r in rows
           if not (r["max_rel_err"] <= TOL and r["bitwise_repeat"])]
    if bad:
        raise AssertionError(f"K4 disagrees with its plain backward beyond "
                             f"{TOL} or does not repeat at {bad}")
    return {"rows": rows, "sums": sums}


def _k4_device_ms(fn, iters: int = 10) -> float:
    """Device ms per call of the K4 kernels alone (not the sums) in a
    torch.profiler trace of `iters` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0)
             for e in prof.key_averages()
             if "CUDA" in str(e.device_type) and "leff_" in e.key
             and "bwd" in e.key)
    return us / iters / 1e3


def plans(batch: int = 8, groups: tuple = GROUPS) -> list[dict]:
    """K4's device ms and error per group of `groups` under every plan the
    wgmma form takes and under the WMMA form (`leff._WMMA_PLAN`)."""
    from fbanet_tpu_torch.ops import leff

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smem = leff._kernel_smem
    out, bad = [], []
    for i, (name, h, c, _heads) in enumerate(groups):
        x, g, p = case(batch, h, c, "cuda", 800 + i)
        ch = 4 * c
        chosen = leff._leff_bwd_plan(batch, h, h, c, ch, True, sms, smem)
        cands = [leff._WMMA_PLAN]
        for th, tw, kc in leff._K4_FORMS:
            if (h % th or h % tw or ch % kc
                    or not 0 < smem(c, th, tw, kc) <= leff._SMEM_LIMIT):
                continue
            most = leff._k4_splits_to_fill(batch * (h // th) * (h // tw),
                                           ch // kc, sms)
            cands += [(th, tw, kc, s) for s in sorted({1, most})]
        dx, *rest = leff.leff_bwd_reference(x, g, **p)
        ref = (dx + g, *rest)
        rows = []
        for plan in cands:
            def run(plan=plan):
                return leff._leff_bwd_launch(x, g, *p.values(), True, plan)
            got, again = run(), run()
            row = dict(plan=plan, chosen=plan == chosen,
                       max_rel_err=max(rel_errors(got, ref)),
                       bitwise_repeat=all(torch.equal(a, b)
                                          for a, b in zip(got, again)),
                       device_ms=_k4_device_ms(run))
            if not (row["max_rel_err"] <= TOL and row["bitwise_repeat"]):
                bad.append((name, plan))
            rows.append(row)
            del got, again
        rows.sort(key=lambda r: r["device_ms"])
        out.append(dict(group=name, plans=rows))
        log(f"K4 plans {name} B={batch}: " + "; ".join(
            f"{r['plan']}{'*' if r['chosen'] else ''} {r['device_ms']:.4f} "
            f"(err {r['max_rel_err']:.2e}, repeat {r['bitwise_repeat']})"
            for r in rows))
        del x, g, p, ref
    if bad:
        raise AssertionError(f"K4 disagrees with its plain backward beyond "
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
        raise SystemExit("measure_leff_bwd: no CUDA device")
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
