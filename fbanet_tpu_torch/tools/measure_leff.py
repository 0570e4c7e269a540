"""K2 (`fused_leff`'s forward, the fused LeFF) at the five SwinGroup shapes
of the published model (`--embed 32`: of the configuration's default
width), on the card.

    python fbanet_tpu_torch/tools/measure_leff.py [shapes] [plans]
        [--batch 8] [--embed 64]

- shapes: per group, bf16 with the residual: K2's ms (CUDA events around
  10 back-to-back calls), its device ms (every kernel of the call in a
  torch.profiler trace: K2 and the weights' conversions), the plain
  version's ms, the bound (`work`) and the share of it the device time
  reaches, the plan, the output against the plain version (3e-2 of
  max(1, max |plain|), as chip_smoke.py holds it). Raises if one is off.
- plans: K2's device ms (the K2 kernel alone) at each group under every
  form of the wgmma kernel that takes it (`leff._K2_FORMS`) and under the
  first kernel; the plan `fused_leff` picks is marked. Each plan's output
  is held against the plain version as in shapes (raises if one is off).

K2 has no CPU kernel (its wrapper raises off the card), so the tool runs
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
# kernel names in a profiler trace: K2's wgmma form and its first kernel
K2_KEYS = ("leff_wgmma_kernel", "leff_bf16_kernel")


def work(batch: int, h: int, c: int) -> tuple[float, float, float]:
    """(tensor-core flops, CUDA-core flops, bytes) of one K2 call on
    [batch, h, h, c], hidden 4c: dense1 and dense2 4 T C Ch, the depthwise
    taps 18 T Ch; x and out in bf16 and the f32 parameters read or written
    once."""
    t, ch = batch * h * h, 4 * c
    params = 4 * (2 * c * ch + 11 * ch + 3 * c)
    return 4 * t * c * ch, 18 * t * ch, 4 * t * c + params


def case(batch: int, h: int, c: int, device: str, seed: int):
    """(x, parameters) of one K2 call, bf16 activations, f32 params."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ch = 4 * c

    def nrm(shape, scale):
        return torch.randn(*shape, generator=gen, device=device) * scale

    x = nrm((batch, h, h, c), 1.0).bfloat16()
    p = dict(ln_scale=1 + nrm((c,), 0.1), ln_bias=nrm((c,), 0.1),
             w1=nrm((ch, c), c ** -0.5), b1=nrm((ch,), 0.1),
             wdw=nrm((ch, 1, 3, 3), 1 / 3), bdw=nrm((ch,), 0.1),
             w2=nrm((c, ch), ch ** -0.5), b2=nrm((c,), 0.1))
    return x, p


def shapes(batch: int = 8, groups: tuple = GROUPS) -> dict:
    """At each of `groups` (measure_reduce.groups): {"rows": one dict per
    group, "sums": ms, device_ms, plain_ms, bound_ms, bound_by summed over
    the groups}."""
    from fbanet_tpu_torch.ops import leff

    rows = []
    for i, (name, h, c, _heads) in enumerate(groups):
        x, p = case(batch, h, c, "cuda", 750 + i)

        def k2():
            return leff.fused_leff(x, **p, residual=True)

        def plain():
            return leff.fused_leff(x, **p, residual=True, plain=True)

        bound, by = bound_ms(*work(batch, h, c))
        row = dict(group=name, shape=f"B={batch} H={h} C={c} Ch={4 * c}",
                   plan=leff._leff_plan(batch, h, h, c, 4 * c,
                                        smem=leff._kernel_leff_smem),
                   max_rel_err=rel_errors((k2(),), (plain(),))[0],
                   ms=time_ms(k2, "cuda"), plain_ms=time_ms(plain, "cuda",
                                                            iters=3),
                   device_ms=device_ms(k2), bound_ms=bound, bound_by=by)
        row["share_of_bound"] = bound / row["device_ms"]
        log(f"K2 {name} {row['shape']}: " + " ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items() if k not in ("group", "shape")))
        rows.append(row)
        del x, p
    sums = shape_sums("K2", rows, batch)
    bad = [r["group"] for r in rows if not r["max_rel_err"] <= TOL]
    if bad:
        raise AssertionError(f"K2 disagrees with its plain version beyond "
                             f"{TOL} at {bad}")
    return {"rows": rows, "sums": sums}


def plans(batch: int = 8, groups: tuple = GROUPS) -> list[dict]:
    """K2's device ms and error per group of `groups` under every form of
    `leff._K2_FORMS` that takes it and under the first kernel."""
    from fbanet_tpu_torch.ops import leff

    out, bad = [], []
    for i, (name, h, c, _heads) in enumerate(groups):
        x, p = case(batch, h, c, "cuda", 750 + i)
        ch = 4 * c
        chosen = leff._leff_plan(batch, h, h, c, ch,
                                 smem=leff._kernel_leff_smem)
        cands = [leff._K2_BASE_PLAN] + [
            f for f in leff._K2_FORMS
            if h % f[0] == 0 and h % f[1] == 0 and ch % f[2] == 0
            and 0 < leff._kernel_leff_smem(c, *f) <= leff._SMEM_LIMIT]
        ref = leff.fused_leff(x, **p, residual=True, plain=True)
        rows = []
        for plan in cands:
            def run(plan=plan):
                return leff._leff_launch(x, *p.values(), True, plan)
            row = dict(plan=plan, chosen=plan == chosen,
                       max_rel_err=rel_errors((run(),), (ref,))[0],
                       device_ms=device_ms(run, keys=K2_KEYS))
            if not row["max_rel_err"] <= TOL:
                bad.append((name, plan))
            rows.append(row)
        rows.sort(key=lambda r: r["device_ms"])
        out.append(dict(group=name, plans=rows))
        log(f"K2 plans {name} B={batch}: " + "; ".join(
            f"{r['plan']}{'*' if r['chosen'] else ''} {r['device_ms']:.4f} "
            f"(err {r['max_rel_err']:.2e})" for r in rows))
        del x, p, ref
    if bad:
        raise AssertionError(f"K2 disagrees with its plain version beyond "
                             f"{TOL} under {bad}")
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
        raise SystemExit("measure_leff: no CUDA device")
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
