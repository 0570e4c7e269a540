"""ECC early termination (eps) on the serving path's translation align
(counterpart of scripts/measure_ecc_eps.py).

    python -m fbanet_tpu_torch.tools.measure_ecc_eps [--batch 8 --frames 14
        --size 160 --repeats 10] [--device cpu]

With eps > 0 each frame stops once its correlation stops moving; with eps
0 the iteration count is fixed. On the card the kernel `ecc_translation`
stops each frame on its own; on the CPU the plain loop
(`ops/registration.py::_run_ecc_iters`) reads back once an iteration
whether any frame is still moving, so a batch stops when its slowest frame
does. This tool times
`align_burst(motion="translation")` at B=8 under each setting and reports
how well each recovers the known shifts:

- bursts: `data/synthetic.py::realistic_bursts` (bench.py's realistic
  bursts: smooth sinusoid fields with known subpixel shifts and sensor
  noise; pure noise makes ECC's convergence degenerate);
- times: median and min of `--repeats` calls after two warm-up calls, on
  the host clock between `torch.cuda.synchronize()` calls, and the median
  of the same calls between CUDA events (the card's clock; on the CPU the
  host clock only). The JAX script's fori_loop slope is XLA's and has no
  counterpart here;
- error: |recovered - true| translation in px over frames 1..F-1.

`main` returns [{setting, levels, iters, eps, host_ms, host_min_ms,
event_ms, mean_err_px, max_err_px}].
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

# (name, levels, iterations per level, eps)
SETTINGS = (
    ("lv3 it10 eps0", 3, 10, 0.0),
    ("lv3 it25 eps0 (align.py)", 3, 25, 0.0),
    ("lv3 it25 eps1e-5 (online_register)", 3, 25, 1e-5),
    ("lv3 it25 eps1e-4", 3, 25, 1e-4),
    ("lv3 it10 eps1e-5", 3, 10, 1e-5),
)


def time_calls(fn, device: torch.device, repeats: int
               ) -> tuple[float, float, float | None]:
    """(median host ms, min host ms, median CUDA-event ms or None) of
    `repeats` calls of fn() after two warm-up calls."""
    cuda = device.type == "cuda"
    for _ in range(2):
        fn()
    host, events = [], []
    for _ in range(repeats):
        if cuda:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        fn()
        if cuda:
            end.record()
            torch.cuda.synchronize(device)
            events.append(start.elapsed_time(end))
        host.append((time.perf_counter() - t0) * 1e3)
    return (statistics.median(host), min(host),
            statistics.median(events) if events else None)


def main(argv: list[str] | None = None) -> list[dict]:
    from fbanet_tpu_torch.data.synthetic import realistic_bursts
    from fbanet_tpu_torch.ops.registration import align_burst
    from fbanet_tpu_torch.train import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--frames", type=int, default=14)
    p.add_argument("--size", type=int, default=160)
    p.add_argument("--repeats", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without one) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device, "measure_ecc_eps")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {name}; B={args.batch} x {args.frames} x {args.size}^2",
          flush=True)
    data = realistic_bursts(args.batch, args.frames, args.size, seed=7)
    bursts = torch.from_numpy(data["LR"]).to(device)
    # aligning frame f to frame 0 is the translation (-dx, -dy)
    true = -data["shifts"][:, :, ::-1]

    rows = []
    for setting, levels, iters, eps in SETTINGS:
        def run(levels=levels, iters=iters, eps=eps):
            with torch.no_grad():
                return align_burst(bursts, motion="translation",
                                   levels=levels, iters_per_level=iters,
                                   eps=eps)

        mats = run()[1].cpu().numpy()
        err = np.abs(mats[:, 1:, :2, 2] - true[:, 1:])
        host, host_min, event = time_calls(run, device, args.repeats)
        rows.append({"setting": setting, "levels": levels, "iters": iters,
                     "eps": eps, "host_ms": host, "host_min_ms": host_min,
                     "event_ms": event, "mean_err_px": float(err.mean()),
                     "max_err_px": float(err.max())})
        print(f"{setting}: host {host:.3f} ms (min {host_min:.3f}), events "
              f"{event if event is None else round(event, 3)} ms, err mean "
              f"{err.mean():.4f} max {err.max():.4f} px", flush=True)

    print(f"\n| setting | align ms B{args.batch} (host median / min) | "
          "CUDA-event ms | mean err px | max err px |")
    print("|---|---|---|---|---|")
    for r in rows:
        ev = "-" if r["event_ms"] is None else f"{r['event_ms']:.3f}"
        print(f"| {r['setting']} | {r['host_ms']:.3f} / {r['host_min_ms']:.3f}"
              f" | {ev} | {r['mean_err_px']:.4f} | {r['max_err_px']:.4f} |")
    return rows


if __name__ == "__main__":
    main()
