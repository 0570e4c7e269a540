"""The alignment CLI's overlap of host and card work, on a tree on disk
(counterpart of scripts/measure_align_overlap.py).

    python -m fbanet_tpu_torch.tools.measure_align_overlap [--bursts 24
        --frames 14 --size 160 --reps 2] [--device cpu]

Writes a synthetic tree of `--bursts` GT-free bursts in the "warp" layout
(`data/synthetic.py`, through `png.py`) into a temporary directory, then
runs `align.py::align_tree` (translation, 3 levels x 25 iterations, eps 0,
the CLI's defaults) serially (`--no_overlap`: decode, align, encode one
burst at a time) and pipelined (the card aligns burst N while the host
decodes N+1 and encodes N-1), alternating, `--reps` times each. The first
run's decode also warms the file cache, so every read after it is warm.
Host clock (`time.perf_counter`) around each whole run. The gain to expect
is the card's time per burst hidden under the host's PNG work; the host
work itself runs on one thread either way.

`main` returns {"serial": [s, ...], "pipelined": [s, ...], "bursts": n}.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import torch


def main(argv: list[str] | None = None) -> dict:
    from fbanet_tpu_torch.align import align_tree
    from fbanet_tpu_torch.data.realbsr import file_decoder
    from fbanet_tpu_torch.data.synthetic import write_synthetic_realbsr
    from fbanet_tpu_torch.train import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bursts", type=int, default=24)
    p.add_argument("--frames", type=int, default=14)
    p.add_argument("--size", type=int, default=160)
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without one) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device, "measure_align_overlap")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {name}; PNG decoder {file_decoder(3)!r}",
          file=sys.stderr)

    times: dict = {"serial": [], "pipelined": [], "bursts": args.bursts}
    with tempfile.TemporaryDirectory() as td:
        root = Path(td)
        tree = root / "in"
        write_synthetic_realbsr(tree, num_bursts=args.bursts,
                                num_frames=args.frames, lr_size=args.size,
                                layout="warp", write_hr=False)
        for rep in range(args.reps):
            for tag, overlap in (("serial", False), ("pipelined", True)):
                t0 = time.perf_counter()
                n = align_tree(tree, root / f"out_{tag}_{rep}",
                               motion="translation", levels=3,
                               iters_per_level=25, report_metrics=False,
                               overlap=overlap, device=str(device))
                dt = time.perf_counter() - t0
                if n != args.bursts:
                    raise AssertionError(f"aligned {n} of {args.bursts}")
                times[tag].append(dt)
                print(f"rep{rep} {tag}: {dt:.3f} s ({n / dt:.2f} bursts/s)",
                      file=sys.stderr)

    s, q = min(times["serial"]), min(times["pipelined"])
    n = args.bursts
    print(f"| mode | best of {args.reps} ({n} bursts) | bursts/s |")
    print("|---|---|---|")
    print(f"| serial | {s:.3f} s | {n / s:.2f} |")
    print(f"| pipelined | {q:.3f} s | {n / q:.2f} |")
    print(f"overlap speedup: {s / q:.3f}x")
    return times


if __name__ == "__main__":
    main()
