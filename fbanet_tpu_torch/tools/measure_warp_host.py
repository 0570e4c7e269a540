"""K6's host path (`warp_burst_coords`) on the card: what one call costs the
host, piece by piece, beside `grid_sample`'s, at the two ECC pyramid sizes
where the card's work is a few microseconds (104 frames x S x S x 3,
S = 80 and 40, the published burst's non-reference frames).

    python fbanet_tpu_torch/tools/measure_warp_host.py [--iters 1000]

Per size, host µs per call (the host clock around `iters` calls issued
back to back, one synchronize after the clock stops): the whole wrapper,
`grid_sample` (the same positions, channels first), `torch.empty_like`,
the foreign call with its launch, and the two ways to the current
stream's handle: `torch._C._cuda_getCurrentRawStream` (the wrappers' way)
and `torch.cuda.current_stream(dev).cuda_stream`. First it checks that the
two handles agree, on the default stream and inside a side stream, and
that the wrapper agrees with its plain version (1e-4); raises otherwise.
Frames and positions (shifts of up to 4 px, some outside the frame) are
drawn on the device from fixed seeds. Prints one line per size and a JSON
line of the results; `main` returns them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as tf

if "fbanet_tpu_torch" not in sys.modules:  # run by its path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from fbanet_tpu_torch.ops import _build  # noqa: E402
from fbanet_tpu_torch.ops import warp_kernels as wk  # noqa: E402
from fbanet_tpu_torch.tools.measure_reduce import log  # noqa: E402

FRAMES, SIZES, TOL = 104, (80, 40), 1e-4


def host_us(fn, iters: int) -> float:
    """Host µs per call of `fn` issued `iters` times back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def stream_handles_agree() -> bool:
    """The raw handle equals the Stream object's, on the default stream
    and inside a side stream."""
    dev = torch.device("cuda", torch.cuda.current_device())

    def same():
        return (torch._C._cuda_getCurrentRawStream(dev.index)
                == torch.cuda.current_stream(dev).cuda_stream)

    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        in_side = same() and side.cuda_stream == _build.stream(
            torch.empty(1, device=dev))
    return same() and in_side


def case(size: int, seed: int):
    """(frames [F, S, S, 3], coords [F, S, S, 2]) on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    frames = torch.rand(FRAMES, size, size, 3, generator=gen, device="cuda")
    r = torch.arange(size, device="cuda", dtype=torch.float32)
    ys, xs = torch.meshgrid(r, r, indexing="ij")
    shift = (torch.rand(FRAMES, 1, 1, 2, generator=gen, device="cuda")
             * 8 - 4)
    return frames, torch.stack([ys, xs], -1) + shift


def sizes(iters: int = 1000) -> list[dict]:
    """One dict of host µs per piece (and the check's error) per size."""
    lib = _build.library()
    rows = []
    for i, s in enumerate(SIZES):
        fr, co = case(s, 900 + i)
        err = float((wk.warp_burst_coords(fr, co)
                     - wk.warp_burst_coords(fr, co, plain=True)).abs().max())
        if not err <= TOL:
            raise AssertionError(f"K6 at {s} px: {err:.3e} from its plain "
                                 f"version (limit {TOL})")
        inp = fr.permute(0, 3, 1, 2).contiguous()
        grid = torch.stack([2 * co[..., 1] / (s - 1) - 1,
                            2 * co[..., 0] / (s - 1) - 1], -1)
        out, stream, dev = torch.empty_like(fr), _build.stream(fr), fr.device
        pieces = {
            "wrapper": lambda: wk.warp_burst_coords(fr, co),
            "grid_sample": lambda: tf.grid_sample(
                inp, grid, mode="bilinear", padding_mode="border",
                align_corners=True),
            "empty_like": lambda: torch.empty_like(fr),
            "foreign_call": lambda: lib.fbanet_warp_coords(
                fr.data_ptr(), co.data_ptr(), out.data_ptr(), *fr.shape,
                False, 0.0, stream),
            "stream_raw": lambda: torch._C._cuda_getCurrentRawStream(
                dev.index),
            "stream_object": lambda: torch.cuda.current_stream(
                dev).cuda_stream,
        }
        row = dict(size=s, max_abs_err=err,
                   **{k: host_us(fn, iters) for k, fn in pieces.items()})
        log(f"K6 host us per call at {FRAMES}x{s}x{s}x3: " + " ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()))
        rows.append(row)
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=1000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("measure_warp_host: no CUDA device")
    if not stream_handles_agree():
        raise AssertionError("the raw stream handle differs from the "
                             "Stream object's")
    res = {"stream_handles_agree": True, "sizes": sizes(args.iters),
           "device": torch.cuda.get_device_name(0)}
    log(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
