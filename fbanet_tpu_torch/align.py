"""Offline burst alignment CLI (counterpart of fbanet_tpu/align.py).

    python -m fbanet_tpu_torch.align --input_dir LR --output_dir LR_aligned \
        [--motion homography] [--device cpu]

Each burst directory's frames are registered to frame 00 in one
`align_burst` call on the card, through `align_stream`, which overlaps the
host's work with the card's: while the card aligns burst N, the host
produces burst N+1 (here: decodes its PNGs) and then takes back burst N-1
(here: encodes it). The aligned frames come back through a pinned copy
queued right behind each burst's work and waited on by a CUDA event, so
taking back burst N-1 never waits for burst N. With `--eps > 0` every ECC
iteration reads a flag back to stop early, so the host waits inside
`align_burst` and overlaps less.

Semantics, as in the JAX CLI and the reference's homography_alignment.py:
frame 00 passes through untouched; a frame whose registration fails is
written unaligned (the identity fallback of `ecc_align`); `--parity` runs
the reference's cv2 TermCriteria (one level, 100 iterations, eps 1e-10);
the output tree mirrors the input.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

# The reference's cv2.findTransformECC TermCriteria
# (fba_net/homography_alignment.py:38-44).
PARITY_LEVELS = 1
PARITY_ITERS = 100
PARITY_EPS = 1e-10


def _burst_files(burst_dir: Path) -> list[Path]:
    """Frame-numbered LR PNGs of one burst directory (HR files skipped)."""
    from fbanet_tpu_torch.data.realbsr import WARP_PATTERN

    files = []
    for f in sorted(burst_dir.iterdir()):
        m = WARP_PATTERN.match(f.name)
        if m is not None and m["frame"] is None:
            continue  # HR frame
        if f.suffix.lower() == ".png":
            files.append(f)
    return files


def align_stream(bursts, on_aligned, *, motion: str = "translation",
                 levels: int = 3, iters_per_level: int = 25, eps: float = 0.0,
                 overlap: bool = True, device: str = "cuda") -> int:
    """Align each `(key, frames)` of the iterable `bursts` (frames `[F, H, W,
    C]` float32 numpy in [0, 1]) to its frame 0 on `device`, and call
    `on_aligned(key, frames, aligned, rhos, seconds)` with the aligned numpy
    frames, burst by burst in order. `bursts` is drawn lazily: burst N+1 is
    drawn while burst N is queued on the card, and burst N is handed back
    after that. `overlap=False` hands each burst back before drawing the
    next. Returns the number of bursts aligned."""
    from fbanet_tpu_torch.ops.registration import align_burst

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("align_tree: no CUDA device; pass device='cpu' "
                           "(--device cpu) to align on the CPU")

    @torch.no_grad()
    def dispatch(key, frames):
        """Queue the burst's alignment and the copy of its result back."""
        t0 = time.perf_counter()
        aligned, _m, rhos = align_burst(
            torch.from_numpy(frames).to(dev), motion=motion, levels=levels,
            iters_per_level=iters_per_level, eps=eps)
        # from the card, a non-blocking copy lands in pinned host memory
        aligned = aligned.to("cpu", non_blocking=True)
        rhos = rhos.to("cpu", non_blocking=True)
        ready = None
        if dev.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        return key, frames, aligned, rhos, ready, t0

    def finalize(pending) -> None:
        """Wait for the burst's copy and hand it back."""
        key, frames, aligned, rhos, ready, t0 = pending
        if ready is not None:
            ready.synchronize()
        on_aligned(key, frames, aligned.numpy(), rhos.numpy(),
                   time.perf_counter() - t0)

    done = 0
    pending = None  # the previous burst, in flight on the card
    for key, frames in bursts:  # drawing burst N overlaps N-1 on the card
        current = dispatch(key, frames)
        if pending is not None:
            finalize(pending)  # N-1 handed back while N runs on the card
        pending = current
        if not overlap:
            finalize(pending)
            pending = None
        done += 1
    if pending is not None:
        finalize(pending)
    return done


def align_tree(input_dir: str | Path, output_dir: str | Path, *,
               motion: str = "translation", levels: int = 3,
               iters_per_level: int = 25, eps: float = 0.0,
               report_metrics: bool = True, overlap: bool = True,
               device: str = "cuda") -> int:
    """Align every burst directory under `input_dir` into the same layout
    under `output_dir`; returns the number of bursts aligned.
    `overlap=False` runs decode -> align -> encode serially."""
    from PIL import Image

    from fbanet_tpu_torch.data.realbsr import decode_png
    from fbanet_tpu_torch.metrics import psnr

    input_dir, output_dir = Path(input_dir), Path(output_dir)
    burst_dirs = sorted(p for p in input_dir.iterdir() if p.is_dir())

    def decoded():
        for burst_dir in burst_dirs:
            files = _burst_files(burst_dir)
            if len(files) < 2:
                print(f"skip {burst_dir.name}: <2 frames", file=sys.stderr)
                continue
            frames = np.stack([decode_png(f) for f in files])
            yield (burst_dir, files), frames.astype(np.float32) / 255.0

    def encode(key, frames, aligned, rhos, dt) -> None:
        """PNG-encode the aligned burst and report its metrics."""
        burst_dir, files = key
        out_b = output_dir / burst_dir.name
        out_b.mkdir(parents=True, exist_ok=True)
        for f, img in zip(files, aligned):
            arr = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
            Image.fromarray(arr).save(out_b / f.name)
        if report_metrics:
            # before/after PSNR against frame 0, the reference's diagnostic
            # (homography_alignment.py:60-62)
            ref = torch.from_numpy(frames[:1])
            before = np.nanmean(psnr(torch.from_numpy(frames[1:]), ref).numpy())
            after = np.nanmean(psnr(torch.from_numpy(aligned[1:]), ref).numpy())
            print(f"{burst_dir.name}: {len(files)} frames in {dt:.3f}s  "
                  f"PSNR vs ref {before:.2f} -> {after:.2f} dB  "
                  f"min rho {float(rhos.min()):.4f}", file=sys.stderr)

    return align_stream(decoded(), encode, motion=motion, levels=levels,
                        iters_per_level=iters_per_level, eps=eps,
                        overlap=overlap, device=device)


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="burst alignment on the GPU")
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--motion", default="translation",
                   choices=["translation", "euclidean", "affine",
                            "homography"])
    p.add_argument("--levels", type=int, default=3)
    p.add_argument("--iters", type=int, default=25)
    p.add_argument("--eps", type=float, default=0.0,
                   help="ECC termination on the correlation increment "
                        "(cv2 TermCriteria eps; the reference uses 1e-10). "
                        "0 = fixed iteration count")
    p.add_argument("--parity", action="store_true",
                   help="use the reference's exact ECC settings (single "
                        "level, 100 iters, eps 1e-10; overrides "
                        "--levels/--iters/--eps)")
    p.add_argument("--no_overlap", action="store_true",
                   help="serial decode->align->encode")
    p.add_argument("--device", default="cuda",
                   help="torch device to align on (default cuda; cpu for a "
                        "machine without a GPU)")
    args = p.parse_args(argv)
    levels, iters, eps = args.levels, args.iters, args.eps
    if args.parity:
        levels, iters, eps = PARITY_LEVELS, PARITY_ITERS, PARITY_EPS
    n = align_tree(args.input_dir, args.output_dir, motion=args.motion,
                   levels=levels, iters_per_level=iters, eps=eps,
                   overlap=not args.no_overlap, device=args.device)
    print(f"aligned {n} bursts -> {args.output_dir}")


if __name__ == "__main__":
    main()
