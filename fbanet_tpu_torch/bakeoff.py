"""Registration bake-off: compare alignment methods on real or synthetic
frames (counterpart of fbanet_tpu/bakeoff.py, itself the equivalent of the
reference's sintel_pipeline.py harness, fba_net/sintel_pipeline.py:48-78).

    python -m fbanet_tpu_torch.bakeoff --synthetic [--markdown FILE]
    python -m fbanet_tpu_torch.bakeoff --frames DIR [--ref 0]
        [--device cpu]

Every contender is the port's own: dense pyramidal Lucas-Kanade flow and a
backward warp (`ops/flow.py`, `ops/warp.py::warp_flow`), and ECC with
translation / euclidean / similarity / affine / homography motion
(`ops/registration.py::ecc_align`, 3 levels x 30 iterations) with
`ops/warp.py::warp_burst_homography`. Both warps are the plain per-tap
ones, as the JAX package's `use_pallas=False` default is. Each method runs
twice on a frame: the first call warms up (the JAX package's compile), the
second is timed on the host clock between `torch.cuda.synchronize()` calls
(on the card). PSNR / SSIM on the central crop (8 px off each side) after
registering each frame onto the reference frame.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from fbanet_tpu_torch.metrics import psnr, ssim
from fbanet_tpu_torch.ops.flow import optical_flow
from fbanet_tpu_torch.ops.registration import ecc_align, rgb_to_gray
from fbanet_tpu_torch.ops.warp import warp_burst_homography, warp_flow
from fbanet_tpu_torch.train import resolve_device

METHODS = ("flow", "translation", "euclidean", "similarity", "affine",
           "homography")


def _metrics(a: torch.Tensor, b: torch.Tensor, crop: int = 8
             ) -> tuple[float, float]:
    aa = a[None, crop:-crop, crop:-crop, :]
    bb = b[None, crop:-crop, crop:-crop, :]
    return float(psnr(aa, bb)[0]), float(ssim(aa, bb)[0])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def compare_registrations(reference: np.ndarray, frame: np.ndarray, *,
                          methods: tuple[str, ...] = METHODS,
                          device: torch.device | str = "cuda"
                          ) -> dict[str, dict]:
    """Register `frame` onto `reference` (both [H, W, C] f32 in [0, 1]) with
    every method on `device`: {method: {psnr, ssim, seconds}}, with the
    unaligned pair as "unaligned"."""
    device = resolve_device(device, "compare_registrations")
    ref = torch.from_numpy(np.ascontiguousarray(reference)).float().to(device)
    frm = torch.from_numpy(np.ascontiguousarray(frame)).float().to(device)
    p0, s0 = _metrics(ref, frm)
    results = {"unaligned": {"psnr": p0, "ssim": s0, "seconds": 0.0}}
    gray_ref, gray_frame = rgb_to_gray(ref), rgb_to_gray(frm)

    for method in methods:
        def run():
            if method == "flow":
                fl = optical_flow(gray_ref, gray_frame, levels=4,
                                  iters_per_level=6)
                return warp_flow(frm, fl)
            mat, _rho = ecc_align(gray_ref, gray_frame, motion=method,
                                  levels=3, iters_per_level=30)
            return warp_burst_homography(frm[None], mat[None])[0]

        run()  # the first call warms up
        _sync(device)
        t0 = time.perf_counter()
        warped = run()
        _sync(device)
        dt = time.perf_counter() - t0
        p, s = _metrics(ref, warped)
        results[method] = {"psnr": p, "ssim": s, "seconds": dt}
    return results


def run_bakeoff(frames: list[np.ndarray], ref_index: int = 0, *,
                device: torch.device | str = "cuda"
                ) -> dict[str, dict[str, float]]:
    """Register every frame onto frames[ref_index] with every method;
    {method: {psnr, ssim, seconds}} averaged over the frames."""
    reference = frames[ref_index]
    print(f"{'method':>12s} {'PSNR':>8s} {'SSIM':>7s} {'sec':>7s}")
    agg: dict[str, list[dict]] = {}
    for i, frame in enumerate(frames):
        if i == ref_index:
            continue
        res = compare_registrations(reference, frame, device=device)
        print(f"--- frame {i} vs {ref_index}")
        for name, m in res.items():
            print(f"{name:>12s} {m['psnr']:8.3f} {m['ssim']:7.4f} "
                  f"{m['seconds']:7.3f}")
            agg.setdefault(name, []).append(m)
    print("--- mean PSNR")
    out = {}
    for name, ms in agg.items():
        out[name] = {k: float(np.mean([m[k] for m in ms]))
                     for k in ("psnr", "ssim", "seconds")}
        print(f"{name:>12s} {out[name]['psnr']:8.3f}")
    return out


def synthetic_scene(motion: str, seed: int = 0, size: int = 160,
                    num_frames: int = 4) -> list[np.ndarray]:
    """Frames under a named motion ("translation", "rotation", "zoom"),
    resampled in numpy (independent of the port's warps); the same draws
    as the JAX package's."""
    from fbanet_tpu_torch.data.synthetic import (
        affine_sample,
        rotation_zoom_matrix,
        smooth_image,
        synthetic_burst,
    )

    rng = np.random.default_rng(seed)
    if motion == "translation":
        lr, _hr, _ = synthetic_burst(rng, num_frames=num_frames, lr_size=size,
                                     aligned=False, max_shift=4.0)
        return list(lr)
    ref = smooth_image(rng, size, size)
    frames = [ref]
    for _ in range(num_frames - 1):
        if motion == "rotation":
            m = rotation_zoom_matrix(size, size,
                                     angle_deg=float(rng.uniform(-3, 3)),
                                     dy=float(rng.uniform(-2, 2)),
                                     dx=float(rng.uniform(-2, 2)))
        elif motion == "zoom":
            m = rotation_zoom_matrix(size, size,
                                     zoom=float(rng.uniform(0.96, 1.04)),
                                     dy=float(rng.uniform(-2, 2)),
                                     dx=float(rng.uniform(-2, 2)))
        else:
            raise ValueError(f"unknown motion {motion}")
        f = affine_sample(ref, m)
        f = np.clip(f + 0.01 * rng.standard_normal(f.shape), 0, 1)
        frames.append(f.astype(np.float32))
    return frames


def write_markdown(results: dict[str, dict[str, dict[str, float]]],
                   path: str | Path, *, device_name: str = "") -> None:
    """{scene: {method: metrics}} -> a markdown table per scene."""
    lines = [
        "# Registration bake-off (synthetic scenes)",
        "",
        "Produced by `python -m fbanet_tpu_torch.bakeoff --synthetic "
        f"--markdown {Path(path).name}`"
        + (f" on {device_name}" if device_name else "") + ". Frames are "
        "numpy-resampled ground-truth motions (independent of the port's "
        "warps). PSNR / SSIM on the central crop after registering each "
        "frame onto frame 0; seconds are per frame, host clock around "
        "synchronised work, after a warm-up call.",
        "",
    ]
    for scene, methods in results.items():
        lines += [f"## {scene}", "",
                  "| method | PSNR (dB) | SSIM | sec/frame |",
                  "|---|---|---|---|"]
        for name, m in methods.items():
            lines.append(f"| {name} | {m['psnr']:.3f} | {m['ssim']:.4f} | "
                         f"{m['seconds']:.3f} |")
        lines.append("")
    Path(path).write_text("\n".join(lines))
    print(f"wrote {path}")


def main(argv: list[str] | None = None) -> dict:
    """Returns {scene: {method: metrics}} ({"frames": ...} for --frames)."""
    p = argparse.ArgumentParser(description="registration bake-off "
                                "(PyTorch port)")
    p.add_argument("--frames", type=str, default="",
                   help="directory of frames (png), lexicographic order")
    p.add_argument("--ref", type=int, default=0)
    p.add_argument("--synthetic", action="store_true",
                   help="run on generated frames (no data needed)")
    p.add_argument("--markdown", type=str, default="",
                   help="also write the aggregated table to this .md file")
    p.add_argument("--size", type=int, default=160)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a CUDA device) "
                        "or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device, "bakeoff")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "the CPU")

    if args.synthetic or not args.frames:
        results = {}
        for motion in ("translation", "rotation", "zoom"):
            print(f"===== scene: {motion} =====")
            results[motion] = run_bakeoff(
                synthetic_scene(motion, size=args.size), 0, device=device)
    else:
        from fbanet_tpu_torch.data.realbsr import decode_png

        paths = sorted(Path(args.frames).glob("*.png"))
        frames = [decode_png(q).astype(np.float32) / 255.0 for q in paths]
        results = {"frames": run_bakeoff(frames, args.ref, device=device)}
    if args.markdown:
        write_markdown(results, args.markdown, device_name=name)
    return results


if __name__ == "__main__":
    main()
