"""Transform accuracy of the port's ECC against cv2.findTransformECC
(counterpart of scripts/align_parity_table.py).

    python -m fbanet_tpu_torch.tools.align_parity_table [--n 24 --size 160]
        [--device cpu]

The alignment CLI ships 3 levels x 25 iterations at eps 0, the reference
one level x 100 iterations at eps 1e-10 (fba_net/homography_alignment.py:
38-44). This tool builds `--n` smooth frames (bicubic upsampling of a
1/8-size uniform grid) and a copy of each moved by a known subpixel
translation in [-3, 3) px, warped by the port's own bilinear warp so the
truth is exact, and recovers each shift three ways on the same pixels:

  ours-default : ecc_align, levels 3, iterations 25, eps 0 (align.py)
  ours-parity  : ecc_align, levels 1, iterations 100, eps 1e-10 (--parity)
  cv2-reference: cv2.findTransformECC, MOTION_TRANSLATION, (100, 1e-10)

and prints the mean and max |recovered - true| in px. Our ECC runs on
`--device` (all frames in one call); cv2 runs on the host and needs
opencv-python. An accuracy table, not a timing. `main` returns {method:
(mean px, max px, frames)}.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F


def smooth_image(h: int, w: int, seed: int) -> np.ndarray:
    """[h, w] f32: a uniform (h/8, w/8) grid upsampled bicubically."""
    rng = np.random.default_rng(seed)
    small = torch.from_numpy(rng.uniform(size=(h // 8, w // 8)).astype(
        np.float32))
    return F.interpolate(small[None, None], size=(h, w), mode="bicubic",
                         align_corners=False)[0, 0].numpy()


def main(argv: list[str] | None = None) -> dict[str, tuple]:
    import cv2

    from fbanet_tpu_torch.align import PARITY_EPS, PARITY_ITERS, PARITY_LEVELS
    from fbanet_tpu_torch.ops.registration import ecc_align
    from fbanet_tpu_torch.ops.warp import warp_burst_homography
    from fbanet_tpu_torch.train import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=24)
    p.add_argument("--size", type=int, default=160)
    p.add_argument("--device", default="cuda",
                   help="where our ECC runs: cuda (the default; raises "
                        "without one) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device, "align_parity_table")
    n, size = args.n, args.size
    rng = np.random.default_rng(42)
    imgs = np.stack([smooth_image(size, size, seed=i) for i in range(n)])
    shifts = rng.uniform(-3.0, 3.0, size=(n, 2)).astype(np.float32)
    mats = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    mats[:, :2, 2] = shifts
    with torch.no_grad():
        moved = warp_burst_homography(
            torch.from_numpy(imgs)[..., None],
            torch.from_numpy(mats))[..., 0].numpy()
    # the aligning translation is the inverse of the forward warp
    true = -shifts

    errs: dict[str, list] = {"ours-default": [], "ours-parity": [],
                             "cv2-reference": []}
    tmpl = torch.from_numpy(imgs).to(device)
    image = torch.from_numpy(moved).to(device)
    for key, levels, iters, eps in (
            ("ours-default", 3, 25, 0.0),
            ("ours-parity", PARITY_LEVELS, PARITY_ITERS, PARITY_EPS)):
        with torch.no_grad():
            m, _ = ecc_align(tmpl, image, motion="translation", levels=levels,
                             iters_per_level=iters, eps=eps)
        errs[key] = list(np.abs(m[:, :2, 2].cpu().numpy() - true))
    for i in range(n):
        warp = np.eye(2, 3, dtype=np.float32)
        try:
            _, warp = cv2.findTransformECC(
                imgs[i], moved[i], warp, cv2.MOTION_TRANSLATION,
                (cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 100, 1e-10))
            errs["cv2-reference"].append(np.abs(warp[:2, 2] - true[i]))
        except cv2.error:
            print(f"frame {i}: cv2 did not converge", file=sys.stderr)

    out = {}
    print("| method | mean err (px) | max err (px) | n |")
    print("|---|---|---|---|")
    for k, v in errs.items():
        v = np.concatenate(v)
        out[k] = (float(v.mean()), float(v.max()), len(v) // 2)
        print(f"| {k} | {v.mean():.4f} | {v.max():.4f} | {len(v) // 2} |")
    return out


if __name__ == "__main__":
    main()
