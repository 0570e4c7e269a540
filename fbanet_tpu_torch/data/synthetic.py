"""Synthetic RealBSR-style bursts and on-disk trees (counterpart of
fbanet_tpu/data/synthetic.py; the same generator draws, so the same seed
gives the same pixels in both packages).

`write_synthetic_realbsr` writes a tree in either filename grammar, through
`png.py`, so that a host with neither cv2 nor PIL can write one:
- "aligned": root/{train,test}/LR_aligned/{scene}_{patch}/{scene}_MFSR_Sony_
  {patch:04d}_x1_{frame:02d}.png and root/{train,test}/HR/{scene}_{patch}/
  {scene}_MFSR_Sony_{patch:04d}_x4.png;
- "warp": root/{scene}_{patch}/{scene}_MFSR_Sony_{patch:04d}_x4_{frame:02d}.png
  (LR) and ..._x4warp.png (HR).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from fbanet_tpu_torch.data import png


def smooth_image(rng: np.random.Generator, h: int, w: int, c: int = 3,
                 detail: int = 8) -> np.ndarray:
    """Band-limited random RGB image in [0,1] f32 (bilinear-upsampled noise
    plus a little high-frequency texture so alignment/SR are well-posed)."""
    base = rng.uniform(size=(max(2, h // detail), max(2, w // detail), c))
    ys = np.linspace(0, base.shape[0] - 1, h)
    xs = np.linspace(0, base.shape[1] - 1, w)
    y0 = np.floor(ys).astype(int).clip(0, base.shape[0] - 2)
    x0 = np.floor(xs).astype(int).clip(0, base.shape[1] - 2)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    img = ((base[y0][:, x0] * (1 - fx) + base[y0][:, x0 + 1] * fx) * (1 - fy)
           + (base[y0 + 1][:, x0] * (1 - fx) + base[y0 + 1][:, x0 + 1] * fx) * fy)
    img += 0.05 * rng.standard_normal((h, w, c))
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def _box_downsample(img: np.ndarray, scale: int) -> np.ndarray:
    h, w, c = img.shape
    return img.reshape(h // scale, scale, w // scale, scale, c).mean((1, 3))


def _translate(img: np.ndarray, dy: float, dx: float) -> np.ndarray:
    """Subpixel translation by bilinear resampling with edge clamping."""
    h, w, _ = img.shape
    ys = np.clip(np.arange(h) + dy, 0, h - 1)
    xs = np.clip(np.arange(w) + dx, 0, w - 1)
    y0 = np.floor(ys).astype(int).clip(0, h - 2)
    x0 = np.floor(xs).astype(int).clip(0, w - 2)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    return ((img[y0][:, x0] * (1 - fx) + img[y0][:, x0 + 1] * fx) * (1 - fy)
            + (img[y0 + 1][:, x0] * (1 - fx) + img[y0 + 1][:, x0 + 1] * fx) * fy)


def affine_sample(img: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """Inverse-map bilinear resample of `[H, W, C]` under a 3x3 matrix
    ((y, x) convention: source = M @ [y, x, 1]), edge-clamped. Numpy-only —
    the independent oracle for registration-quality tests (never uses the
    repo's own warp kernels)."""
    h, w, _ = img.shape
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    den = matrix[2, 0] * ys + matrix[2, 1] * xs + matrix[2, 2]
    sy = (matrix[0, 0] * ys + matrix[0, 1] * xs + matrix[0, 2]) / den
    sx = (matrix[1, 0] * ys + matrix[1, 1] * xs + matrix[1, 2]) / den
    sy = np.clip(sy, 0, h - 1)
    sx = np.clip(sx, 0, w - 1)
    y0 = np.floor(sy).astype(int).clip(0, h - 2)
    x0 = np.floor(sx).astype(int).clip(0, w - 2)
    fy = (sy - y0)[..., None]
    fx = (sx - x0)[..., None]
    return ((img[y0, x0] * (1 - fx) + img[y0, x0 + 1] * fx) * (1 - fy)
            + (img[y0 + 1, x0] * (1 - fx) + img[y0 + 1, x0 + 1] * fx) * fy
            ).astype(img.dtype)


def rotation_zoom_matrix(h: int, w: int, *, angle_deg: float = 0.0,
                         zoom: float = 1.0, dy: float = 0.0, dx: float = 0.0
                         ) -> np.ndarray:
    """3x3 inverse-map matrix ((y, x) convention) rotating by `angle_deg`
    and scaling by `zoom` about the image center, plus translation."""
    a = np.deg2rad(angle_deg)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    rot = np.array([[np.cos(a) / zoom, -np.sin(a) / zoom, 0.0],
                    [np.sin(a) / zoom, np.cos(a) / zoom, 0.0],
                    [0.0, 0.0, 1.0]])
    to_c = np.array([[1, 0, -cy], [0, 1, -cx], [0, 0, 1.0]])
    from_c = np.array([[1, 0, cy + dy], [0, 1, cx + dx], [0, 0, 1.0]])
    return from_c @ rot @ to_c


def synthetic_burst(
    rng: np.random.Generator,
    *,
    num_frames: int = 14,
    lr_size: int = 160,
    scale: int = 4,
    max_shift: float = 3.0,
    noise: float = 0.01,
    aligned: bool = True,
    channels: int = 3,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (lr_burst [F,h,w,C] f32, hr [H,W,C] f32, shifts [F,2] f32).

    `aligned=True` mimics the LR_aligned tree (all frames registered to
    frame 0 up to noise); `aligned=False` leaves the shifts in, for driving
    the registration stack. `channels=4` emits packed-Bayer-shaped data for
    the RealBSR-RAW variant.
    """
    hr = smooth_image(rng, lr_size * scale, lr_size * scale, c=channels)
    lr_ref = _box_downsample(hr, scale)
    frames, shifts = [], []
    for i in range(num_frames):
        if i == 0:
            dy = dx = 0.0
        else:
            dy, dx = rng.uniform(-max_shift, max_shift, size=2)
        frame = lr_ref if aligned else _translate(lr_ref, dy, dx)
        frame = np.clip(frame + noise * rng.standard_normal(frame.shape), 0, 1)
        frames.append(frame.astype(np.float32))
        shifts.append((dy, dx))
    return np.stack(frames), hr, np.asarray(shifts, np.float32)


def synthetic_batch(seed: int, batch: int, *, num_frames: int = 14,
                    lr_size: int = 160, scale: int = 4) -> dict[str, np.ndarray]:
    """In-memory batch {'LR': [B,F,h,w,3], 'HR': [B,H,W,3]} f32 in [0,1]."""
    rng = np.random.default_rng(seed)
    lrs, hrs = [], []
    for _ in range(batch):
        lr, hr, _ = synthetic_burst(rng, num_frames=num_frames,
                                    lr_size=lr_size, scale=scale)
        lrs.append(lr)
        hrs.append(hr)
    return {"LR": np.stack(lrs), "HR": np.stack(hrs)}


def _save_png(path: Path, img01: np.ndarray, level: int = 6) -> None:
    png.write_png(path, np.clip(img01 * 255.0 + 0.5, 0, 255).astype(np.uint8),
                  level)


def _save_png16_raw(path: Path, img01: np.ndarray, level: int = 6) -> None:
    """4-channel packed-Bayer f32 [0, 1] -> 16-bit PNG scaled by 16383 (the
    RealBSR-RAW storage format; channels in cv2's order, as the JAX
    package's cv2.imwrite writes them)."""
    png.write_png(path, np.clip(img01 * 16383.0 + 0.5, 0,
                                16383).astype(np.uint16), level)


def write_synthetic_realbsr(
    root: str | Path,
    *,
    num_bursts: int = 4,
    num_frames: int = 14,
    lr_size: int = 64,
    scale: int = 4,
    seed: int = 0,
    layout: str = "aligned",
    splits: tuple[str, ...] = ("train", "test"),
    write_hr: bool = True,
    channels: int = 3,
    noise: float = 0.01,
    aligned: bool = True,
    level: int = 6,
) -> Path:
    """Write a small synthetic dataset tree in the chosen filename grammar.

    `write_hr=False` writes a GT-free tree (LR frames only); `channels=4` a
    RealBSR-RAW-style tree of 16-bit packed-Bayer PNGs (/16383). `level` is
    zlib's compression level (1 writes fastest)."""
    root = Path(root)
    save = _save_png16_raw if channels == 4 else _save_png
    rng = np.random.default_rng(seed)
    for split in splits if layout == "aligned" else (None,):
        for b in range(num_bursts):
            lr, hr, _ = synthetic_burst(rng, num_frames=num_frames,
                                        lr_size=lr_size, scale=scale,
                                        channels=channels, noise=noise,
                                        aligned=aligned)
            scene, patch = b % 1000, b
            burst_name = f"{scene:03d}_{patch}"
            stem = f"{scene:03d}_MFSR_Sony_{patch:04d}"
            if layout == "aligned":
                lr_dir = root / split / "LR_aligned" / burst_name
                lr_dir.mkdir(parents=True, exist_ok=True)
                for f in range(num_frames):
                    save(lr_dir / f"{stem}_x1_{f:02d}.png", lr[f], level)
                if write_hr:
                    hr_dir = root / split / "HR" / burst_name
                    hr_dir.mkdir(parents=True, exist_ok=True)
                    save(hr_dir / f"{stem}_x4.png", hr, level)
            else:
                d = root / burst_name
                d.mkdir(parents=True, exist_ok=True)
                for f in range(num_frames):
                    save(d / f"{stem}_x{scale}_{f:02d}.png", lr[f], level)
                if write_hr:
                    save(d / f"{stem}_x{scale}warp.png", hr, level)
    return root
