"""Image warping, plain PyTorch (counterpart of fbanet_tpu/ops/warp.py).

Everything is channels-last and runs in f32; the gathers index `[H, W, C]`
images by (row, column), so each tap reads C neighbouring values.

Conventions, as in the JAX package:
- Coordinates are `(y, x)` pixel centres; `coords[..., 0]` is the source row.
- A warp matrix maps *output* pixel coordinates `(x, y, 1)` to *source*
  coordinates (OpenCV's WARP_INVERSE_MAP).
- `mode="nearest"` clamps each tap into the image; `mode="constant"` gives
  every tap outside the image the value `cval` and blends, per tap, like
  cv2's BORDER_CONSTANT.

The hot bilinear cases have CUDA kernels in `ops/warp_kernels.py`, which
`registration.align_burst` calls directly. Those compute the TPU kernels'
function, whose constant mode masks whole pixels instead of blending per
tap, so nothing in this module goes to them.
"""

from __future__ import annotations

import torch

_A = -0.75  # Keys cubic coefficient, OpenCV's INTER_CUBIC


def _pad_affine(matrices: torch.Tensor) -> torch.Tensor:
    """[..., 2, 3] -> [..., 3, 3] with a last row (0, 0, 1); 3x3 unchanged."""
    matrices = matrices.float()
    if matrices.shape[-2:] == (2, 3):
        row = torch.tensor([0.0, 0.0, 1.0], device=matrices.device)
        row = row.expand(*matrices.shape[:-2], 1, 3)
        matrices = torch.cat([matrices, row], -2)
    return matrices


def homography_coords(matrix: torch.Tensor, height: int, width: int
                      ) -> torch.Tensor:
    """Source coordinates `[..., H, W, 2]` (y, x) of a `[..., 3, 3]` (or
    `[..., 2, 3]`) warp over an output grid: `[x_src, y_src, w] = M @
    [x, y, 1]`, divided by w, with |w| < 1e-12 replaced by 1e-12."""
    m = _pad_affine(matrix)[..., None, None, :, :]
    dev = m.device
    ys = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    sx = m[..., 0, 0] * xs + m[..., 0, 1] * ys + m[..., 0, 2]
    sy = m[..., 1, 0] * xs + m[..., 1, 1] * ys + m[..., 1, 2]
    sw = m[..., 2, 0] * xs + m[..., 2, 1] * ys + m[..., 2, 2]
    denom = torch.where(sw.abs() < 1e-12, torch.full_like(sw, 1e-12), sw)
    return torch.stack([sy / denom, sx / denom], -1)


def _cubic_weights(t: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Keys cubic weights (a = -0.75) of the taps at offsets -1, 0, 1, 2
    from the floor cell."""
    t2, t3 = t * t, t * t * t
    w0 = _A * (t3 - 2 * t2 + t)
    w1 = (_A + 2) * t3 - (_A + 3) * t2 + 1
    w2 = -(_A + 2) * t3 + (2 * _A + 3) * t2 - _A * t
    w3 = _A * (t2 - t3)
    return w0, w1, w2, w3


def warp_image(image: torch.Tensor, coords: torch.Tensor, *,
               interp: str = "bilinear", mode: str = "nearest",
               cval: float = 0.0) -> torch.Tensor:
    """Sample `image` `[..., H, W, C]` at `coords` `[..., Ho, Wo, 2]` ->
    `[..., Ho, Wo, C]` (the leading dimensions of the two match). Taps are
    clamped into the image; in constant mode a tap outside it reads `cval`.
    A floating image keeps its dtype."""
    h, w, c = image.shape[-3:]
    lead = image.shape[:-3]
    img = image.float().reshape(-1, h * w, c)
    cy = coords[..., 0].float().reshape(img.shape[0], -1)
    cx = coords[..., 1].float().reshape(img.shape[0], -1)
    out_hw = coords.shape[-3:-1]

    def tap(yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = torch.gather(img, 1, idx[..., None].expand(-1, -1, c))
        if mode == "constant":
            inside = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
            vals = torch.where(inside, vals, torch.full_like(vals, cval))
        return vals

    if interp == "nearest":
        out = tap(torch.round(cy).long(), torch.round(cx).long())
    elif interp == "bilinear":
        y0, x0 = torch.floor(cy), torch.floor(cx)
        fy, fx = (cy - y0)[..., None], (cx - x0)[..., None]
        y0, x0 = y0.long(), x0.long()
        top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
        bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
        out = top * (1 - fy) + bot * fy
    elif interp == "bicubic":
        y0, x0 = torch.floor(cy), torch.floor(cx)
        wy = _cubic_weights((cy - y0)[..., None])
        wx = _cubic_weights((cx - x0)[..., None])
        y0, x0 = y0.long(), x0.long()
        out = 0
        for i, wyi in enumerate(wy):
            row = 0
            for j, wxj in enumerate(wx):
                row = row + wxj * tap(y0 + i - 1, x0 + j - 1)
            out = out + wyi * row
    else:
        raise ValueError(f"unknown interp {interp}")
    out = out.reshape(*lead, *out_hw, c)
    return out.to(image.dtype) if image.is_floating_point() else out


def warp_flow(frame: torch.Tensor, flow: torch.Tensor, *,
              interp: str = "bilinear", mode: str = "nearest"
              ) -> torch.Tensor:
    """Backward-warp `frame` `[..., H, W, C]` by a dense flow `[..., H, W, 2]`
    (x, y displacement): sample at `grid - flow`."""
    h, w = frame.shape[-3:-1]
    dev = frame.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    coords = torch.stack([ys - flow[..., 1], xs - flow[..., 0]], -1)
    return warp_image(frame, coords, interp=interp, mode=mode)


def warp_burst_homography(frames: torch.Tensor, matrices: torch.Tensor, *,
                          interp: str = "bilinear", mode: str = "nearest"
                          ) -> torch.Tensor:
    """Warp `[..., F, H, W, C]` frames by per-frame matrices `[..., F, 3, 3]`
    (or `[..., F, 2, 3]`)."""
    h, w = frames.shape[-3:-1]
    return warp_image(frames, homography_coords(matrices, h, w),
                      interp=interp, mode=mode)
