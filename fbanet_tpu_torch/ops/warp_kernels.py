"""K5 and K6, the bilinear burst warps, as CUDA kernels (`csrc/warp.cu`),
with their plain PyTorch versions beside them.

- `warp_burst_bilinear(frames, matrices)` (K5, replaces
  fbanet_tpu/ops/warp_pallas.py::_homography_kernel): every pixel's source
  position through its frame's 3x3 inverse-map matrix, then a bilinear
  sample of every channel. The final warp of `align_burst` for the
  non-translation motions.
- `warp_burst_coords(frames, coords)` (K6, replaces `_coords_kernel`): the
  same sample at given dense `(y, x)` positions. The per-iteration warp of
  the `[image, gx, gy]` stack in the ECC loop.

Both compute the TPU kernels' function, which differs from
`warp.warp_image` in three places: the position is clamped into the image
first and the cell after (`cyc = clip(cy, 0, h-1)`, `y0 = clip(int(cyc), 0,
h-2)`, `fy = cyc - y0`); constant mode replaces a whole pixel whose
unclamped position lies outside `[0, h-1] x [0, w-1]` by `cval` instead of
blending per tap; and K5 replaces a projective divisor |w| < 1e-12 by
1e-12. In nearest mode the sample equals `warp_image`'s bilinear one up to
rounding. The TPU kernels' one-hot matrix products, their hi/lo bf16 split
of the image and their approximate reciprocal are TPU workarounds, not
part of the function: the CUDA kernels read f32 and divide in full f32.

Frames are `[F, H, W, C]` (any float dtype, sampled in f32, returned in
their dtype), H and W at least 2. Launch or raise on CUDA; on the CPU, or
with `plain=True`, the plain versions. Each wrapper counts its kernel
launches in `.launches`.
"""

from __future__ import annotations

import torch

from fbanet_tpu_torch.ops import _build
from fbanet_tpu_torch.ops.warp import homography_coords

_MODES = ("nearest", "constant")


def _stream(t: torch.Tensor) -> int:
    """The current stream's handle, straight from torch's C binding (as
    `ops.reduce` takes it): `torch.cuda.current_stream(dev).cuda_stream`
    builds a Python Stream object per call, which K6's 75 calls per align
    pay for at sizes where the card needs only a few microseconds."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def sample_plain(frames: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor,
                 constant: bool, cval: float) -> torch.Tensor:
    """The kernels' sample: f32 `frames` [F, H, W, C] at `cy`, `cx`
    [F, Ho, Wo] -> f32 [F, Ho, Wo, C]."""
    f, h, w, c = frames.shape
    cyc, cxc = cy.clamp(0.0, h - 1.0), cx.clamp(0.0, w - 1.0)
    y0 = cyc.long().clamp(0, h - 2)
    x0 = cxc.long().clamp(0, w - 2)
    fy, fx = (cyc - y0)[..., None], (cxc - x0)[..., None]
    flat = frames.reshape(f, h * w, c)

    def tap(yi, xi):
        idx = (yi * w + xi).reshape(f, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(*yi.shape, c)

    # rows first, then columns, as the TPU kernel blends
    left = tap(y0, x0) * (1.0 - fy) + tap(y0 + 1, x0) * fy
    right = tap(y0, x0 + 1) * (1.0 - fy) + tap(y0 + 1, x0 + 1) * fy
    out = left * (1.0 - fx) + right * fx
    if constant:
        inside = ((cy >= 0.0) & (cy <= h - 1.0)
                  & (cx >= 0.0) & (cx <= w - 1.0))[..., None]
        out = torch.where(inside, out, torch.full_like(out, cval))
    return out


def _check(name: str, frames: torch.Tensor, other: torch.Tensor,
           other_shape: tuple, mode: str) -> None:
    if mode not in _MODES:
        raise ValueError(f"{name}: unknown mode {mode!r}")
    if (frames.dim() != 4 or frames.shape[1] < 2 or frames.shape[2] < 2
            or not frames.is_floating_point()
            or tuple(other.shape) != other_shape):
        raise ValueError(
            f"{name} does not take frames {tuple(frames.shape)} "
            f"{frames.dtype} with {tuple(other.shape)}: frames [F, H, W, C] "
            f"floating point with H, W >= 2, and {other_shape}")


def _launch_ready(name: str, frames: torch.Tensor, other: torch.Tensor
                  ) -> None:
    if frames.device.type != "cuda" or other.device != frames.device:
        raise ValueError(f"{name} kernel takes CUDA tensors on one device, "
                         f"got {frames.device} and {other.device}")


def warp_burst_bilinear(frames: torch.Tensor, matrices: torch.Tensor, *,
                        mode: str = "nearest", cval: float = 0.0,
                        plain: bool = False) -> torch.Tensor:
    """K5: warp `frames` [F, H, W, C] by inverse-map `matrices` [F, 3, 3]
    with the TPU kernel's bilinear sample."""
    _check("warp_burst_bilinear", frames, matrices,
           (*frames.shape[:1], 3, 3), mode)
    f, h, w, c = frames.shape
    fr, mats = frames.float(), matrices.float()
    if plain or frames.device.type == "cpu":
        co = homography_coords(mats, h, w)
        out = sample_plain(fr, co[..., 0], co[..., 1], mode == "constant",
                           cval)
        return out.to(frames.dtype)
    _launch_ready("warp_burst_bilinear", frames, matrices)
    fr, mats = fr.contiguous(), mats.contiguous()
    out = torch.empty_like(fr)
    err = _build.library().fbanet_warp_homography(
        fr.data_ptr(), mats.data_ptr(), out.data_ptr(), f, h, w, c,
        int(mode == "constant"), float(cval), _stream(fr))
    _build.check(err, "warp_burst_bilinear")
    warp_burst_bilinear.launches += 1
    return out.to(frames.dtype)


warp_burst_bilinear.launches = 0


def warp_burst_coords(frames: torch.Tensor, coords: torch.Tensor, *,
                      mode: str = "nearest", cval: float = 0.0,
                      plain: bool = False) -> torch.Tensor:
    """K6: sample `frames` [F, H, W, C] at `coords` [F, H, W, 2] ((y, x)
    source positions) with the TPU kernel's bilinear sample.

    K6 runs 75 times per align, on inputs the card warps in a few
    microseconds at 80 and 40 px, so the CUDA path costs one allocation and
    one foreign call: checks read only shape, dtype and device, inputs that
    are already contiguous f32 are passed as they are, and an f32 output
    is returned as it is."""
    shape = frames.shape
    if (mode not in _MODES or len(shape) != 4 or shape[1] < 2
            or shape[2] < 2 or not frames.is_floating_point()
            or coords.shape != (*shape[:3], 2)):
        _check("warp_burst_coords", frames, coords, (*shape[:3], 2), mode)
    if plain or frames.is_cpu:
        fr, co = frames.float(), coords.float()
        out = sample_plain(fr, co[..., 0], co[..., 1], mode == "constant",
                           cval)
        return out.to(frames.dtype)
    if not frames.is_cuda or coords.get_device() != frames.get_device():
        _launch_ready("warp_burst_coords", frames, coords)
    f32 = frames.dtype == torch.float32
    fr = frames if f32 and frames.is_contiguous() else \
        frames.float().contiguous()
    co = coords if coords.dtype == torch.float32 and coords.is_contiguous() \
        else coords.float().contiguous()
    out = torch.empty_like(fr)
    err = _build.library().fbanet_warp_coords(
        fr.data_ptr(), co.data_ptr(), out.data_ptr(), *shape,
        mode == "constant", cval, _stream(fr))
    if err:
        _build.check(err, "warp_burst_coords")
    warp_burst_coords.launches += 1
    return out if f32 else out.to(frames.dtype)


warp_burst_coords.launches = 0
