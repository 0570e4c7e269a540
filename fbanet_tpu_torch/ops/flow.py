"""Dense optical flow by coarse-to-fine pyramidal Lucas-Kanade, and the
Middlebury flow rendering (counterpart of fbanet_tpu/ops/flow.py).

Batched over pairs: images are `[N, H, W]`. The zero-padded separable
blurs and box sums are shifted sums, not convolution calls, so no f32
convolution goes to cuDNN's TF32 path; the flow upsampling between levels
is a separable half-pixel bilinear resize, with edge samples clamped as
`jax.image.resize(..., "bilinear")` weights them.

Convention, as in the JAX package and the reference's DALI graph:
`flow[..., 0]` is the x displacement and `flow[..., 1]` the y displacement,
so that `warp_flow(target, flow)` registers `target` onto `reference`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fbanet_tpu_torch.ops.registration import _image_gradients, _separable_sum
from fbanet_tpu_torch.ops.warp import warp_flow


def _gauss_taps(sigma: float, radius: int) -> list[float]:
    """The normalised Gaussian taps of `flow._gauss_blur`, rounded to f32."""
    k = np.exp(-(np.arange(-radius, radius + 1, dtype=np.float32) ** 2)
               / np.float32(2 * sigma ** 2)).astype(np.float32)
    return (k / k.sum(dtype=np.float32)).astype(np.float32).tolist()


def _gauss_blur(img: torch.Tensor, sigma: float = 1.0, radius: int = 2
                ) -> torch.Tensor:
    """Separable Gaussian blur of `[N, H, W]` with zero padding."""
    return _separable_sum(img, _gauss_taps(sigma, radius))


def _halve(img: torch.Tensor) -> torch.Tensor:
    return _gauss_blur(img, 1.0)[:, ::2, ::2]


def _box_sum(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Windowed sum over a (2r+1)^2 box, zero padded."""
    return _separable_sum(img, [1.0] * (2 * radius + 1))


def _resize_axis(x: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    """Half-pixel linear resize of `x` along `dim`: output i samples input
    (i + 0.5) * in / out - 0.5, clamped at the edges."""
    n_in = x.shape[dim]
    src = ((torch.arange(size, dtype=torch.float32, device=x.device) + 0.5)
           * (n_in / size) - 0.5).clamp(min=0.0)
    i0 = src.floor().long().clamp(max=n_in - 1)
    i1 = (i0 + 1).clamp(max=n_in - 1)
    lam = src - i0
    shape = [1] * x.dim()
    shape[dim] = size
    lam = lam.reshape(shape)
    return x.index_select(dim, i0) * (1.0 - lam) + x.index_select(dim, i1) * lam


def _upsample_flow(flow: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """`jax.image.resize(flow, (h, w, 2), "bilinear")` for `[N, h', w', 2]`."""
    return _resize_axis(_resize_axis(flow, h, 1), w, 2)


def _lk_refine(ref: torch.Tensor, tgt: torch.Tensor, flow: torch.Tensor, *,
               window_radius: int, iters: int) -> torch.Tensor:
    """Iterative LK update of `flow` [N, H, W, 2] at one pyramid level
    (flow.py:68-107)."""
    gx, gy = _image_gradients(ref)
    ixx = _box_sum(gx * gx, window_radius)
    ixy = _box_sum(gx * gy, window_radius)
    iyy = _box_sum(gy * gy, window_radius)
    # damping scaled by the local structure tensor, so flat regions move
    lam = 1e-3 * (ixx + iyy) + 1e-9
    a00, a11 = ixx + lam, iyy + lam
    det = a00 * a11 - ixy * ixy
    inv00, inv01, inv11 = a11 / det, -ixy / det, a00 / det
    max_flow = 0.5 * max(ref.shape[-2:])
    for _ in range(iters):
        it = warp_flow(tgt[..., None], flow)[..., 0] - ref
        bx = _box_sum(gx * it, window_radius)
        by = _box_sum(gy * it, window_radius)
        upd = torch.stack([inv00 * bx + inv01 * by, inv01 * bx + inv11 * by],
                          -1).clamp(-1.5, 1.5)
        flow = flow + upd
        # regularise the field every iteration, or flat regions diverge
        flow = torch.stack([_gauss_blur(flow[..., 0]), _gauss_blur(flow[..., 1])],
                           -1)
        flow = flow.clamp(-max_flow, max_flow)
    return flow


def _flow_pairs(reference: torch.Tensor, target: torch.Tensor, *,
                levels: int = 4, window_radius: int = 4,
                iters_per_level: int = 5) -> torch.Tensor:
    """Flows `[N, H, W, 2]` of N grayscale pairs `[N, H, W]`."""
    pyr_r, pyr_t = [reference.float()], [target.float()]
    for _ in range(levels - 1):
        pyr_r.append(_halve(pyr_r[-1]))
        pyr_t.append(_halve(pyr_t[-1]))
    n, h_c, w_c = pyr_r[-1].shape
    flow = torch.zeros(n, h_c, w_c, 2, device=reference.device)
    for lvl in reversed(range(levels)):
        if lvl < levels - 1:
            h, w = pyr_r[lvl].shape[-2:]
            flow = 2.0 * _upsample_flow(flow, h, w)
        flow = _lk_refine(pyr_r[lvl], pyr_t[lvl], flow,
                          window_radius=window_radius, iters=iters_per_level)
    return flow


def optical_flow(reference: torch.Tensor, target: torch.Tensor, *,
                 levels: int = 4, window_radius: int = 4,
                 iters_per_level: int = 5) -> torch.Tensor:
    """Dense flow `[H, W, 2]` (x, y) such that `warp_flow(target, flow)`
    registers `target` onto `reference`; inputs `[H, W]` grayscale or
    `[H, W, C]` (averaged over C)."""
    if reference.dim() == 3:
        reference = reference.float().mean(-1)
        target = target.float().mean(-1)
    return _flow_pairs(reference[None], target[None], levels=levels,
                       window_radius=window_radius,
                       iters_per_level=iters_per_level)[0]


def burst_optical_flow(burst: torch.Tensor, **kw) -> torch.Tensor:
    """Flows of frames 1..F-1 against frame 0 of `[..., F, H, W, C]` bursts:
    `[..., F-1, H, W, 2]`, every pair at once."""
    gray = burst.float().mean(-1)  # [..., F, H, W]
    h, w = gray.shape[-2:]
    ref = gray[..., :1, :, :].expand_as(gray[..., 1:, :, :])
    flows = _flow_pairs(ref.reshape(-1, h, w),
                        gray[..., 1:, :, :].reshape(-1, h, w), **kw)
    return flows.reshape(*gray.shape[:-3], gray.shape[-3] - 1, h, w, 2)


# --- Middlebury visualization ------------------------------------------------

def _color_wheel() -> np.ndarray:
    """The 55-colour Middlebury wheel (reference:
    fba_net/registration/optical_flow/visualize.py:22-49)."""
    cols = []
    for n, (a, b) in zip(
        (15, 6, 4, 11, 13, 6),
        (((255, 0, 0), (255, 255, 0)), ((255, 255, 0), (0, 255, 0)),
         ((0, 255, 0), (0, 255, 255)), ((0, 255, 255), (0, 0, 255)),
         ((0, 0, 255), (255, 0, 255)), ((255, 0, 255), (255, 0, 0))),
    ):
        for i in range(n):
            t = i / n
            cols.append([a[c] * (1 - t) + b[c] * t for c in range(3)])
    return np.asarray(cols, np.float32) / 255.0


_WHEEL = _color_wheel()


def flow_to_image(flow, *, max_norm: float | None = None) -> np.ndarray:
    """Flow `[H, W, 2]` (tensor or array) -> RGB uint8 via the Middlebury
    wheel; small magnitudes saturate toward white."""
    if isinstance(flow, torch.Tensor):
        flow = flow.detach().cpu().numpy()
    flow = np.asarray(flow, np.float32)
    fx, fy = flow[..., 0], flow[..., 1]
    norm = np.sqrt(fx * fx + fy * fy)
    scale = max_norm if max_norm else max(float(norm.max()), 1e-6)
    fx, fy = fx / scale, fy / scale
    norm = np.minimum(norm / scale, 1.0)
    ncols = len(_WHEEL)
    fk = (np.arctan2(-fy, -fx) / math.pi + 1.0) / 2.0 * (ncols - 1)
    k0 = np.floor(fk).astype(int) % ncols
    k1 = (k0 + 1) % ncols
    f = (fk - np.floor(fk))[..., None]
    col = _WHEEL[k0] * (1 - f) + _WHEEL[k1] * f
    col = 1.0 - norm[..., None] * (1.0 - col)
    return (col * 255.0 + 0.5).astype(np.uint8)
