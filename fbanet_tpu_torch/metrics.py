"""Quality metrics with the reference's boundary-crop semantics
(counterpart of fbanet_tpu/metrics.py), channels-last `[..., H, W, C]`.

SSIM's Gaussian blur is written as shifted sums rather than a convolution
call, so it stays in f32 on the GPU whatever the TF32 settings are.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _boundary_crop(x: torch.Tensor, boundary_ignore: int | None) -> torch.Tensor:
    if boundary_ignore:
        b = boundary_ignore
        return x[..., b:-b, b:-b, :]
    return x


def psnr(pred: torch.Tensor, target: torch.Tensor, *,
         boundary_ignore: int | None = None,
         max_value: float = 1.0) -> torch.Tensor:
    """Per-image PSNR over the trailing [H, W, C] (metrics.py:31-41)."""
    pred = _boundary_crop(pred, boundary_ignore).float()
    target = _boundary_crop(target, boundary_ignore).float()
    mse = ((pred - target) ** 2).mean(dim=(-3, -2, -1))
    return 20.0 * math.log10(max_value) - 10.0 * torch.log10(mse)


def batch_psnr(pred: torch.Tensor, target: torch.Tensor, *,
               boundary_ignore: int | None = 40,
               average: bool = True) -> torch.Tensor:
    """Mean (or sum) of the per-image PSNRs of the batch (metrics.py:44-53)."""
    per_image = psnr(pred, target, boundary_ignore=boundary_ignore)
    return per_image.mean() if average else per_image.sum()


def _gaussian_kernel1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(size, dtype=np.float32) - (size - 1) / 2.0
    g = np.exp(-(coords ** 2) / (2.0 * sigma ** 2)).astype(np.float32)
    return g / g.sum()


def _blur_valid(x: torch.Tensor, g: np.ndarray) -> torch.Tensor:
    """Separable 'valid' Gaussian blur of [N, H, W, C] along H, then W."""
    k = len(g)
    h = x.shape[1] - k + 1
    x = sum(float(g[i]) * x[:, i:i + h] for i in range(k))
    w = x.shape[2] - k + 1
    return sum(float(g[i]) * x[:, :, i:i + w] for i in range(k))


def ssim(pred: torch.Tensor, target: torch.Tensor, *,
         boundary_ignore: int | None = None, max_value: float = 1.0,
         filter_size: int = 11, filter_sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Per-image SSIM (Wang et al.), Gaussian 11 x 1.5, valid padding
    (metrics.py:62-101)."""
    pred = _boundary_crop(pred, boundary_ignore).float()
    target = _boundary_crop(target, boundary_ignore).float()
    *lead, h, w, c = pred.shape
    p = pred.reshape(-1, h, w, c)
    t = target.reshape(-1, h, w, c)
    g = _gaussian_kernel1d(filter_size, filter_sigma)
    mu_p, mu_t = _blur_valid(p, g), _blur_valid(t, g)
    mu_pp, mu_tt, mu_pt = (_blur_valid(p * p, g), _blur_valid(t * t, g),
                           _blur_valid(p * t, g))
    var_p = mu_pp - mu_p * mu_p
    var_t = mu_tt - mu_t * mu_t
    cov = mu_pt - mu_p * mu_t
    c1 = (k1 * max_value) ** 2
    c2 = (k2 * max_value) ** 2
    ssim_map = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / (
        (mu_p * mu_p + mu_t * mu_t + c1) * (var_p + var_t + c2))
    out = ssim_map.mean(dim=(1, 2, 3))
    return out.reshape(lead) if lead else out[0]


def batch_ssim(pred: torch.Tensor, target: torch.Tensor, *,
               boundary_ignore: int | None = 40) -> torch.Tensor:
    """Mean per-image SSIM of the batch (metrics.py:104-106)."""
    return ssim(pred, target, boundary_ignore=boundary_ignore).mean()


def pixelwise_error(pred: torch.Tensor, target: torch.Tensor, *,
                    metric: str = "l1", boundary_ignore: int | None = None,
                    valid: torch.Tensor | None = None) -> torch.Tensor:
    """Masked pixel-wise error: l1 / l2 / l2_sqrt / charbonnier (eps 1e-3),
    optional boundary crop and `valid` weighting (metrics.py:109-155). With
    a mask the result is sum(err * valid) / (sum(valid) * err.numel() /
    valid.numel() + 1e-12), so a per-pixel mask broadcast over C channels
    weighs each pixel once; `l2_sqrt` reduces the channels first."""
    pred = _boundary_crop(pred, boundary_ignore)
    target = _boundary_crop(target, boundary_ignore)
    if valid is not None and boundary_ignore:
        b = boundary_ignore
        valid = valid[..., b:-b, b:-b, :]
    diff = pred.float() - target.float()
    if metric == "l1":
        err = diff.abs()
    elif metric == "l2":
        err = diff * diff
    elif metric == "l2_sqrt":
        err = torch.sqrt((diff * diff).sum(dim=-1))
    elif metric == "charbonnier":
        err = torch.sqrt(diff * diff + 1e-3 ** 2)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    if valid is None:
        return err.mean()
    valid = valid.float()
    if metric == "l2_sqrt" and valid.dim() == err.dim() + 1:
        valid = valid[..., 0]
    elem_ratio = err.numel() / valid.numel()
    return (err * valid).sum() / (valid.sum() * elem_ratio + 1e-12)


def finite_average(values, total_count: int | None = None) -> float:
    """Sum of the finite per-image values over the total image count
    (metrics.py:158-178)."""
    a = np.asarray(values, dtype=np.float64).reshape(-1)
    n = len(a) if total_count is None else total_count
    return float(a[np.isfinite(a)].sum() / max(1, n))


def to_unit_f32(x: torch.Tensor) -> torch.Tensor:
    """Storage integers -> f32 in [0, 1] (train.py:164-176); floats pass."""
    if x.dtype == torch.uint8:
        return x.float() * (1.0 / 255.0)
    if x.dtype == torch.uint16:
        return x.float() * (1.0 / 16383.0)
    return x
