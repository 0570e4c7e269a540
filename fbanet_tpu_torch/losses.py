"""Training losses (counterpart of fbanet_tpu/losses.py).

All take channels-last tensors `[..., H, W, C]` in [0, 1] and reduce with a
mean. The published objective is `charbonnier(pred, gt) + 3 *
gradient_weighted_loss(pred, gt)` on the clamped prediction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor,
                     eps: float = 1e-3) -> torch.Tensor:
    """mean(sqrt(diff^2 + eps^2)) (losses.py:25-31)."""
    diff = pred - target
    return torch.mean(torch.sqrt(diff * diff + eps * eps))


def _sobel_gradients(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel gradients of `[..., H, W, C]` with zero padding 1, as
    slice-adds of the separable taps ([-1, 0, 1] difference, then [1, 2, 1]
    smoothing), in the order of losses.py:34-53."""
    p = F.pad(x, (0, 0, 1, 1, 1, 1))
    hx = p[..., :, 2:, :] - p[..., :, :-2, :]         # [..., H+2, W, C]
    gx = hx[..., :-2, :, :] + 2.0 * hx[..., 1:-1, :, :] + hx[..., 2:, :, :]
    vy = p[..., 2:, :, :] - p[..., :-2, :, :]         # [..., H, W+2, C]
    gy = vy[..., :, :-2, :] + 2.0 * vy[..., :, 1:-1, :] + vy[..., :, 2:, :]
    return gx, gy


def gradient_weighted_loss(pred: torch.Tensor,
                           target: torch.Tensor) -> torch.Tensor:
    """mean((1 + 4|Sx d|)(1 + 4|Sy d|)|d|), d = clamp(pred) - clamp(target)
    (losses.py:56-72; Sobel is linear, so sobel(x1) - sobel(x2) =
    sobel(x1 - x2))."""
    d = torch.clamp(pred, 0.0, 1.0) - torch.clamp(target, 0.0, 1.0)
    dx, dy = _sobel_gradients(d)
    return torch.mean((1.0 + 4.0 * torch.abs(dx)) * (1.0 + 4.0 * torch.abs(dy))
                      * torch.abs(d))


def tv_loss(x: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Total variation of `[B, H, W, C]` (losses.py:75-88)."""
    b, h, w, c = x.shape
    h_tv = torch.sum((x[:, 1:] - x[:, :-1]) ** 2)
    w_tv = torch.sum((x[:, :, 1:] - x[:, :, :-1]) ** 2)
    count_h = (h - 1) * w * c
    count_w = h * (w - 1) * c
    return weight * 2.0 * (h_tv / count_h + w_tv / count_w) / b


def fbanet_training_loss(pred: torch.Tensor, target: torch.Tensor, *,
                         charbonnier_eps: float = 1e-3,
                         gw_weight: float = 3.0) -> torch.Tensor:
    """Clamp, then Charbonnier + gw_weight * GW loss (losses.py:91-103)."""
    pred = torch.clamp(pred, 0.0, 1.0)
    return (charbonnier_loss(pred, target, eps=charbonnier_eps)
            + gw_weight * gradient_weighted_loss(pred, target))
