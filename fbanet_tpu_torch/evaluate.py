"""The evaluation step of the port (counterpart of the jitted `step` in
fbanet_tpu/evaluate.py:62-70): registration, forward, clamp, metrics.

The RealBSR dataset, its loader and the command line are not ported yet.
"""

from __future__ import annotations

import torch

from fbanet_tpu_torch.metrics import psnr, ssim, to_unit_f32
from fbanet_tpu_torch.ops.registration import online_register


@torch.no_grad()
def eval_step(model: torch.nn.Module, lr: torch.Tensor, hr: torch.Tensor, *,
              online_align: str = "ecc", boundary_ignore: int = 40,
              plain: bool = False):
    """One evaluation batch: `lr` bursts [B, F, H, W, C] and `hr` targets
    [B, 4H, 4W, C] (storage integers or floats) -> (pred clamped to [0, 1],
    per-image PSNR [B], per-image SSIM [B], hr in f32). `plain=True` runs
    the fused operators' plain versions (a comparison, not the serving
    path)."""
    lr, hr = to_unit_f32(lr), to_unit_f32(hr)
    if online_align != "none":
        lr = online_register(lr, online_align)
    pred = torch.clamp(model(lr, plain=plain), 0.0, 1.0)
    return (pred, psnr(pred, hr, boundary_ignore=boundary_ignore),
            ssim(pred, hr, boundary_ignore=boundary_ignore), hr)
