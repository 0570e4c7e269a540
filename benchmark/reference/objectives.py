"""The training objective and AdamW in plain PyTorch, float32: the
reference's copies of the published rules.

- loss: Charbonnier (eps 1e-3) + 3 x the gradient-weighted L1 on the
  prediction clamped to [0, 1] (Sobel taps, zero padding);
- AdamW: betas 0.9 / 0.999, eps 1e-8, decoupled weight decay, bias
  correction; a parameter without a gradient gets a zero one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def training_loss(pred, target, eps: float = 1e-3, gw_weight: float = 3.0):
    pred = torch.clamp(pred, 0.0, 1.0)
    diff = pred - target
    charb = torch.mean(torch.sqrt(diff * diff + eps * eps))
    d = pred - torch.clamp(target, 0.0, 1.0)
    p = F.pad(d, (0, 0, 1, 1, 1, 1))
    hx = p[..., :, 2:, :] - p[..., :, :-2, :]
    gx = hx[..., :-2, :, :] + 2.0 * hx[..., 1:-1, :, :] + hx[..., 2:, :, :]
    vy = p[..., 2:, :, :] - p[..., :-2, :, :]
    gy = vy[..., :, :-2, :] + 2.0 * vy[..., :, 1:-1, :] + vy[..., :, 2:, :]
    gw = torch.mean((1 + 4 * gx.abs()) * (1 + 4 * gy.abs()) * d.abs())
    return charb + gw_weight * gw


class AdamW:
    """torch.optim.AdamW's update, written out."""

    def __init__(self, params, lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = torch.zeros_like(p) if p.grad is None else p.grad
            p.mul_(1 - self.lr * self.wd)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = v.sqrt() / math.sqrt(c2) + self.eps
            p.addcdiv_(m, denom, value=-self.lr / c1)
