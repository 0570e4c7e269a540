"""The f32 LayerNorm every SwinLayer uses (and both kernels fuse)."""

from __future__ import annotations

import torch

LN_EPS = 1e-5  # torch nn.LayerNorm default, kept by the JAX package


def layer_norm_f32(x: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm semantics over the last axis, in f32: the fast variance
    E[x^2] - E[x]^2 clamped at 0, eps 1e-5, the scale folded into the rsqrt
    before the multiply (fbanet_tpu/models/layers.py:550,
    ops/attention_pallas.py:175-178). torch's nn.LayerNorm is two-pass and
    rounds differently. Returns f32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + LN_EPS) * scale.float()
    return (xf - mu) * mul + bias.float()
