"""FAF affinity gate (fbanet_tpu/ops/faf_gate.py:33-56), plain PyTorch.

    s_k   = sum_c (x_k *3x3* wsum)      per-pixel affinity, summed in f32
    gate  = sigmoid(|s_k - s_0|)         frame 0 ungated
    out_k = x_k * gate_k

The channel-summed embedding conv runs depthwise with the summed kernel
(blocks.FAFBlock explains why the reference-frame conv and the biases
cancel). The TPU package has no Pallas kernel here, and neither does the
port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def affinity_gate(x: torch.Tensor, wsum: torch.Tensor,
                  compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x: [B, F, H, W, C]; wsum: [C, 3, 3] (the torch `temporal_attn1`
    weight summed over its output channels). Returns the gated burst."""
    b, f, h, w, c = x.shape
    xd = x.to(compute_dtype)
    xn = xd.reshape(b * f, h, w, c).permute(0, 3, 1, 2)  # channels_last NCHW view
    z = F.conv2d(xn, wsum.to(compute_dtype)[:, None], padding=1, groups=c)
    s = z.sum(dim=1, dtype=torch.float32).reshape(b, f, h, w)
    gate = torch.sigmoid((s[:, 1:] - s[:, :1]).abs()).to(compute_dtype)
    gate = torch.cat([torch.ones_like(gate[:, :1]), gate], 1)  # frame 0: 1
    return xd * gate[..., None]
