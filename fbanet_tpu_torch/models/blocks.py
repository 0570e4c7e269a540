"""Model blocks (counterpart of fbanet_tpu/models/blocks.py): ResBlock, the
Federated Affinity Fusion block, SwinGroup and the x4 tail."""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch
from torch import nn

from fbanet_tpu_torch.models.layers import (
    Conv,
    Downsample,
    PReLU,
    SwinLayer,
    Upsample,
    conv_nhwc,
    pixel_shuffle,
)
from fbanet_tpu_torch.ops.faf_gate import affinity_gate


class ResBlock(nn.Module):
    """conv3x3 -> ReLU -> conv3x3 + skip (blocks.py:30-44)."""

    def __init__(self, features: int):
        super().__init__()
        self.Conv_0 = Conv(features, features, 3, padding=1)
        self.Conv_1 = Conv(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return x + self.Conv_1(torch.relu(self.Conv_0(x, dtype)), dtype)


class FAFBlock(nn.Module):
    """Federated Affinity Fusion (blocks.py:240-351): the affinity gate, then
    the 1x1 fusion over (frame, channel) with frame as the major axis,
    PReLU(0.1) and a two-level conv hourglass with concat skips.
    `temporal_attn0` and both embedding biases cancel exactly in the gate
    and stay declared for checkpoint parity only.

    [B, F, H, W, C] -> [B, H, W, C]."""

    def __init__(self, num_feats: int, num_frames: int):
        super().__init__()
        c, f = num_feats, num_frames
        self.num_frames = f
        self.temporal_attn0 = Conv(c, c, 3, padding=1)
        self.temporal_attn1 = Conv(c, c, 3, padding=1)
        self.feature_fusion = Conv(f * c, c, 1)
        self.feature_fusion_act = PReLU(0.1)
        for i, mult in enumerate((1, 2, 4, 4, 2)):
            for j in (0, 1):
                self.add_module(f"res{i}_{j}", ResBlock(c * mult))
        self.down0 = Downsample(c, 2 * c)
        self.down1 = Downsample(2 * c, 4 * c)
        self.up0 = Upsample(4 * c, 2 * c)
        self.up1 = Upsample(4 * c, c)
        self.fusion_tail = Conv(2 * c, c, 3, padding=1)

    def _res2(self, i: int, x: torch.Tensor, dtype) -> torch.Tensor:
        x = getattr(self, f"res{i}_0")(x, dtype)
        return getattr(self, f"res{i}_1")(x, dtype)

    def forward(self, frames: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, f, h, w, c = frames.shape
        if f != self.num_frames:
            raise ValueError(f"expected {self.num_frames} frames, got {f}")
        guided = affinity_gate(frames, self.temporal_attn1.weight.sum(0),
                               compute_dtype=dtype)
        wff = self.feature_fusion.weight.reshape(c, f, c).to(dtype)  # [o, f, c]
        feat = torch.einsum("bfhwc,ofc->bhwo", guided, wff)
        feat = self.feature_fusion_act(feat + self.feature_fusion.bias.to(dtype))

        f0 = self._res2(0, feat, dtype)
        f1 = self._res2(1, self.down0(f0, dtype), dtype)
        f2 = self._res2(2, self.down1(f1, dtype), dtype)
        f3 = self._res2(3, torch.cat([self.up0(f2, dtype), f1], -1), dtype)
        f4 = self._res2(4, torch.cat([self.up1(f3, dtype), f0], -1), dtype)
        return self.fusion_tail(f4, dtype) + feat


class SwinGroup(nn.Module):
    """`depth` SwinLayers alternating shift 0 / window // 2, layer i with
    drop_path rate `drop_path_rates[i]` (all 0 when empty)
    (blocks.py:354-407)."""

    def __init__(self, dim: int, input_resolution: tuple[int, int],
                 depth: int, heads: int, window_size: int = 8,
                 drop_path_rates: Sequence[float] = (), **layer_kw):
        super().__init__()
        rates = list(drop_path_rates) or [0.0] * depth
        if len(rates) != depth:
            raise ValueError(f"{len(rates)} drop_path rates for {depth} layers")
        self.depth = depth
        for i in range(depth):
            self.add_module(f"layer{i}", SwinLayer(
                dim, input_resolution, heads, window_size=window_size,
                shift_size=0 if i % 2 == 0 else window_size // 2,
                drop_path_rate=float(rates[i]), **layer_kw))

    def forward(self, x: torch.Tensor, plain: bool = False, *,
                train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"layer{i}")(x, plain=plain, train=train,
                                           generator=generator)
        return x


class TailUpsampler(nn.Module):
    """Parameters of the x4 upsampler (`conv0`, `conv1`: 3x3, C -> 4C)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv0 = Conv(features, 4 * features, 3, padding=1)
        self.conv1 = Conv(features, 4 * features, 3, padding=1)


def rearrange_after_shuffle(w: torch.Tensor) -> torch.Tensor:
    """Fold an odd-sized conv applied after `pixel_shuffle(x, 2)` into the
    equivalent conv before it (blocks.py:86-123), on torch layouts:
    [Co, C, k, k] -> [4Co, 4C, k', k'] (k' = 3 for k in {3, 5}). Exact, zero
    padding at the borders included: each output tap copies one input tap."""
    co, c, kh, kw = w.shape
    if kh != kw or kh % 2 != 1:
        raise ValueError(f"odd square kernel expected, got {kh}x{kw}")
    r = kh // 2
    yy_min = -((r + 1) // 2)
    yy_max = (1 + r) // 2
    ko = yy_max - yy_min + 1
    t = np.zeros((ko, 2, 2, kh), np.float32)  # [Y, p, d, a]
    for d in range(2):
        for a in range(-r, r + 1):
            yy, p = divmod(d + a, 2)
            t[yy - yy_min, p, d, a + r] = 1.0
    tt = torch.from_numpy(t).to(w.device, w.dtype)
    wf = w.permute(2, 3, 1, 0)  # flax [k, k, C, Co]
    wk = torch.einsum("YpdA,XqeB,ABio->YXipqode", tt, tt, wf)
    return wk.reshape(ko, ko, 4 * c, 4 * co).permute(3, 2, 0, 1)


def tail_x4_direct(x: torch.Tensor, w0, b0, w1, b1, wt, bt,
                   dtype: torch.dtype) -> torch.Tensor:
    """The x4 tail — conv0, shuffle, conv1, then the final conv folded
    through the second shuffle (blocks.py:158-172). [B, H, W, C] ->
    [B, 4H, 4W, cout]."""
    y = pixel_shuffle(conv_nhwc(x, w0, b0, dtype, padding=1), 2)
    z = conv_nhwc(y, w1, b1, dtype, padding=1)
    wk = rearrange_after_shuffle(wt)
    zz = conv_nhwc(z, wk, None, dtype, padding=wk.shape[-1] // 2)
    return pixel_shuffle(zz, 2) + bt.to(dtype)
