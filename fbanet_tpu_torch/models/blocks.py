"""Model blocks (counterpart of fbanet_tpu/models/blocks.py): ResBlock, the
Federated Affinity Fusion block, SwinGroup and the x4 tail (the direct form
the model runs, and the composed `fused_tail_x4` that
tools/profile_components.py times beside it)."""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch
import torch.nn.functional as F
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


def compose_convs(wa: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """The kernel K with conv(x, K) == conv(conv(x, wa), wb) away from image
    borders ('same' zero padding, cross-correlation; blocks.py:126-145), on
    torch layouts: wa [M, Ci, ka, ka], wb [Co, M, kb, kb] -> [Co, Ci, ka +
    kb - 1, ka + kb - 1], K[t] = sum_{u+v=t} wb[v] . wa[u]. One 'full'
    convolution over the tap grid: wa's taps as an image batched over Ci,
    wb flipped as the kernel. Near borders the composition differs (it sees
    intermediate values where the true pipeline zero-pads); callers repair
    a (ka + kb - 2) / 2-wide ring."""
    kb = wb.shape[-1]
    out = F.conv2d(wa.transpose(0, 1), wb.flip(-1, -2), padding=kb - 1)
    return out.transpose(0, 1)


def _conv_same(y: torch.Tensor, wk: torch.Tensor, bk: torch.Tensor | None,
               dtype: torch.dtype) -> torch.Tensor:
    """'same' conv in `dtype`, the bias added after it (blocks.py:148-155)."""
    out = conv_nhwc(y, wk, None, dtype, padding=wk.shape[-1] // 2)
    return out if bk is None else out + bk.to(dtype)


_TAIL_RING = 8    # 4H-scale border ring the composed conv gets wrong
_TAIL_STRIP = 4   # feature-scale strip recomputed with the direct path
                  # (exact rows 4 * (_TAIL_STRIP - 2) >= _TAIL_RING)


def fused_tail_x4(x: torch.Tensor, w0, b0, w1, b1, wt, bt,
                  dtype: torch.dtype) -> torch.Tensor:
    """The x4 tail as one composed 5x5 conv C -> 16 cout at the feature
    resolution and both pixel shuffles in one permutation, with the border
    ring recomputed by the direct path (blocks.py:180-237). The same
    function as `tail_x4_direct` (the tail is linear), which the model
    runs; this form is the TPU's speed trick, kept to time it on the card.
    The kernels compose in float64 (the JAX package composes in f32 at
    HIGHEST precision; float64 keeps the card's TF32 convolution setting
    out of the weights). [B, H, W, C] -> [B, 4H, 4W, cout]."""
    b, h, w, _c = x.shape
    if min(h, w) < 2 * _TAIL_STRIP:
        return tail_x4_direct(x, w0, b0, w1, b1, wt, bt, dtype)
    f64 = torch.float64
    # final conv folded to 2H-space, composed with conv1: [4 cout, C, 5, 5]
    rt = rearrange_after_shuffle(wt.to(f64))
    wa = compose_convs(w1.to(f64), rt)
    cb = torch.einsum("oixy,i->o", rt, b1.to(f64))  # conv1 bias through rt
    # folded to H-space, composed with conv0: [16 cout, C, 5, 5]
    wb = rearrange_after_shuffle(wa)
    wf = compose_convs(w0.to(f64), wb)
    bf = cb.repeat_interleave(4) + torch.einsum("oixy,i->o", wb, b0.to(f64))
    core = _conv_same(x, wf.float(), bf.float(), dtype)
    # both shuffles at once: channel o * 16 + (dy2 * 2 + dx2) * 4 + (dy1 *
    # 2 + dx1) lands at (2 dy1 + dy2, 2 dx1 + dx2)
    cout = wt.shape[0]
    out = core.reshape(b, h, w, cout, 2, 2, 2, 2).permute(
        0, 1, 6, 4, 2, 7, 5, 3).reshape(b, 4 * h, 4 * w, cout)
    out = out + bt.to(dtype)
    # the exact ring from the direct path on four narrow strips, opposite
    # strips batched together (written into `out`, a fresh tensor)
    s, r = _TAIL_STRIP, _TAIL_RING
    args = (w0, b0, w1, b1, wt, bt, dtype)
    tb = tail_x4_direct(torch.cat([x[:, :s], x[:, -s:]]), *args)
    out[:, :r] = tb[:b, :r]
    out[:, -r:] = tb[b:, -r:]
    lr = tail_x4_direct(torch.cat([x[:, :, :s], x[:, :, -s:]]), *args)
    out[:, :, :r] = lr[:b, :, :r]
    out[:, :, -r:] = lr[b:, :, -r:]
    return out
