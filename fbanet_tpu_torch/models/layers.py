"""Layer library of the port (counterpart of fbanet_tpu/models/layers.py).

Feature maps stay channels-last `[B, H, W, C]` as in the JAX package;
convolutions run on NCHW views of them (`permute`, no copy: the view has
`channels_last` strides). Parameters are torch layouts under the names
`fbanet_tpu/utils/torch_io.py` gives the flax tree, flax auto-names
included (`Conv_0`, `ConvTranspose_0`, `PReLU_0`), so a converted JAX
checkpoint loads with `strict=True`. Parameters are f32; each forward casts
them to the compute dtype, as flax's `dtype=` does.

`SwinLayer` takes the published options only (linear token projection, LeFF,
no SE, no qk_scale, no dropout, any drop_path rate): both of its branches go
through the fused operators K1 (`ops.attention`) and K2 (`ops.leff`), whose
backwards are K3 and K4.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# window_partition / window_reverse live with K1; re-exported here where
# fbanet_tpu.models.layers has them
from fbanet_tpu_torch.ops.attention import (  # noqa: F401
    fused_window_attention_2d,
    window_partition,
    window_reverse,
)
from fbanet_tpu_torch.ops.leff import fused_leff
from fbanet_tpu_torch.ops.norm import layer_norm_f32


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor | None, dtype: torch.dtype, *,
              stride: int = 1, padding: int = 0,
              groups: int = 1) -> torch.Tensor:
    """flax nn.Conv on `[B, H, W, C]` with a torch `[O, I, kh, kw]` weight,
    computed in `dtype` (input, weight and bias cast to it)."""
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), weight.to(dtype),
                 None if bias is None else bias.to(dtype), stride=stride,
                 padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """Parameters of a flax nn.Conv in torch layout (`weight` [O, I/groups,
    k, k], `bias` [O]) with its forward on `[B, H, W, C]`."""

    def __init__(self, cin: int, cout: int, k: int, *, stride: int = 1,
                 padding: int = 0, groups: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride, self.padding, self.groups = stride, padding, groups

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return conv_nhwc(x, self.weight, self.bias, dtype, stride=self.stride,
                         padding=self.padding, groups=self.groups)


class Dense(nn.Module):
    """Parameters of a flax nn.Dense in torch Linear layout (`weight`
    [out, in], `bias` [out]). The fused operators consume them directly."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))


class LayerNorm(nn.Module):
    """LayerNorm parameters (`weight` = flax scale, `bias`); the f32 math is
    `ops.norm.layer_norm_f32`, fused into K1 and K2 on the main path."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_f32(x, self.weight, self.bias)


class PReLU(nn.Module):
    """One learnable slope, `where(x >= 0, x, alpha * x)` in x's dtype
    (layers.py:50-66)."""

    def __init__(self, init_alpha: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), init_alpha))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


def relative_position_index(ws: int) -> np.ndarray:
    """Standard Swin relative-position index, [ws*ws, ws*ws] int32."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[:, :, 0] * (2 * ws - 1) + rel[:, :, 1]).astype(np.int32)


def shift_attention_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """Additive SW-MSA mask, [nWindows, ws*ws, ws*ws] float32 {0, -100}."""
    ids = np.zeros((h, w), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            ids[hs, wsl] = cnt
            cnt += 1
    nh, nw = h // ws, w // ws
    idw = ids.reshape(nh, ws, nw, ws).transpose(0, 2, 1, 3).reshape(nh * nw, ws * ws)
    return (idw[:, :, None] != idw[:, None, :]).astype(np.float32) * -100.0


class WindowAttention(nn.Module):
    """Parameters of the window attention (`to_q`, `to_kv`, `proj`,
    `relative_position_bias_table`); the math is K1."""

    def __init__(self, dim: int, window_size: int, heads: int):
        super().__init__()
        self.heads, self.window_size = heads, window_size
        self.to_q = Dense(dim, dim)
        self.to_kv = Dense(dim, 2 * dim)
        self.proj = Dense(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, heads))
        self.register_buffer(
            "rel_index",
            torch.from_numpy(relative_position_index(window_size).astype(
                np.int64)).reshape(-1), persistent=False)

    def bias(self) -> torch.Tensor:
        """The gathered relative-position bias [heads, N, N]."""
        n = self.window_size ** 2
        b = self.relative_position_bias_table[self.rel_index]
        return b.reshape(n, n, self.heads).permute(2, 0, 1)


class LeFF(nn.Module):
    """Parameters of the LeFF (`linear1`, `depthwise` [Ch, 1, 3, 3],
    `linear2`); the math is K2."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.linear1 = Dense(dim, hidden_dim)
        self.depthwise = Conv(hidden_dim, hidden_dim, 3, padding=1,
                              groups=hidden_dim)
        self.linear2 = Dense(hidden_dim, dim)


class DropPath(nn.Module):
    """Per-sample stochastic depth (layers.py:69-85): in training, one
    Bernoulli(1 - rate) draw per sample from the caller's generator; kept
    samples are scaled by 1 / (1 - rate), dropped ones are zero. The
    identity in eval or at rate 0. torch's generator does not give
    jax.random's bits: the same seed gives other masks, the same law."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        device = generator.device if generator is not None else x.device
        bits = torch.empty(x.shape[0], device=device).bernoulli_(
            keep, generator=generator)
        mask = bits.to(x.device).bool().reshape(-1, *([1] * (x.dim() - 1)))
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


class SwinLayer(nn.Module):
    """One (shifted-)window transformer layer on `[B, H, W, C]`
    (layers.py:470-607): roll by -shift, K1, roll back, K2. When drop_path
    is the identity (eval, or rate 0) both kernels add the residual
    themselves; in training with a rate they return the branch and the
    layer adds `skip + drop_path(branch)`. Windows of inputs no larger than
    the window are clamped to the input, unshifted (layers.py:517-518)."""

    def __init__(self, dim: int, input_resolution: tuple[int, int],
                 heads: int, window_size: int = 8, shift_size: int = 0,
                 mlp_ratio: float = 4.0, use_qkv_bias: bool = True,
                 qk_scale: float | None = None, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 token_projection: str = "linear", token_mlp: str = "leff",
                 use_se_layer: bool = False):
        super().__init__()
        unsupported = {
            "use_qkv_bias=False": not use_qkv_bias,
            "qk_scale": qk_scale is not None,
            "drop_rate": drop_rate != 0.0,
            "attn_drop_rate": attn_drop_rate != 0.0,
            f"token_projection={token_projection}": token_projection != "linear",
            f"token_mlp={token_mlp}": token_mlp != "leff",
            "use_se_layer": use_se_layer,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(
                f"SwinLayer options not ported yet: {', '.join(bad)}")
        h, w = input_resolution
        ws, shift = window_size, shift_size
        if min(h, w) <= ws:
            ws, shift = min(h, w), 0
        if h % ws or w % ws:
            raise ValueError(f"resolution {h}x{w} not divisible by window {ws}")
        self.dim, self.heads = dim, heads
        self.input_resolution, self.window_size, self.shift = (h, w), ws, shift
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, ws, heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = LeFF(dim, int(dim * mlp_ratio))
        mask = (torch.from_numpy(shift_attention_mask(h, w, ws, shift))
                if shift > 0 else None)
        self.register_buffer("mask", mask, persistent=False)
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor, plain: bool = False, *,
                train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if tuple(x.shape[1:]) != (*self.input_resolution, self.dim):
            raise ValueError(f"SwinLayer expects [B, {self.input_resolution}, "
                             f"{self.dim}], got {tuple(x.shape)}")
        dp_identity = not train or self.drop_path.rate == 0.0
        s = self.shift
        y = torch.roll(x, (-s, -s), (1, 2)) if s else x
        a = self.attn
        y = fused_window_attention_2d(
            y, self.norm1.weight, self.norm1.bias, a.to_q.weight, a.to_q.bias,
            a.to_kv.weight, a.to_kv.bias, a.proj.weight, a.proj.bias,
            a.bias(), self.mask, heads=self.heads,
            window_size=self.window_size, residual=dp_identity, plain=plain)
        if s:
            y = torch.roll(y, (s, s), (1, 2))
        if not dp_identity:
            y = x + self.drop_path(y, train=train, generator=generator)
        m = self.mlp
        out = fused_leff(
            y, self.norm2.weight, self.norm2.bias, m.linear1.weight,
            m.linear1.bias, m.depthwise.weight, m.depthwise.bias,
            m.linear2.weight, m.linear2.bias, residual=dp_identity,
            plain=plain)
        if dp_identity:
            return out
        return y + self.drop_path(out, train=train, generator=generator)


class Downsample(nn.Module):
    """4x4 stride-2 conv, padding 1 (layers.py:610-628)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.Conv_0 = Conv(cin, features, 4, stride=2, padding=1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.Conv_0(x, dtype)


class ConvTranspose(nn.Module):
    """Parameters of the 2x2 stride-2 transposed conv in torch layout
    (`weight` [I, O, 2, 2], already flipped by the converter)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, 2, 2))
        self.bias = nn.Parameter(torch.zeros(cout))


class Upsample(nn.Module):
    """2x2 stride-2 transposed conv doubling resolution (layers.py:631-657).
    The footprints do not overlap, so the JAX form (one matmul + depth to
    space with the flipped kernel) and torch's conv_transpose2d with the
    converted weight are the same sum."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(cin, features)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        p = self.ConvTranspose_0
        y = F.conv_transpose2d(x.to(dtype).permute(0, 3, 1, 2),
                               p.weight.to(dtype), p.bias.to(dtype), stride=2)
        return y.permute(0, 2, 3, 1)


class ConvProj(nn.Module):
    """3x3 conv + PReLU (layers.py:660-676)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.Conv_0 = Conv(cin, features, 3, padding=1)
        self.PReLU_0 = PReLU()

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.PReLU_0(self.Conv_0(x, dtype))


def pixel_shuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Depth-to-space `[B, H, W, C*s*s] -> [B, H*s, W*s, C]` in torch's
    PixelShuffle channel order (layers.py:679-690)."""
    b, h, w, csq = x.shape
    c = csq // (scale * scale)
    x = x.reshape(b, h, w, c, scale, scale).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * scale, w * scale, c)
