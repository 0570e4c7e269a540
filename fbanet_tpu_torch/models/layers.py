"""Layer library of the port (counterpart of fbanet_tpu/models/layers.py).

Feature maps stay channels-last `[B, H, W, C]` as in the JAX package;
convolutions run on NCHW views of them (`permute`, no copy: the view has
`channels_last` strides). Parameters are torch layouts under the names
`fbanet_tpu/utils/torch_io.py` gives the flax tree, flax auto-names
included (`Conv_0`, `ConvTranspose_0`, `PReLU_0`), so a converted JAX
checkpoint loads with `strict=True`. Parameters are f32; each forward casts
them to the compute dtype, as flax's `dtype=` does.

`SwinLayer` takes every option of the JAX layer and routes as JAX's
`_use_fused_attention` does (layers.py:499-510). With a linear token
projection, no SE, no qk_scale and no dropout it takes the fused route:
the attention through K1 (`ops.attention`, backward K3; its shape rule sends
windows the TPU kernel does not take, window 10 among them, to JAX's
composed `window_attention_reference`), the LeFF through K2 (`ops.leff`,
backward K4), or the composed `MlpFFN` with `token_mlp="ffn"`. Every other
configuration takes the composed route: `WindowAttention`, `LeFF` or
`MlpFFN` as composed PyTorch ops, the counterparts of JAX's XLA modules,
rounding where they round (f32 LayerNorm cast to the compute dtype, f32
logits and softmax cast to it, flax's tanh GELU, a Dense's bias added after
its product is rounded).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# window_partition / window_reverse live with K1; re-exported here where
# fbanet_tpu.models.layers has them
from fbanet_tpu_torch.ops.attention import (  # noqa: F401
    dense,
    fused_window_attention_2d,
    heads_attention,
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
    k, k], `bias` [O] or none) with its forward on `[B, H, W, C]`."""

    def __init__(self, cin: int, cout: int, k: int, *, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.padding, self.groups = stride, padding, groups

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return conv_nhwc(x, self.weight, self.bias, dtype, stride=self.stride,
                         padding=self.padding, groups=self.groups)


class Dense(nn.Module):
    """Parameters of a flax nn.Dense in torch Linear layout (`weight`
    [out, in], `bias` [out] or none). The fused operators consume them
    directly; the composed modules call it (`ops.attention.dense`)."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return dense(x, self.weight, self.bias, dtype)


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


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's nn.gelu: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class SepConv2d(nn.Module):
    """Depthwise k x k conv (groups = C) -> ReLU -> pointwise 1x1, both with
    or without a bias (layers.py:285-307), on `[B, H, W, C]`."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 use_bias: bool = True):
        super().__init__()
        self.depthwise = Conv(cin, cin, kernel_size, padding=kernel_size // 2,
                              groups=cin, bias=use_bias)
        self.pointwise = Conv(cin, features, 1, bias=use_bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.pointwise(torch.relu(self.depthwise(x, dtype)), dtype)


class SELayer(nn.Module):
    """Squeeze-and-excitation gate (layers.py:310-329): the mean over every
    axis but the first and the last, `Dense_0` (C -> C / 16, no bias), ReLU,
    `Dense_1` (no bias), sigmoid, times x."""

    def __init__(self, dim: int, reduction: int = 16):
        super().__init__()
        self.Dense_0 = Dense(dim, dim // reduction, bias=False)
        self.Dense_1 = Dense(dim // reduction, dim, bias=False)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        s = x.mean(dim=tuple(range(1, x.dim() - 1)))
        s = torch.sigmoid(self.Dense_1(torch.relu(self.Dense_0(s, dtype)),
                                       dtype))
        return x * s.reshape(s.shape[0], *([1] * (x.dim() - 2)), s.shape[-1])


class Dropout(nn.Module):
    """flax nn.Dropout: in training, each element kept with probability
    1 - rate from the caller's generator and scaled by 1 / (1 - rate), the
    others zero; the identity in eval or at rate 0. As `DropPath`, the same
    seed gives other bits than jax.random's, under the same law."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        device = generator.device if generator is not None else x.device
        bits = torch.empty(x.shape, device=device).bernoulli_(
            keep, generator=generator)
        return torch.where(bits.to(x.device).bool(),
                           x / keep if keep > 0 else x,
                           torch.zeros((), dtype=x.dtype, device=x.device))


class WindowAttention(nn.Module):
    """The window attention's parameters (`to_q`, `to_kv` or, with
    `token_projection="conv"`, `to_q` / `to_k` / `to_v` as SepConv2d;
    `proj`, `relative_position_bias_table`, `SELayer_0` with the SE gate)
    and, for the composed route, JAX's composed forward on `[G, N, C]`
    windows (layers.py:354-419). On the fused route K1 reads the parameters
    (windows JAX's kernel does not take go to
    `ops.attention.window_attention_composed`, this forward's math for the
    linear projection)."""

    def __init__(self, dim: int, window_size: int, heads: int,
                 use_qkv_bias: bool = True, qk_scale: float | None = None,
                 attn_drop_rate: float = 0.0, proj_drop_rate: float = 0.0,
                 token_projection: str = "linear",
                 use_se_layer: bool = False):
        super().__init__()
        if token_projection not in ("linear", "conv"):
            raise ValueError(f"token_projection {token_projection!r}")
        self.heads, self.window_size = heads, window_size
        self.qk_scale, self.token_projection = qk_scale, token_projection
        if token_projection == "linear":
            self.to_q = Dense(dim, dim, bias=use_qkv_bias)
            self.to_kv = Dense(dim, 2 * dim, bias=use_qkv_bias)
        else:
            self.to_q = SepConv2d(dim, dim, use_bias=use_qkv_bias)
            self.to_k = SepConv2d(dim, dim, use_bias=use_qkv_bias)
            self.to_v = SepConv2d(dim, dim, use_bias=use_qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, heads))
        self.proj = Dense(dim, dim)
        if use_se_layer:
            self.SELayer_0 = SELayer(dim)
        self.attn_drop = Dropout(attn_drop_rate)
        self.proj_drop = Dropout(proj_drop_rate)
        self.register_buffer(
            "rel_index",
            torch.from_numpy(relative_position_index(window_size).astype(
                np.int64)).reshape(-1), persistent=False)

    def bias(self) -> torch.Tensor:
        """The gathered relative-position bias [heads, N, N]."""
        n = self.window_size ** 2
        b = self.relative_position_bias_table[self.rel_index]
        return b.reshape(n, n, self.heads).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None,
                dtype: torch.dtype, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """[G, N, C] windows (already normalised) -> [G, N, C] in
        `dtype`."""
        g, n, c = x.shape
        scale = self.qk_scale or (c // self.heads) ** -0.5
        if self.token_projection == "linear":
            q = self.to_q(x, dtype)
            k, v = self.to_kv(x, dtype).split(c, -1)
        else:
            xs = x.reshape(g, self.window_size, self.window_size, c)
            q, k, v = (m(xs, dtype).reshape(g, n, c)
                       for m in (self.to_q, self.to_k, self.to_v))
        out = heads_attention(
            q * scale, k, v, self.bias(), mask, self.heads, dtype,
            drop=lambda p: self.attn_drop(p, train=train, generator=generator))
        out = self.proj(out, dtype)
        if hasattr(self, "SELayer_0"):
            out = self.SELayer_0(out, dtype)
        return self.proj_drop(out, train=train, generator=generator)


class LeFF(nn.Module):
    """The LeFF's parameters (`linear1`, `depthwise` [Ch, 1, 3, 3],
    `linear2`), which K2 reads on the fused route, and JAX's composed
    forward for the composed route (layers.py:433-445): linear1 -> GELU ->
    depthwise 3x3 -> GELU -> linear2."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.linear1 = Dense(dim, hidden_dim)
        self.depthwise = Conv(hidden_dim, hidden_dim, 3, padding=1,
                              groups=hidden_dim)
        self.linear2 = Dense(hidden_dim, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype, *,
                train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        y = gelu(self.depthwise(gelu(self.linear1(x, dtype)), dtype))
        return self.linear2(y, dtype)


class MlpFFN(nn.Module):
    """The plain transformer FFN, `token_mlp="ffn"` (layers.py:448-467):
    `Dense_0` -> GELU -> dropout -> `Dense_1` -> dropout."""

    def __init__(self, dim: int, hidden_dim: int, drop_rate: float = 0.0):
        super().__init__()
        self.Dense_0 = Dense(dim, hidden_dim)
        self.Dense_1 = Dense(hidden_dim, dim)
        self.drop = Dropout(drop_rate)

    def forward(self, x: torch.Tensor, dtype: torch.dtype, *,
                train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        kw = dict(train=train, generator=generator)
        y = self.drop(gelu(self.Dense_0(x, dtype)), **kw)
        return self.drop(self.Dense_1(y, dtype), **kw)


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
    (layers.py:470-607), computed in x's dtype. Windows of inputs no larger
    than the window are clamped to the input, unshifted (layers.py:517-518).

    `route` is "fused" where JAX's `_use_fused_attention` holds (linear
    token projection, no SE, qk_scale None, drop_rate and attn_drop_rate 0):
    roll by -shift, K1 (with `use_qkv_bias=False` it gets zero biases, as
    JAX's FusedWindowAttention), roll back, then K2 with
    `token_mlp="leff"`, or norm2 and the composed `MlpFFN` with "ffn". When
    drop_path is the identity (eval, or rate 0) the kernels add the
    residual themselves; in training with a rate they return the branch and
    the layer adds `skip + drop_path(branch)`. Else "composed": norm1 ->
    roll -> partition -> `WindowAttention` -> reverse -> roll back -> skip +
    drop_path -> norm2 -> `LeFF` or `MlpFFN` -> skip + drop_path
    (layers.py:548-603)."""

    def __init__(self, dim: int, input_resolution: tuple[int, int],
                 heads: int, window_size: int = 8, shift_size: int = 0,
                 mlp_ratio: float = 4.0, use_qkv_bias: bool = True,
                 qk_scale: float | None = None, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 token_projection: str = "linear", token_mlp: str = "leff",
                 use_se_layer: bool = False):
        super().__init__()
        if token_mlp not in ("leff", "ffn"):
            raise ValueError(f"token_mlp {token_mlp!r}")
        h, w = input_resolution
        ws, shift = window_size, shift_size
        if min(h, w) <= ws:
            ws, shift = min(h, w), 0
        if h % ws or w % ws:
            raise ValueError(f"resolution {h}x{w} not divisible by window {ws}")
        self.dim, self.heads = dim, heads
        self.input_resolution, self.window_size, self.shift = (h, w), ws, shift
        self.route = ("fused" if token_projection == "linear"
                      and not use_se_layer and qk_scale is None
                      and attn_drop_rate == 0.0 and drop_rate == 0.0
                      else "composed")
        self.token_mlp = token_mlp
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(
            dim, ws, heads, use_qkv_bias=use_qkv_bias, qk_scale=qk_scale,
            attn_drop_rate=attn_drop_rate, proj_drop_rate=drop_rate,
            token_projection=token_projection, use_se_layer=use_se_layer)
        self.norm2 = LayerNorm(dim)
        hidden = int(dim * mlp_ratio)
        self.mlp = (LeFF(dim, hidden) if token_mlp == "leff"
                    else MlpFFN(dim, hidden, drop_rate))
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
        kw = dict(train=train, generator=generator)
        if self.route == "composed":
            return self._composed(x, **kw)
        dp_identity = not train or self.drop_path.rate == 0.0
        s = self.shift
        y = torch.roll(x, (-s, -s), (1, 2)) if s else x
        a = self.attn
        bq, bkv = a.to_q.bias, a.to_kv.bias
        if bq is None:  # use_qkv_bias=False: zero biases, as JAX's
            # FusedWindowAttention passes (layers.py:223-228)
            bq = x.new_zeros(self.dim, dtype=torch.float32)
            bkv = x.new_zeros(2 * self.dim, dtype=torch.float32)
        y = fused_window_attention_2d(
            y, self.norm1.weight, self.norm1.bias, a.to_q.weight, bq,
            a.to_kv.weight, bkv, a.proj.weight, a.proj.bias, a.bias(),
            self.mask, heads=self.heads, window_size=self.window_size,
            residual=dp_identity, plain=plain)
        if s:
            y = torch.roll(y, (s, s), (1, 2))
        if not dp_identity:
            y = x + self.drop_path(y, **kw)
        if self.token_mlp == "ffn":
            z = self.mlp(self.norm2(y).to(y.dtype), y.dtype, **kw)
            return y + self.drop_path(z, **kw)
        m = self.mlp
        out = fused_leff(
            y, self.norm2.weight, self.norm2.bias, m.linear1.weight,
            m.linear1.bias, m.depthwise.weight, m.depthwise.bias,
            m.linear2.weight, m.linear2.bias, residual=dp_identity,
            plain=plain)
        if dp_identity:
            return out
        return y + self.drop_path(out, **kw)

    def _composed(self, x: torch.Tensor, **kw) -> torch.Tensor:
        """The composed route (layers.py:536-603); no kernel runs."""
        _b, h, w, _c = x.shape
        dt, s, ws = x.dtype, self.shift, self.window_size
        y = self.norm1(x).to(dt)
        if s:
            y = torch.roll(y, (-s, -s), (1, 2))
        y = self.attn(window_partition(y, ws), self.mask, dt, **kw)
        y = window_reverse(y, ws, h, w)
        if s:
            y = torch.roll(y, (s, s), (1, 2))
        # norm2 reads the residual sum before it is rounded to the stream's
        # dtype: XLA fuses the add into the LayerNorm and keeps the f32
        # value (its excess precision), so JAX's bf16 layer does the same
        y = self.drop_path(y, **kw)
        z = self.mlp(self.norm2(x.float() + y.float()).to(dt), dt, **kw)
        x = x + y
        return x + self.drop_path(z, **kw)


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
