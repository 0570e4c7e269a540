"""FBANet in plain PyTorch, float32: the benchmark's frozen reference.

A copy of the model's equations (upstream yjsunnn/FBANet, as the port and
its JAX original compute them), written without any kernel, fused path or
rounding point of the program under test. The module tree and parameter
names equal the program's, so one state dict loads into both.

    per-frame head conv + 2 ResBlocks -> FAF (affinity gate, 1x1 fusion
    over frames, PReLU, conv hourglass) -> ConvProj -> two Swin hourglasses
    (HG2 reads HG1's skips through proj0 / proj1) -> ConvProj -> x4 tail
    (conv, shuffle, conv, shuffle, conv) + bilinear base of frame 0

Feature maps are channels-last `[B, H, W, C]`. Every product (linear,
convolution, attention) takes its operands through `prec.q`: the identity
in float32, a rounding to a lower precision for the control run
(`reference.precision`). Stochastic depth reads per-sample keep masks that
the caller drew (`draw_masks`), one per residual branch in forward order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.precision import F32, Precision


def conv(x, weight, bias, prec: Precision, *, stride=1, padding=0, groups=1):
    """A conv on `[B, H, W, C]` with a torch `[O, I, k, k]` weight."""
    y = F.conv2d(prec.q(x).permute(0, 3, 1, 2), prec.q(weight), bias,
                 stride=stride, padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


def linear(x, weight, bias, prec: Precision):
    y = prec.q(x) @ prec.q(weight).t()
    return y if bias is None else y + bias


class Conv(nn.Module):
    def __init__(self, cin, cout, k, *, stride=1, padding=0, groups=1,
                 bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.padding, self.groups = stride, padding, groups

    def forward(self, x, prec):
        return conv(x, self.weight, self.bias, prec, stride=self.stride,
                    padding=self.padding, groups=self.groups)


class Dense(nn.Module):
    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None


class LayerNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, 1e-5)


class PReLU(nn.Module):
    def __init__(self, init_alpha=0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), init_alpha))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight * x)


class ResBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.Conv_0 = Conv(c, c, 3, padding=1)
        self.Conv_1 = Conv(c, c, 3, padding=1)

    def forward(self, x, prec):
        return x + self.Conv_1(torch.relu(self.Conv_0(x, prec)), prec)


class Downsample(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, 4, stride=2, padding=1)

    def forward(self, x, prec):
        return self.Conv_0(x, prec)


class ConvTranspose(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, 2, 2))
        self.bias = nn.Parameter(torch.zeros(cout))


class Upsample(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(cin, cout)

    def forward(self, x, prec):
        p = self.ConvTranspose_0
        y = F.conv_transpose2d(prec.q(x).permute(0, 3, 1, 2),
                               prec.q(p.weight), p.bias, stride=2)
        return y.permute(0, 2, 3, 1)


class ConvProj(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, 3, padding=1)
        self.PReLU_0 = PReLU()

    def forward(self, x, prec):
        return self.PReLU_0(self.Conv_0(x, prec))


def pixel_shuffle(x, s):
    b, h, w, csq = x.shape
    c = csq // (s * s)
    x = x.reshape(b, h, w, c, s, s).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * s, w * s, c)


class FAFBlock(nn.Module):
    """Federated affinity fusion: each frame gated by sigmoid(|s_k - s_0|),
    s_k the channel sum of the frame's embedding (temporal_attn1, its
    channel-summed kernel applied depthwise; the reference frame's own
    embedding and both biases cancel), then the 1x1 fusion over (frame,
    channel), PReLU and a two-level conv hourglass with concat skips."""

    def __init__(self, c, f):
        super().__init__()
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

    def _res2(self, i, x, prec):
        x = getattr(self, f"res{i}_0")(x, prec)
        return getattr(self, f"res{i}_1")(x, prec)

    def forward(self, frames, prec):
        b, f, h, w, c = frames.shape
        wsum = self.temporal_attn1.weight.sum(0)[:, None]  # [C, 1, 3, 3]
        xn = frames.reshape(b * f, h, w, c)
        s = conv(xn, wsum, None, prec, padding=1, groups=c).sum(-1)
        s = s.reshape(b, f, h, w)
        gate = torch.sigmoid((s - s[:, :1]).abs())
        gate = torch.cat([torch.ones_like(gate[:, :1]), gate[:, 1:]], 1)
        guided = frames * gate[..., None]
        wff = self.feature_fusion.weight.reshape(c, f, c)  # [o, f, c]
        feat = torch.einsum("bfhwc,ofc->bhwo", prec.q(guided), prec.q(wff))
        feat = self.feature_fusion_act(feat + self.feature_fusion.bias)
        f0 = self._res2(0, feat, prec)
        f1 = self._res2(1, self.down0(f0, prec), prec)
        f2 = self._res2(2, self.down1(f1, prec), prec)
        f3 = self._res2(3, torch.cat([self.up0(f2, prec), f1], -1), prec)
        f4 = self._res2(4, torch.cat([self.up1(f3, prec), f0], -1), prec)
        return self.fusion_tail(f4, prec) + feat


def relative_position_index(ws):
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return rel[:, :, 0] * (2 * ws - 1) + rel[:, :, 1]


def shift_mask(h, w, ws, shift):
    """Additive SW-MSA mask [windows, N, N]: -100 between regions."""
    ids = np.zeros((h, w), np.int64)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            ids[hs, wsl] = cnt
            cnt += 1
    idw = ids.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    idw = idw.reshape(-1, ws * ws)
    return (idw[:, :, None] != idw[:, None, :]).astype(np.float32) * -100.0


class WindowAttention(nn.Module):
    def __init__(self, dim, ws, heads):
        super().__init__()
        self.to_q = Dense(dim, dim)
        self.to_kv = Dense(dim, 2 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, heads))
        self.proj = Dense(dim, dim)


class LeFF(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.linear1 = Dense(dim, hidden)
        self.depthwise = Conv(hidden, hidden, 3, padding=1, groups=hidden)
        self.linear2 = Dense(hidden, dim)


class SwinLayer(nn.Module):
    """LN -> (shifted) window attention with relative-position bias ->
    residual; LN -> LeFF (linear, GELU, depthwise 3x3, GELU, linear) ->
    residual; each branch under stochastic depth. GELU is the tanh form."""

    def __init__(self, dim, res, heads, ws, shift, mlp_ratio, rate):
        super().__init__()
        if res <= ws:
            ws, shift = res, 0
        self.dim, self.heads, self.res, self.ws, self.shift = (
            dim, heads, res, ws, shift)
        self.rate = rate
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, ws, heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = LeFF(dim, int(dim * mlp_ratio))
        self.register_buffer("rel_index", torch.from_numpy(
            relative_position_index(ws)).reshape(-1), persistent=False)
        self.register_buffer("mask", torch.from_numpy(
            shift_mask(res, res, ws, shift)) if shift else None,
            persistent=False)

    def attention(self, x, prec):
        b, h, w, c = x.shape
        ws, s, nh = self.ws, self.shift, self.heads
        dh, n = c // nh, ws * ws
        a = self.attn
        y = self.norm1(x)
        if s:
            y = torch.roll(y, (-s, -s), (1, 2))
        y = y.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        y = y.reshape(-1, n, c)
        q = linear(y, a.to_q.weight, a.to_q.bias, prec) * dh ** -0.5
        k, v = linear(y, a.to_kv.weight, a.to_kv.bias, prec).split(c, -1)

        def split(t):
            return t.reshape(-1, n, nh, dh).transpose(1, 2)

        logits = prec.q(split(q)) @ prec.q(split(k)).transpose(-1, -2)
        bias = a.relative_position_bias_table[self.rel_index]
        logits = logits + bias.reshape(n, n, nh).permute(2, 0, 1)[None]
        if self.mask is not None:
            nw = self.mask.shape[0]
            logits = (logits.reshape(-1, nw, nh, n, n)
                      + self.mask[None, :, None]).reshape(-1, nh, n, n)
        o = prec.q(torch.softmax(logits, -1)) @ prec.q(split(v))
        o = o.transpose(1, 2).reshape(-1, n, c)
        o = linear(o, a.proj.weight, a.proj.bias, prec)
        o = o.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        o = o.reshape(b, h, w, c)
        return torch.roll(o, (s, s), (1, 2)) if s else o

    def leff(self, x, prec):
        m = self.mlp
        y = self.norm2(x)
        y = F.gelu(linear(y, m.linear1.weight, m.linear1.bias, prec),
                   approximate="tanh")
        y = F.gelu(m.depthwise(y, prec), approximate="tanh")
        return linear(y, m.linear2.weight, m.linear2.bias, prec)

    def forward(self, x, prec, masks):
        x = x + drop_path(self.attention(x, prec), self.rate, masks)
        return x + drop_path(self.leff(x, prec), self.rate, masks)


def drop_path(branch, rate, masks):
    """Per-sample stochastic depth: the next of `masks` (a keep mask [B])
    scales kept samples by 1 / (1 - rate). No mask is drawn at rate 0 or
    outside training (`masks` None)."""
    if masks is None or rate == 0.0:
        return branch
    keep = next(masks).reshape(-1, *([1] * (branch.dim() - 1)))
    return torch.where(keep, branch / (1.0 - rate), torch.zeros_like(branch))


def drop_path_rates(depths, rate):
    """Per group index (0, 1, 4, 5, 6) the layers' rates: linear over the
    encoder, constant in the bottleneck, the encoder's reversed in the
    decoder."""
    n_enc = sum(depths[:len(depths) // 2])
    enc = [float(r) for r in np.linspace(0, rate, n_enc)]
    dec = enc[::-1]
    return {0: enc[:depths[0]], 1: enc[depths[0]:depths[0] + depths[1]],
            4: [float(rate)] * depths[4], 5: dec[:depths[5]],
            6: dec[depths[5]:depths[5] + depths[6]]}


class SwinGroup(nn.Module):
    def __init__(self, dim, res, depth, heads, ws, mlp_ratio, rates):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"layer{i}", SwinLayer(
                dim, res, heads, ws, 0 if i % 2 == 0 else ws // 2, mlp_ratio,
                rates[i]))

    def forward(self, x, prec, masks):
        for i in range(self.depth):
            x = getattr(self, f"layer{i}")(x, prec, masks)
        return x


class TailUpsampler(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv0 = Conv(c, 4 * c, 3, padding=1)
        self.conv1 = Conv(c, 4 * c, 3, padding=1)


class FBANet(nn.Module):
    """`[B, F, H, W, C]` in [0, 1] -> `[B, 4H, 4W, C]`, float32."""

    def __init__(self, model: dict):
        super().__init__()
        self.cfg = model
        d, h, cin, f = (model["embed_dim"], model["img_size"],
                        model["in_channels"], model["num_frames"])
        depths, heads = model["depths"], model["heads"]
        ws = model["window_size"]
        mlp = model["mlp_ratio"]
        rates = drop_path_rates(depths, model["drop_path_rate"])
        self.head = Conv(cin, d, 3, padding=1)
        self.body0 = ResBlock(d)
        self.body1 = ResBlock(d)
        self.fusion = FAFBlock(d, f)
        self.input_proj = ConvProj(d, d)

        def swin(dim, res, idx):
            return SwinGroup(dim, res, depths[idx], heads[idx], ws, mlp,
                             rates[idx])

        for tag in ("HG1", "HG2"):
            mods = {"enc0": swin(d, h, 0), "down0": Downsample(d, 2 * d),
                    "enc1": swin(2 * d, h // 2, 1),
                    "down1": Downsample(2 * d, 4 * d),
                    "bottleneck": swin(4 * d, h // 4, 4),
                    "up0": Upsample(4 * d, 2 * d),
                    "dec0": swin(4 * d, h // 2, 5),
                    "up1": Upsample(4 * d, d), "dec1": swin(2 * d, h, 6)}
            if tag == "HG2":
                mods["proj0"] = ConvProj(8 * d, 4 * d)
                mods["proj1"] = ConvProj(4 * d, 2 * d)
            for name, mod in mods.items():
                self.add_module(f"{tag}_{name}", mod)
        self.output_proj = ConvProj(2 * d, d)
        self.output_proj_2 = ConvProj(2 * d, d)
        self.tail_upsampler = TailUpsampler(d)
        self.tail_conv = Conv(d, cin, 3, padding=1)

    def _hourglass(self, tag, y, cross, prec, masks):
        m = lambda name: getattr(self, f"{tag}_{name}")  # noqa: E731
        conv0 = m("enc0")(y, prec, masks)
        conv1 = m("enc1")(m("down0")(conv0, prec), prec, masks)
        conv2 = m("bottleneck")(m("down1")(conv1, prec), prec, masks)
        up0 = m("up0")(conv2, prec)
        dec0_in = (torch.cat([up0, conv1], -1) if cross is None else
                   m("proj0")(torch.cat([cross[0], cross[1], up0, conv1], -1),
                              prec))
        dec0 = m("dec0")(dec0_in, prec, masks)
        up1 = m("up1")(dec0, prec)
        dec1_in = (torch.cat([up1, conv0], -1) if cross is None else
                   m("proj1")(torch.cat([cross[2], cross[3], up1, conv0], -1),
                              prec))
        return m("dec1")(dec1_in, prec, masks), (up0, conv1, up1, conv0)

    def forward(self, burst, prec: Precision = F32, masks=None):
        """`masks`: the keep masks of this batch's rows in forward order
        (`draw_masks`), or None for evaluation."""
        masks = None if masks is None else iter(masks)
        b, f, h, w, cin = burst.shape
        d = self.cfg["embed_dim"]
        xf = self.head(burst.reshape(b * f, h, w, cin), prec)
        xf = self.body1(self.body0(xf, prec), prec)
        y = self.input_proj(self.fusion(xf.reshape(b, f, h, w, d), prec), prec)
        y, cross = self._hourglass("HG1", y, None, prec, masks)
        y, _ = self._hourglass("HG2", self.output_proj(y, prec), cross, prec,
                               masks)
        y = self.output_proj_2(y, prec)
        t = self.tail_upsampler
        y = pixel_shuffle(t.conv0(y, prec), 2)
        y = pixel_shuffle(t.conv1(y, prec), 2)
        out = self.tail_conv(y, prec)
        base = F.interpolate(burst[:, 0].permute(0, 3, 1, 2),
                             size=(4 * h, 4 * w), mode="bilinear",
                             align_corners=False).permute(0, 2, 3, 1)
        return out + base

    def drop_rates(self):
        """The rates of the residual branches in forward order (two per
        SwinLayer), zero rates included."""
        out = []
        for tag in ("HG1", "HG2"):
            for g in ("enc0", "enc1", "bottleneck", "dec0", "dec1"):
                grp = getattr(self, f"{tag}_{g}")
                for i in range(grp.depth):
                    r = getattr(grp, f"layer{i}").rate
                    out += [r, r]
        return out


def draw_masks(rates, batch: int, generator: torch.Generator):
    """The keep masks of one step, drawn as the model under test draws
    them: for each branch of nonzero rate, in forward order, one
    `bernoulli_(1 - rate)` of `batch` values from `generator`."""
    out = []
    for r in rates:
        if r == 0.0:
            continue
        bits = torch.empty(batch, device=generator.device).bernoulli_(
            1.0 - r, generator=generator)
        out.append(bits.bool())
    return out


def parameter_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())

