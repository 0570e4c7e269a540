"""The FBANet model in PyTorch (counterpart of fbanet_tpu/models/fbanet.py):
per-frame features -> FAF fusion -> two window-attention hourglasses ->
x4 tail + bilinear base. `[B, F, H, W, 3] -> [B, 4H, 4W, 3]`; eval by
default, training (stochastic depth) with `train=True` and a generator."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fbanet_tpu_torch.config import ModelConfig
from fbanet_tpu_torch.models.blocks import (
    FAFBlock,
    ResBlock,
    SwinGroup,
    TailUpsampler,
    tail_x4_direct,
)
from fbanet_tpu_torch.models.layers import (
    Conv,
    ConvProj,
    Downsample,
    Dropout,
    Upsample,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class FBANet(nn.Module):
    """The flagship burst SR model ("BaseModel"). Parameters are f32; the
    network computes in `cfg.dtype`, the bilinear base and the output in
    f32. Only depths/heads indices 0, 1, 4, 5, 6 are used, as in JAX."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.param_dtype != "float32":
            raise NotImplementedError(f"param_dtype {cfg.param_dtype}")
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.dtype]
        d, h, cin = cfg.embed_dim, cfg.img_size, cfg.in_channels
        self.head = Conv(cin, d, 3, padding=1)
        self.body0 = ResBlock(d)
        self.body1 = ResBlock(d)
        self.fusion = FAFBlock(d, cfg.num_frames)
        self.input_proj = ConvProj(d, d)
        self.pos_drop = Dropout(cfg.drop_rate)  # fbanet.py:66
        layer_kw = dict(
            mlp_ratio=cfg.mlp_ratio, use_qkv_bias=cfg.use_qkv_bias,
            qk_scale=cfg.qk_scale, drop_rate=cfg.drop_rate,
            attn_drop_rate=cfg.attn_drop_rate,
            token_projection=cfg.token_projection, token_mlp=cfg.token_mlp,
            use_se_layer=cfg.use_se_layer)

        # stochastic-depth schedule (fbanet.py:69-72): linear over the
        # encoder, constant in the bottleneck, the encoder's reversed in the
        # decoder
        dp = cfg.drop_path_rate
        enc = [float(r) for r in np.linspace(
            0, dp, sum(cfg.depths[:len(cfg.depths) // 2]))]
        dec = enc[::-1]
        dd = cfg.depths
        rates = {0: enc[:dd[0]], 1: enc[dd[0]:dd[0] + dd[1]],
                 4: [float(dp)] * dd[4], 5: dec[:dd[5]],
                 6: dec[dd[5]:dd[5] + dd[6]]}

        def swin(dim: int, res: int, idx: int) -> SwinGroup:
            return SwinGroup(dim, (res, res), cfg.depths[idx], cfg.heads[idx],
                             window_size=cfg.window_size,
                             drop_path_rates=rates[idx], **layer_kw)

        for tag in ("HG1", "HG2"):
            mods = {
                "enc0": swin(d, h, 0),
                "down0": Downsample(d, 2 * d),
                "enc1": swin(2 * d, h // 2, 1),
                "down1": Downsample(2 * d, 4 * d),
                "bottleneck": swin(4 * d, h // 4, 4),
                "up0": Upsample(4 * d, 2 * d),
                "dec0": swin(4 * d, h // 2, 5),
                "up1": Upsample(4 * d, d),
                "dec1": swin(2 * d, h, 6),
            }
            if tag == "HG2":  # cross-hourglass skip projections
                mods["proj0"] = ConvProj(8 * d, 4 * d)  # up0, conv1 x 2
                mods["proj1"] = ConvProj(4 * d, 2 * d)  # up1, conv0 x 2
            for name, mod in mods.items():
                self.add_module(f"{tag}_{name}", mod)
        self.output_proj = ConvProj(2 * d, d)
        self.output_proj_2 = ConvProj(2 * d, d)
        self.tail_upsampler = TailUpsampler(d)
        self.tail_conv = Conv(d, cin, 3, padding=1)

    def _hourglass(self, tag: str, y: torch.Tensor, cross, plain: bool,
                   swin_kw: dict):
        """One encoder/bottleneck/decoder hourglass (fbanet.py:90-132);
        `cross` carries HG1's (up0, conv1, up1, conv0) into HG2."""
        m = lambda name: getattr(self, f"{tag}_{name}")  # noqa: E731
        dt = self.dtype
        conv0 = m("enc0")(y, plain, **swin_kw)
        conv1 = m("enc1")(m("down0")(conv0, dt), plain, **swin_kw)
        conv2 = m("bottleneck")(m("down1")(conv1, dt), plain, **swin_kw)
        up0 = m("up0")(conv2, dt)
        if cross is None:
            dec0_in = torch.cat([up0, conv1], -1)
        else:
            dec0_in = m("proj0")(torch.cat([cross[0], cross[1], up0, conv1], -1), dt)
        dec0 = m("dec0")(dec0_in, plain, **swin_kw)
        up1 = m("up1")(dec0, dt)
        if cross is None:
            dec1_in = torch.cat([up1, conv0], -1)
        else:
            dec1_in = m("proj1")(torch.cat([cross[2], cross[3], up1, conv0], -1), dt)
        return (m("dec1")(dec1_in, plain, **swin_kw),
                (up0, conv1, up1, conv0))

    def forward_with_features(self, burst: torch.Tensor, plain: bool = False,
                              *, train: bool = False,
                              generator: torch.Generator | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
        """(output [B, 4H, 4W, cin] f32, HG2 features before the tail
        [B, H, W, D]). `plain=True` runs the fused operators' plain versions
        on any device (the kernel-vs-plain comparison of the whole slice).
        `train=True` applies stochastic depth and, with a `drop_rate`,
        dropout, with masks drawn from `generator` (the JAX model's
        `deterministic=False`)."""
        cfg, dt = self.cfg, self.dtype
        b, f, h, w, cin = burst.shape
        if (f, h, w, cin) != (cfg.num_frames, cfg.img_size, cfg.img_size,
                              cfg.in_channels):
            raise ValueError(f"burst {tuple(burst.shape)} does not match the "
                             f"config ({cfg.num_frames} frames, "
                             f"{cfg.img_size}px, {cfg.in_channels} ch)")
        d = cfg.embed_dim
        xf = burst.to(dt).reshape(b * f, h, w, cin)
        xf = self.body1(self.body0(self.head(xf, dt), dt), dt)
        fused = self.fusion(xf.reshape(b, f, h, w, d), dt)
        swin_kw = dict(train=train, generator=generator)
        y = self.pos_drop(self.input_proj(fused, dt), **swin_kw)

        deconv1, cross = self._hourglass("HG1", y, None, plain, swin_kw)
        y_1 = self.output_proj(deconv1, dt)
        deconv1_2, _ = self._hourglass("HG2", y_1, cross, plain, swin_kw)
        y_2 = self.output_proj_2(deconv1_2, dt)

        t = self.tail_upsampler
        out = tail_x4_direct(y_2, t.conv0.weight, t.conv0.bias, t.conv1.weight,
                             t.conv1.bias, self.tail_conv.weight,
                             self.tail_conv.bias, dt)
        base = F.interpolate(burst[:, 0].float().permute(0, 3, 1, 2),
                             size=(4 * h, 4 * w), mode="bilinear",
                             align_corners=False).permute(0, 2, 3, 1)
        return out.float() + base, y_2

    def forward(self, burst: torch.Tensor, plain: bool = False, *,
                train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return self.forward_with_features(burst, plain, train=train,
                                          generator=generator)[0]


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init at the JAX init's scales: lecun-normal weights (truncated
    at 2 std), zero biases, unit LayerNorm scales, trunc-normal(0.02) bias
    tables, PReLU slopes as constructed, and a zero `tail_conv` so a fresh
    model outputs exactly its bilinear base (fbanet.py:148-160)."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        parent = name.rsplit(".", 2)[-2] if "." in name else ""
        if name.startswith("tail_conv.") or leaf == "bias":
            p.zero_()
        elif parent.startswith("norm") or p.shape == (1,):
            continue  # LayerNorm ones / PReLU slopes from the constructor
        elif leaf == "relative_position_bias_table":
            nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04, generator=generator)
        else:
            fan_in = p[0].numel()
            if "ConvTranspose" in name:  # [I, O, kh, kw]: flax fan-in kh*kw*I
                fan_in = p.shape[0] * p.shape[2] * p.shape[3]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)


def create_model(cfg: ModelConfig, device: torch.device | str | None = None,
                 seed: int = 0) -> FBANet:
    """FBANet with seeded parameters, in eval mode, on `device`: the card
    unless the caller asks for another (`device="cpu"`). Raises when no CUDA
    device is present and none was named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("create_model: no CUDA device; pass "
                               "device='cpu' to build the model on the CPU")
        device = "cuda"
    model = FBANet(cfg)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
