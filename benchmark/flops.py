"""The yardstick's arithmetic: FLOPs of a forward, the work of the Swin
operators at the configuration's shapes, and the H100's peaks.

`forward_flops` is a copy of the port's closed-form count
(`fbanet_tpu_torch/tools/flops_accounting.py`, MACs x 2 per component). A
train step counts 3 x the forward; nothing recomputed is counted.

`swin_work` counts one SwinLayer operator call as its function needs, not
as a kernel computes it: each input byte read once and each output byte
written once (bf16 activations, f32 parameters and their gradients), and
the backward as its own products only. Each product of the forward has
two products in the backward (the gradient of each operand), so the
backward's tensor-core FLOPs are twice the forward's; the forward that a
kernel recomputes instead of saving is not counted.
"""

from __future__ import annotations

# NVIDIA H100 SXM at its 700 W limit (data sheet, dense): bf16 tensor
# cores, f32 on the CUDA cores, HBM3
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def conv(hw: int, cin: int, cout: int, k: int = 3, batch: int = 1) -> float:
    return batch * hw * hw * k * k * cin * cout * 2.0


def _attention_layer(hw, c, ws, batch):
    n = ws * ws
    tokens = batch * hw * hw
    nwin = tokens / n
    return (tokens * c * 3 * c * 2.0 + tokens * c * c * 2.0
            + nwin * n * n * c * 2.0 * 2)


def _leff_layer(hw, c, mlp, batch):
    tokens = batch * hw * hw
    ch = int(c * mlp)
    return tokens * c * ch * 2.0 * 2 + conv(hw, 1, ch, 3, batch)


def _swin_group(hw, c, depth, ws, mlp, batch):
    return (_attention_layer(hw, c, ws, batch)
            + _leff_layer(hw, c, mlp, batch)) * depth


def forward_flops(batch: int, size: int, frames: int, embed: int,
                  ws: int = 8, mlp: float = 4.0) -> dict[str, float]:
    """Per-component forward FLOPs of one batched FBANet forward."""
    b, s, f, d = batch, size, frames, embed
    comps = {"per-frame heads": conv(s, 3, d, 3, b * f)
             + 4 * conv(s, d, d, 3, b * f)}
    faf = conv(s, d, 1, 3, b) + conv(s, d, 1, 3, b * f)
    faf += b * s * s * (f * d) * d * 2.0
    faf += 4 * conv(s, d, d, 3, b)
    faf += b * (s // 2) ** 2 * 16 * d * 2 * d * 2.0
    faf += 4 * conv(s // 2, 2 * d, 2 * d, 3, b)
    faf += b * (s // 4) ** 2 * 16 * 2 * d * 4 * d * 2.0
    faf += 4 * conv(s // 4, 4 * d, 4 * d, 3, b)
    faf += b * (s // 2) ** 2 * 4 * d * 2 * d * 2.0
    faf += 4 * conv(s // 2, 4 * d, 4 * d, 3, b)
    faf += b * s * s * 4 * d * d * 2.0
    faf += conv(s, 2 * d, 2 * d, 3, b) * 4
    faf += conv(s, 2 * d, d, 3, b)
    comps["FAF block"] = faf
    proj = conv(s, d, d, 3, b) + conv(s, 2 * d, d, 3, b) * 2
    proj += conv(s // 2, 8 * d, 4 * d, 3, b) + conv(s, 4 * d, 2 * d, 3, b)
    comps["projections"] = proj
    hg = (_swin_group(s, d, 2, ws, mlp, b)
          + _swin_group(s // 2, 2 * d, 2, ws, mlp, b)
          + _swin_group(s // 4, 4 * d, 2, ws, mlp, b)
          + _swin_group(s // 2, 4 * d, 2, ws, mlp, b)
          + _swin_group(s, 2 * d, 2, ws, mlp, b))
    comps["attention+LeFF stacks (2 HGs)"] = 2 * hg
    updown = (b * (s // 2) ** 2 * 16 * d * 2 * d * 2.0
              + b * (s // 4) ** 2 * 16 * 2 * d * 4 * d * 2.0
              + b * (s // 2) ** 2 * 4 * d * 2 * d * 2.0
              + b * s * s * 4 * d * d * 2.0)
    comps["hourglass up/down convs (2 HGs)"] = 2 * updown
    comps["x4 tail (+out conv)"] = (conv(s, d, 4 * d, 3, b)
                                    + conv(2 * s, d, 4 * d, 3, b)
                                    + conv(2 * s, 4 * d, 12, 3, b))
    return comps


def model_flops(model: dict, batch: int) -> float:
    """Forward FLOPs of `batch` bursts under the configuration `model`."""
    return sum(forward_flops(batch, model["img_size"], model["num_frames"],
                             model["embed_dim"], model["window_size"],
                             model["mlp_ratio"]).values())


def swin_layers(model: dict, batch: int) -> list[tuple]:
    """(batch, H, C, heads, window, masked) of each SwinLayer of the model,
    in forward order (two hourglasses of five groups)."""
    d, s, ws = model["embed_dim"], model["img_size"], model["window_size"]
    groups = ((0, s, d), (1, s // 2, 2 * d), (4, s // 4, 4 * d),
              (5, s // 2, 4 * d), (6, s, 2 * d))
    out = []
    for _hg in range(2):
        for idx, h, c in groups:
            w = min(ws, h)
            for i in range(model["depths"][idx]):
                out.append((batch, h, c, model["heads"][idx], w,
                            i % 2 == 1 and h > ws))
    return out


def attention_work(batch, h, c, heads, ws, masked, backward):
    """(tensor-core FLOPs, CUDA-core FLOPs, bytes) of the fused window
    attention (LN, q | k | v, softmax(q k^T + bias + mask) v, proj) on
    [batch, h, h, c]. Forward: 8 T C^2 + 4 T n C on the tensor cores, the
    softmax 5 T n heads. Backward: dproj, dWproj 4 T C^2, dv, dp, dq, dk
    8 T n C, dx through q | k | v and dWq, dWkv 12 T C^2; the softmax's
    gradient 5 T n heads."""
    t, n = batch * h * h, ws * ws
    params = 4 * (4 * c * c + 6 * c + heads * n * n
                  + (h // ws) ** 2 * n * n * masked)
    if not backward:
        return 8 * t * c * c + 4 * t * n * c, 5 * t * n * heads, \
            4 * t * c + params
    grads = 4 * (4 * c * c + 6 * c + heads * n * n)
    return 16 * t * c * c + 8 * t * n * c, 5 * t * n * heads, \
        6 * t * c + params + grads


def leff_work(batch, h, c, mlp, backward):
    """(tensor-core FLOPs, CUDA-core FLOPs, bytes) of the fused LeFF (LN,
    dense1, GELU, depthwise 3x3, GELU, dense2) on [batch, h, h, c].
    Forward: 4 T C Ch, the taps 18 T Ch. Backward: dh2, dW2, dy, dW1
    8 T C Ch; the taps' transpose and their gradients 36 T Ch."""
    t, ch = batch * h * h, int(c * mlp)
    params = 4 * (2 * c * ch + 11 * ch + 3 * c)
    if not backward:
        return 4 * t * c * ch, 18 * t * ch, 4 * t * c + params
    return 8 * t * c * ch, 36 * t * ch, 6 * t * c + 2 * params


def bound_s(tc: float, cuda: float, nbytes: float) -> float:
    """The least seconds the chip could take: the larger of the operations
    over their peaks and the bytes over the memory rate."""
    return max(tc / PEAK_BF16 + cuda / PEAK_F32, nbytes / PEAK_BYTES)


def swin_bound_s(model: dict, batch: int, backward: bool) -> float:
    """Summed bound of the model's SwinLayer operators (attention and LeFF)
    for one forward (or one backward) of `batch` rows."""
    total = 0.0
    for b, h, c, heads, ws, masked in swin_layers(model, batch):
        total += bound_s(*attention_work(b, h, c, heads, ws, masked, backward))
        total += bound_s(*leff_work(b, h, c, model["mlp_ratio"], backward))
    return total
