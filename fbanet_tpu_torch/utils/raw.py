"""RealBSR-RAW support: packed-Bayer pack / unpack and the reference's
display post-processing, on tensors of any device (counterpart of
fbanet_tpu/utils/raw.py).

The RAW variant of RealBSR stores bursts as 4-channel packed Bayer (RGGB)
normalised by 16383. `postprocess_raw` is the reference's visualisation
(fba_net/utils/post_processing_vis.py), channels-last: norm factor, black
level, camera white balance over the green gain, brightness normalisation
by 5 x the mean (or an external factor), clip, gamma 1/2.2 and a
smoothstep curve; `return_rgb` collapses the two greens to one.

The metadata key `while_balance_applied` keeps the reference's spelling.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def pack_bayer(raw: torch.Tensor) -> torch.Tensor:
    """[..., 2H, 2W] RGGB mosaic -> packed [..., H, W, 4] (R, G1, G2, B)."""
    return torch.stack([raw[..., 0::2, 0::2], raw[..., 0::2, 1::2],
                        raw[..., 1::2, 0::2], raw[..., 1::2, 1::2]], dim=-1)


def unpack_bayer(packed: torch.Tensor) -> torch.Tensor:
    """Packed [..., H, W, 4] -> [..., 2H, 2W] RGGB mosaic."""
    *lead, h, w, _ = packed.shape
    out = packed.new_zeros((*lead, 2 * h, 2 * w))
    out[..., 0::2, 0::2] = packed[..., 0]
    out[..., 0::2, 1::2] = packed[..., 1]
    out[..., 1::2, 0::2] = packed[..., 2]
    out[..., 1::2, 1::2] = packed[..., 3]
    return out


def _per_channel(values, c: int, like: torch.Tensor) -> torch.Tensor:
    """Metadata values as f32 on `like`'s device; 4 values for a 3-channel
    image collapse to (v0, (v1 + v2) / 2, v3)."""
    v = torch.as_tensor(values, dtype=torch.float32, device=like.device)
    if c == 3 and v.shape[-1] == 4:
        v = torch.stack([v[0], (v[1] + v[2]) / 2, v[3]])
    return v


def postprocess_raw(
    im: torch.Tensor,
    meta_data: Mapping[str, Any] | None = None,
    *,
    black_level_subtracted: bool = True,
    external_norm_factor: float | None = None,
    gamma: bool = True,
    smoothstep: bool = True,
    no_white_balance: bool = False,
    return_rgb: bool = False,
) -> torch.Tensor:
    """Packed-Bayer `[..., H, W, 4]` (or RGB `[..., H, W, 3]`) -> a display
    image in [0, 1]. The brightness normalisation divides by 5 x the mean
    of the whole tensor (every image of a batch together, as the JAX
    package does). With `return_rgb`, a 4-channel input is collapsed to RGB
    by averaging the two greens (post_processing_vis.py:41)."""
    meta = dict(meta_data or {})
    c = im.shape[-1]
    im = im.float() * meta.get("norm_factor", 16383.0)

    if (not meta.get("black_level_subtracted", False)
            and not black_level_subtracted and "black_level" in meta):
        im = im - _per_channel(meta["black_level"], c, im)

    if (not meta.get("while_balance_applied", False) and not no_white_balance
            and "cam_wb" in meta):
        wb = torch.as_tensor(meta["cam_wb"], dtype=torch.float32,
                             device=im.device)
        im = im * _per_channel(meta["cam_wb"], c, im) / wb[1]

    if external_norm_factor is None:
        im = im / (im.mean() * 5.0)
    else:
        im = im / external_norm_factor

    im = im.clamp(0.0, 1.0)
    if gamma:
        im = im ** (1.0 / 2.2)
    if smoothstep:
        im = 3 * im ** 2 - 2 * im ** 3

    if return_rgb and c == 4:
        im = torch.stack([im[..., 0], (im[..., 1] + im[..., 2]) / 2,
                          im[..., 3]], dim=-1)
    return im


def to_uint8(im01: torch.Tensor | np.ndarray) -> np.ndarray:
    """[0, 1] image -> uint8 on the host (x 255, clipped, truncated, as
    the JAX package's `to_uint8`)."""
    if isinstance(im01, torch.Tensor):
        im01 = im01.detach().float().cpu().numpy()
    return np.clip(np.asarray(im01) * 255.0, 0, 255).astype(np.uint8)
