"""LPIPS perceptual metric, AlexNet variant (counterpart of
fbanet_tpu/models/lpips.py): the reference's `lpips.LPIPS(net="alex")`
metric at eval (fba_net/utils/image_utils.py:200-228, boundary_ignore 40).

The pretrained AlexNet and linear-head weights come from a `.npz` the user
supplies, in the JAX package's layout (HWIO convs, `[C]` heads, written by
`scripts/export_lpips_weights.py`); `load_lpips` reads it and transposes
the convs to torch's OIHW once. `convert_state_dict` turns the `lpips`
package's own state_dict into that layout, so a user with the package's
weights needs no JAX. `random_initialized_lpips(seed)` draws the same numpy
values as the JAX package's, for tests and plumbing (not a valid metric).

The forward is the published formulation: scaling layer, AlexNet's five
conv + ReLU stages (3x3 stride-2 max pools before the second and third),
per-position unit normalisation over channels (eps 1e-10), squared
difference, non-negative 1x1 heads and a spatial mean, summed over the
five stages. As in the reference, [0, 1] inputs go in without lpips'
`normalize=True` rescale to [-1, 1] (`assume_reference_range=True`).
The convolutions and pools are `F.conv2d` / `F.max_pool2d`, in f32.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# AlexNet feature stack: (out_channels, kernel, stride, padding, pool_before)
_ALEX_LAYERS = (
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
)


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """LPIPS distance; `forward(pred, target)` on `[B, H, W, 3]` in [0, 1]
    gives `[B]`. The weights are buffers (a metric, never trained), so
    `.to(device)` moves them."""

    def __init__(self, weights: dict[str, np.ndarray],
                 assume_reference_range: bool = True) -> None:
        super().__init__()
        self.assume_reference_range = assume_reference_range
        f32 = np.float32
        self.register_buffer("shift", torch.from_numpy(
            np.asarray(weights["shift"], f32).reshape(1, 3, 1, 1)))
        self.register_buffer("scale", torch.from_numpy(
            np.asarray(weights["scale"], f32).reshape(1, 3, 1, 1)))
        for i in range(len(_ALEX_LAYERS)):
            hwio = np.asarray(weights[f"conv{i}_w"], f32)
            self.register_buffer(f"conv{i}_w", torch.from_numpy(
                np.ascontiguousarray(hwio.transpose(3, 2, 0, 1))))
            self.register_buffer(f"conv{i}_b", torch.from_numpy(
                np.asarray(weights[f"conv{i}_b"], f32)))
            self.register_buffer(f"lin{i}_w", torch.from_numpy(
                np.asarray(weights[f"lin{i}_w"], f32).reshape(1, -1, 1, 1)))

    def _features(self, x: torch.Tensor) -> list[torch.Tensor]:
        if not self.assume_reference_range:
            x = 2.0 * x - 1.0
        x = (x - self.shift) / self.scale
        feats = []
        for i, (_c, _k, s, p, pool) in enumerate(_ALEX_LAYERS):
            if pool:
                x = F.max_pool2d(x, 3, stride=2)
            x = torch.relu(F.conv2d(x, getattr(self, f"conv{i}_w"),
                                    getattr(self, f"conv{i}_b"), stride=s,
                                    padding=p))
            feats.append(x)
        return feats

    @torch.no_grad()
    def forward(self, pred: torch.Tensor, target: torch.Tensor,
                boundary_ignore: int | None = None) -> torch.Tensor:
        """Per-image LPIPS distance [B] of `[B, H, W, 3]` images in [0, 1],
        `boundary_ignore` pixels cropped from every side first."""
        if boundary_ignore:
            b = boundary_ignore
            pred = pred[:, b:-b, b:-b, :]
            target = target[:, b:-b, b:-b, :]
        f1 = self._features(pred.float().permute(0, 3, 1, 2))
        f2 = self._features(target.float().permute(0, 3, 1, 2))
        total = torch.zeros(pred.shape[0], device=pred.device)
        for i, (a, c) in enumerate(zip(f1, f2)):
            diff = (_unit_normalize(a) - _unit_normalize(c)) ** 2
            lin = getattr(self, f"lin{i}_w")
            total = total + (diff * lin).sum(1).mean(dim=(1, 2))
        return total


def load_lpips(path: str | Path, assume_reference_range: bool = True
               ) -> LPIPS:
    """LPIPS from a `.npz` in the JAX package's layout, on the CPU."""
    with np.load(path) as data:
        return LPIPS(dict(data), assume_reference_range=assume_reference_range)


def random_lpips_weights(seed: int = 0) -> dict[str, np.ndarray]:
    """The JAX package's `random_initialized_lpips` draws, in its layout."""
    rng = np.random.default_rng(seed)
    w: dict[str, np.ndarray] = {
        "shift": np.array([-0.030, -0.088, -0.188], np.float32),
        "scale": np.array([0.458, 0.448, 0.450], np.float32),
    }
    cin = 3
    for i, (cout, k, _s, _p, _pool) in enumerate(_ALEX_LAYERS):
        w[f"conv{i}_w"] = rng.normal(0, 0.05, (k, k, cin, cout)).astype(
            np.float32)
        w[f"conv{i}_b"] = np.zeros(cout, np.float32)
        w[f"lin{i}_w"] = rng.uniform(0, 0.1, (cout,)).astype(np.float32)
        cin = cout
    return w


def random_initialized_lpips(seed: int = 0) -> LPIPS:
    """Architecture smoke-test instance (random weights, NOT a valid
    perceptual metric; for tests and plumbing only)."""
    return LPIPS(random_lpips_weights(seed))


def convert_state_dict(sd: dict) -> dict[str, np.ndarray]:
    """`lpips.LPIPS(net="alex")` state_dict (numpy values) -> the `.npz`
    layout (a copy of scripts/export_lpips_weights.py's):

    - `scaling_layer.{shift,scale}` [1, 3, 1, 1] -> `shift`, `scale` [3];
    - the five `net.slice*.N.weight` convs, OIHW, in layer order ->
      `conv{i}_w` HWIO and `conv{i}_b`;
    - `lin{i}.model.1.weight` [1, C, 1, 1] -> `lin{i}_w` [C].
    """
    out: dict[str, np.ndarray] = {
        "shift": sd["scaling_layer.shift"].reshape(3).astype(np.float32),
        "scale": sd["scaling_layer.scale"].reshape(3).astype(np.float32),
    }
    # torchvision alexnet.features conv indices inside lpips' AlexNet slices
    conv_keys = [k for k in sd if k.startswith("net.") and k.endswith(".weight")
                 and sd[k].ndim == 4]
    conv_keys.sort(key=lambda k: int(k.split(".")[2]))
    if len(conv_keys) != 5:
        raise ValueError(f"expected AlexNet's 5 convs, got {conv_keys}")
    for i, k in enumerate(conv_keys):
        out[f"conv{i}_w"] = sd[k].transpose(2, 3, 1, 0).astype(np.float32)
        out[f"conv{i}_b"] = sd[k.replace(".weight", ".bias")].astype(
            np.float32)
    for i in range(5):
        out[f"lin{i}_w"] = sd[f"lin{i}.model.1.weight"].reshape(-1).astype(
            np.float32)
    return out
