"""JAX parameter trees -> torch state_dicts, and seeded random parameters.

`jax_params_to_state_dict` takes the flax parameter tree as nested dicts of
numpy arrays (`jax.tree.map(np.asarray, params)`) and applies the same key
and layout rules as `fbanet_tpu/utils/torch_io.py::flax_to_torch_state_dict`,
without flax:

    Conv kernel           [Kh, Kw, I, O] -> [O, I, Kh, Kw]
    ConvTranspose kernel  [Kh, Kw, I, O] -> [I, O, Kh, Kw], spatially flipped
    Dense kernel          [I, O]         -> [O, I]
    PReLU alpha           scalar         -> [1]
    kernel/scale/alpha    leaf names     -> weight

The port's modules carry exactly these names (flax auto-names included), so
`model.load_state_dict(sd, strict=True)` needs no rename table. That holds
for every configuration the JAX model builds: the depthwise kernels of
`SepConv2d` ([3, 3, 1, C] -> [C, 1, 3, 3], `attn.to_q.depthwise` and the
like with `token_projection="conv"`), Dense and Conv layers without a bias
(no `bias` key), the SE gate `attn.SELayer_0.Dense_{0,1}` and the FFN
`mlp.Dense_{0,1}` (`tests/test_torch_configs.py`).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "alpha": "weight"}


def _flatten(tree: Mapping, prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        path = (*prefix, str(key))
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def jax_params_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax parameter tree (nested dicts of arrays, with or without the
    top-level "params" key) -> torch-layout state_dict of f32 tensors."""
    out: dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        a = np.asarray(value)
        *mods, leaf = path
        if mods and mods[0] == "params":
            mods = mods[1:]
        if leaf == "kernel" and a.ndim == 4:
            if any("ConvTranspose" in m for m in mods):
                a = a[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                a = a.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and a.ndim == 2:
            a = a.T
        elif leaf == "alpha" and a.ndim == 0:
            a = a.reshape(1)
        key = ".".join([*mods, _LEAF.get(leaf, leaf)])
        if key in out:
            raise KeyError(f"duplicate torch key {key}")
        out[key] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def random_state_dict(model: torch.nn.Module,
                      seed: int = 0) -> dict[str, torch.Tensor]:
    """Every parameter of `model` drawn from a seeded numpy generator, at
    scales that keep activations O(1) through the whole network: weights
    N(0, 0.25 / fan_in), biases N(0, 0.05^2), LayerNorm scales 1 + N(0,
    0.1^2), PReLU slopes U(0.1, 0.3), bias tables N(0, 0.5^2). Nothing is
    left at zero — `tail_conv` included, whose zero init would make the
    output exactly the bilinear base and hide the network."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, p in model.state_dict().items():
        shape = tuple(p.shape)
        leaf = name.rsplit(".", 1)[-1]
        parent = name.rsplit(".", 2)[-2] if name.count(".") else ""
        if parent.startswith("norm"):
            a = (1.0 + 0.1 * rng.standard_normal(shape)) if leaf == "weight" \
                else 0.1 * rng.standard_normal(shape)
        elif leaf == "relative_position_bias_table":
            a = 0.5 * rng.standard_normal(shape)
        elif len(shape) == 1 and shape[0] == 1:  # PReLU slope
            a = rng.uniform(0.1, 0.3, shape)
        elif leaf == "bias":
            a = 0.05 * rng.standard_normal(shape)
        else:
            fan_in = int(np.prod(shape[1:]))
            if "ConvTranspose" in name:  # [I, O, kh, kw]
                fan_in = shape[0] * shape[2] * shape[3]
            a = 0.5 * rng.standard_normal(shape) / np.sqrt(fan_in)
        sd[name] = torch.from_numpy(np.asarray(a, np.float32))
    return sd
