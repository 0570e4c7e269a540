"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs and parameters come from seeded numpy generators and go to both
packages as numpy arrays; JAX stays on the CPU (tests/conftest.py). The
parameters are drawn once in torch layout (`random_state_dict`, every
parameter non-zero, `tail_conv` included) and carried to the flax tree by
the JAX package's own importer, `torch_to_flax_params`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fbanet_tpu.config import ModelConfig
from fbanet_tpu.utils.torch_io import torch_to_flax_params

# One intra-op thread. With two, torch's CPU ops split a batch between two
# threads, and now and then (about 1 run in 16 on a loaded host) the second
# thread's share came out differently: the whole second sample of
# test_swin_layer_matches[16-4] moved by a median 1.2e-6, up to 1.2e-5,
# while JAX's output stayed bitwise the same. One thread computes every
# sample the same way, every run (and 6 xdist workers x the default thread
# count would oversubscribe the host anyway).
torch.set_num_threads(1)

# Tiny FBANet: 32 px exercises a shifted layer at enc0/enc1 (window 8, shift
# 4) and the window clamp at the 8 px bottleneck; heads divide every width.
TINY = ModelConfig(num_frames=3, img_size=32, embed_dim=16, window_size=8,
                   heads=(1, 2, 4, 8, 4, 4, 2, 2, 2), dtype="float32",
                   drop_path_rate=0.0)


def rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def normal(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (scale * rng(seed).standard_normal(shape)).astype(np.float32)


def t(a) -> torch.Tensor:
    """numpy / JAX array -> torch CPU tensor (f32 stays f32)."""
    return torch.from_numpy(np.array(a))


def n(x) -> np.ndarray:
    """torch tensor or JAX array -> f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def flax_params_like(module, *init_args, state_dict) -> dict:
    """The flax parameter tree of `module` (shapes from an abstract init, no
    compile) filled from a torch-layout state_dict, strictly."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *init_args))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                            shapes["params"])
    params, _ = torch_to_flax_params(
        {k: v.numpy() for k, v in state_dict.items()}, template)
    return params


def max_err(a, b) -> float:
    return float(np.max(np.abs(n(a) - n(b))))


def jax_forward(cfg, dtypes=("float32",)):
    """(torch model, flax params, burst, {dtype: (JAX output, JAX HG2
    features)}) for the JAX `ModelConfig` `cfg`: both models hold the same
    random parameters, the burst [1, F, S, S, cfg.in_channels] is uniform
    from a seed, one JAX compile per compute dtype."""
    from fbanet_tpu.models import create_model as jax_create_model
    from fbanet_tpu_torch.models import create_model
    from fbanet_tpu_torch.utils.weights import random_state_dict

    tmodel = create_model(cfg, device="cpu", seed=3)
    sd = random_state_dict(tmodel, seed=11)
    tmodel.load_state_dict(sd, strict=True)
    size = cfg.img_size
    burst = rng(5).uniform(0, 1, (1, cfg.num_frames, size, size,
                                  cfg.in_channels)).astype(np.float32)
    params = flax_params_like(jax_create_model(cfg), jnp.asarray(burst),
                              state_dict=sd)
    outs = {}
    for dtype in dtypes:
        jmodel = jax_create_model(cfg.replace(dtype=dtype))
        out, state = jax.jit(lambda p, x, m=jmodel: m.apply(
            {"params": p}, x, deterministic=True,
            capture_intermediates=lambda mod, _: mod.name == "output_proj_2",
            mutable=["intermediates"]))(params, jnp.asarray(burst))
        outs[dtype] = (np.asarray(out), np.asarray(
            state["intermediates"]["output_proj_2"]["__call__"][0]))
    return tmodel, params, burst, outs
