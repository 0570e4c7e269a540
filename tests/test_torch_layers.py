"""The port's layers and blocks against their JAX counterparts, f32.

Each port module gets random parameters (`random_state_dict`), the flax
module the same ones through the strict importer; tolerance 1e-5 (the same
f32 math, sums in another order) unless stated.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import flax_params_like, max_err, n, normal, t

from fbanet_tpu.models import blocks as jblocks
from fbanet_tpu.models import layers as jlayers
from fbanet_tpu.ops.faf_gate import affinity_gate as jax_affinity_gate
from fbanet_tpu_torch.models import blocks, layers
from fbanet_tpu_torch.ops.faf_gate import affinity_gate
from fbanet_tpu_torch.utils.weights import random_state_dict

F32 = torch.float32


def _pair(jmod, tmod, x, seed=0):
    """Port module with random parameters + the flax params holding them."""
    sd = random_state_dict(tmod, seed)
    tmod.load_state_dict(sd, strict=True)
    return {"params": flax_params_like(jmod, jnp.asarray(x), state_dict=sd)}


def test_layer_norm_matches_flax():
    from flax import linen as nn

    x = normal(0, (2, 5, 7, 24), 3.0) + 1.5
    ln = nn.LayerNorm(epsilon=1e-5)
    mod = layers.LayerNorm(24)
    p = _pair(ln, mod, x)
    assert max_err(mod(t(x)), ln.apply(p, jnp.asarray(x))) <= 1e-5


def test_prelu_matches():
    x = normal(1, (2, 4, 4, 3))
    mod = layers.PReLU(0.25)
    jm = jlayers.PReLU(init_alpha=0.25)
    p = _pair(jm, mod, x)
    np.testing.assert_array_equal(n(mod(t(x))), n(jm.apply(p, jnp.asarray(x))))


def test_pixel_shuffle_matches():
    x = normal(2, (2, 3, 5, 12))
    np.testing.assert_array_equal(n(layers.pixel_shuffle(t(x), 2)),
                                  n(jlayers.pixel_shuffle(jnp.asarray(x), 2)))


@pytest.mark.parametrize("kind", ["upsample", "downsample", "convproj",
                                  "resblock"])
def test_conv_modules_match(kind):
    cin, cout = 8, 6
    make = {
        "upsample": (jlayers.Upsample(cout), layers.Upsample(cin, cout)),
        "downsample": (jlayers.Downsample(cout), layers.Downsample(cin, cout)),
        "convproj": (jlayers.ConvProj(cout), layers.ConvProj(cin, cout)),
        "resblock": (jblocks.ResBlock(cin), blocks.ResBlock(cin)),
    }
    jm, tm = make[kind]
    x = normal(3, (2, 8, 8, cin))
    p = _pair(jm, tm, x)
    got = tm(t(x), F32)
    assert max_err(got, jm.apply(p, jnp.asarray(x))) <= 1e-5


def test_index_and_mask_arrays_equal_jax():
    for ws in (4, 8):
        np.testing.assert_array_equal(layers.relative_position_index(ws),
                                      jlayers.relative_position_index(ws))
    for h, w, ws, s in ((16, 16, 8, 4), (8, 16, 4, 2)):
        np.testing.assert_array_equal(
            layers.shift_attention_mask(h, w, ws, s),
            jlayers.shift_attention_mask(h, w, ws, s))


def test_affinity_gate_matches():
    x = normal(4, (2, 3, 8, 8, 6))
    wsum = normal(5, (3, 3, 6), 0.3)  # JAX layout [3, 3, C]
    ref = jax_affinity_gate(jnp.asarray(x), jnp.asarray(wsum), jnp.float32)
    got = affinity_gate(t(x), t(wsum.transpose(2, 0, 1).copy()), F32)
    assert max_err(got, ref) <= 1e-5
    np.testing.assert_array_equal(n(got[:, 0]), x[:, 0])  # frame 0 ungated


def test_faf_block_matches():
    x = normal(6, (2, 3, 16, 16, 8), 0.5)
    jm, tm = jblocks.FAFBlock(num_feats=8, num_frames=3), blocks.FAFBlock(8, 3)
    p = _pair(jm, tm, x, seed=2)
    assert max_err(tm(t(x), F32), jm.apply(p, jnp.asarray(x))) <= 2e-5


@pytest.mark.parametrize("res,shift", [(16, 4), (8, 4)])
def test_swin_layer_matches(res, shift):
    """A shifted layer (window 8, shift 4 at 16 px) and the window clamp
    (8 px input: window 8, shift dropped) against the JAX layer."""
    x = normal(7, (2, res, res, 16))
    jm = jlayers.SwinLayer(dim=16, input_resolution=(res, res), heads=2,
                           window_size=8, shift_size=shift)
    tm = layers.SwinLayer(16, (res, res), 2, window_size=8, shift_size=shift)
    assert tm.shift == (shift if res > 8 else 0)
    p = _pair(jm, tm, x, seed=3)
    assert max_err(tm(t(x)), jm.apply(p, jnp.asarray(x))) <= 1e-5
