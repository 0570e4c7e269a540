"""The port's whole FBANet forward against the JAX model, tiny config, f32.

All parameters are random (tail_conv included: a zero tail would make the
output exactly the bilinear base and prove nothing about the network), and
the HG2 features before the tail are compared as well as the output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import TINY, flax_params_like, max_err, n, rng, t

from fbanet_tpu.config import ModelConfig
from fbanet_tpu.models import create_model as jax_create_model
from fbanet_tpu.models.blocks import fused_tail_x4
from fbanet_tpu.models.blocks import tail_x4_direct as jax_tail_x4_direct
from fbanet_tpu.utils.torch_io import flax_to_torch_state_dict
from fbanet_tpu_torch.models import ARCHS, count_parameters, create_model
from fbanet_tpu_torch.models.blocks import tail_x4_direct
from fbanet_tpu_torch.utils.weights import (
    jax_params_to_state_dict,
    random_state_dict,
)


def _jax_pair(cfg, batch: int):
    """(torch model, flax params, burst, JAX output, JAX HG2 features), both
    models holding the same random parameters."""
    tmodel = create_model(cfg, device="cpu", seed=3)
    sd = random_state_dict(tmodel, seed=11)
    tmodel.load_state_dict(sd, strict=True)
    size = cfg.img_size
    burst = rng(5).uniform(0, 1, (batch, cfg.num_frames, size, size, 3)
                           ).astype(np.float32)
    jmodel = jax_create_model(cfg)
    params = flax_params_like(jmodel, jnp.asarray(burst), state_dict=sd)

    @jax.jit
    def run(p, x):
        return jmodel.apply(
            {"params": p}, x, deterministic=True,
            capture_intermediates=lambda m, _: m.name == "output_proj_2",
            mutable=["intermediates"])

    out, state = run(params, jnp.asarray(burst))
    feats = state["intermediates"]["output_proj_2"]["__call__"][0]
    return tmodel, params, burst, np.asarray(out), np.asarray(feats)


def _check_forward(pair):
    tmodel, _, burst, out_j, feats_j = pair
    b, _, h, w, _ = burst.shape
    with torch.no_grad():
        out, feats = tmodel.forward_with_features(t(burst))
    assert out.shape == (b, 4 * h, 4 * w, 3) and out.dtype == torch.float32
    assert float(np.std(feats_j)) > 1e-2  # the network is not a no-op
    assert max_err(feats, feats_j) <= 1e-4
    assert max_err(out, out_j) <= 1e-4


@pytest.fixture(scope="module")
def pair():
    return _jax_pair(TINY, batch=2)


def test_forward_matches_jax(pair):
    _check_forward(pair)


def test_forward_matches_jax_at_published_widths():
    """The published widths and heads (embed 64, 14 frames; (C, heads) =
    (64, 1), (128, 2), (256, 16), (256, 16), (128, 8), head sizes 64 and
    16) at 32 px instead of 160 (a 160 px JAX compile is too large for a CPU
    test): shifted layers at enc0/dec1 and the window clamp at the 8 px
    bottleneck. The card checks the 160 px shapes kernel against plain
    version (chip_smoke.py)."""
    cfg = ModelConfig(num_frames=14, img_size=32, embed_dim=64,
                      window_size=8, dtype="float32", drop_path_rate=0.0)
    _check_forward(_jax_pair(cfg, batch=1))


def test_weights_converter_matches_flax_export(pair):
    tmodel, params, _, _, _ = pair
    ours = jax_params_to_state_dict(jax.tree.map(np.asarray, params))
    theirs = flax_to_torch_state_dict(params)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    fresh = create_model(TINY, device="cpu")
    fresh.load_state_dict(ours, strict=True)  # no rename table
    for k, v in tmodel.state_dict().items():
        np.testing.assert_array_equal(fresh.state_dict()[k].numpy(), v.numpy())
    # the wrapped form and the DataParallel-free names are both accepted
    assert jax_params_to_state_dict({"params": params}).keys() == ours.keys()


def test_fresh_model_is_exactly_the_bilinear_base():
    """tail_conv starts at zero (fbanet.py:148-160), so an untouched model
    returns its bilinear base — which must equal jax.image.resize."""
    model = create_model(TINY, device="cpu", seed=0)
    assert model.tail_conv.weight.abs().sum() == 0
    assert ARCHS["BaseModel"] is create_model and count_parameters(model) > 0
    burst = rng(2).uniform(0, 1, (1, 3, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        out = model(t(burst))
    base = jax.image.resize(jnp.asarray(burst[:, 0]), (1, 128, 128, 3),
                            method="bilinear")
    assert max_err(out, base) <= 1e-6


@pytest.mark.parametrize("composed", [False, True])
def test_tail_x4_direct_matches_jax(composed):
    """The port's tail against JAX's direct tail and its composed,
    border-repaired form (which the JAX model runs)."""
    r = rng(8)
    c, co = 8, 3
    x = r.standard_normal((2, 10, 12, c)).astype(np.float32)
    w0, w1 = (0.2 * r.standard_normal((3, 3, c, 4 * c)).astype(np.float32)
              for _ in range(2))
    wt = 0.2 * r.standard_normal((3, 3, c, co)).astype(np.float32)
    b0, b1 = (r.standard_normal(4 * c).astype(np.float32) for _ in range(2))
    bt = r.standard_normal(co).astype(np.float32)
    fn = fused_tail_x4 if composed else jax_tail_x4_direct
    ref = fn(*map(jnp.asarray, (x, w0, b0, w1, b1, wt, bt)), jnp.float32)
    conv = lambda w: t(w.transpose(3, 2, 0, 1))  # noqa: E731
    got = tail_x4_direct(t(x), conv(w0), t(b0), conv(w1), t(b1), conv(wt),
                         t(bt), torch.float32)
    assert got.shape == (2, 40, 48, co)
    assert max_err(got, ref) <= 1e-4


def test_create_model_defaults_to_the_card(monkeypatch):
    """The model goes to the card unless the caller names another device;
    with no CUDA device and none named, create_model says how to ask for
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model(TINY)
    assert next(create_model(TINY, device="cpu").parameters()).is_cpu


def test_bf16_forward_matches_jax():
    """The port's bf16 forward against the JAX model's bf16 forward (TINY
    config, batch 2, one JAX compile), at the tail's input (HG2's features)
    and at the output.

    Both round every activation to bf16, but not always at the same points:
    flax adds a conv's bias to the conv's bf16-rounded output (two
    roundings) where the port's conv adds it inside its one rounding, and
    the feature-fusion and Swin layers differ likewise. Each such point
    flips an element by one bf16 ulp (2^-8 relative) now and then, and the
    flips compound over the ~40 layers before the tail. So the limits are
    stated in bf16 ulps, and against the f32 forward: the port's bf16
    features are no farther from its f32 features (which match JAX's f32
    ones to 1e-4, test_forward_matches_jax) than JAX's bf16 features are,
    in max and mean; the two bf16 forwards differ by at most 4 ulps of the
    largest feature and by 2 ulps of the mean feature on average; the
    outputs (each tail rounds its own way: tail_x4_direct against
    fused_tail_x4) by at most one ulp of the largest output value."""
    cfg = TINY.replace(dtype="bfloat16")
    tmodel, _, burst, out_j, feats_j = _jax_pair(cfg, batch=2)
    m32 = create_model(TINY, device="cpu")
    m32.load_state_dict(tmodel.state_dict(), strict=True)
    with torch.no_grad():
        out, feats = tmodel.forward_with_features(t(burst))
        _, feats32 = m32.forward_with_features(t(burst))
    assert feats.dtype == torch.bfloat16 and out.dtype == torch.float32
    fj, fp, f32 = n(feats_j), n(feats), n(feats32)
    ulp = 2.0 ** -8
    assert np.abs(fp - f32).max() <= np.abs(fj - f32).max()
    assert np.abs(fp - f32).mean() <= np.abs(fj - f32).mean()
    gap = np.abs(fp - fj)
    assert gap.max() <= 4 * ulp * np.abs(fj).max()
    assert gap.mean() <= 2 * ulp * np.abs(fj).mean()
    assert max_err(out, out_j) <= ulp * np.abs(out_j).max()
