"""Every configuration the JAX model builds, in the port, against JAX.

- Modules: the composed modules (SepConv2d, SELayer, WindowAttention with
  a linear projection with and without a bias, the conv projection, SE and
  qk_scale, LeFF, MlpFFN) against their flax counterparts, f32, within
  1e-5 (the same f32 math, sums in another order).
- Layers: SwinLayer under each option and at window 10 (20 px, shift 5)
  against JAX's SwinLayer, f32: the output within 1e-5 and every parameter
  gradient (autograd against jax.value_and_grad, of the sum of the output
  times a random cotangent) within 1e-4 of that gradient's max |value|, or
  of 1e-3 where that is smaller (the same f32 sums in another order,
  through the softmax and the LayerNorm backward; the floor is for the
  conv projection's key bias, whose gradient is 0 in exact arithmetic, as
  the softmax does not see a constant added to every key, and ~1e-8 of
  rounding in both); each layer's route as JAX's `_use_fused_attention`
  and `_supported` decide it.
- Models: FBANet at the configuration's default width and heads (embed 32:
  head size 8 at the bottleneck, dec0 and dec1), 32 px, 3 frames: the f32
  forward within 1e-4 of JAX's (test_torch_model's limit), and the bf16
  forward within test_bf16_forward_matches_jax's limits (in bf16 ulps,
  against each package's f32 forward). The tiny model under the flags,
  two to a model where they take one route (`--token_mlp ffn` with
  `use_qkv_bias=False` on the fused route, `--att_se` with
  `--token_projection conv` on the composed one, one layer a group: the
  layer tests above hold the shifted layers) and `--win_size 10` at 40 px:
  the f32 forward within 1e-4, and `jax_params_to_state_dict` equal to
  the JAX package's `flax_to_torch_state_dict`, loading strictly; the
  composed route (`--att_se --token_projection conv`) and window 10's
  composed branch also in bf16, within the bf16 limits above.
- Plans, on the CPU: K1's and K3's plans send FBANet-32's head sizes (8 and
  32) to the wgmma forms in bf16 and keep enc0 (C = 32) and f32 on the
  first kernels, R1's plan covers its 32-wide weight gradients,
  and R1's check refuses a 32-wide meta tensor for its device, not for its
  width.

JAX runs on the CPU, where its SwinLayer takes the composed XLA path
(`attention_impl="auto"`), whichever route the port's layer takes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import TINY, flax_params_like, max_err, n, normal, t
from torch_parity import jax_forward as _jax_forward

from fbanet_tpu.models import layers as jlayers
from fbanet_tpu.utils.torch_io import flax_to_torch_state_dict
from fbanet_tpu_torch.models import create_model, layers
from fbanet_tpu_torch.ops import attention, leff, reduce
from fbanet_tpu_torch.tools.measure_reduce import groups, r1_shapes
from fbanet_tpu_torch.utils.weights import (
    jax_params_to_state_dict,
    random_state_dict,
)

F32 = torch.float32
# FBANet-32: the configuration's default embed and heads
EMBED32 = TINY.replace(embed_dim=32, heads=(1, 2, 4, 8, 16, 16, 8, 4, 2))


def _pair(jmod, tmod, *init_args, seed=0):
    """Random parameters in the port module and the flax params holding
    them."""
    sd = random_state_dict(tmod, seed)
    tmod.load_state_dict(sd, strict=True)
    args = [jnp.asarray(a) for a in init_args]
    return {"params": flax_params_like(jmod, *args, state_dict=sd)}


def test_sepconv2d_matches():
    x = normal(1, (2, 8, 8, 16))
    for use_bias in (True, False):
        jm = jlayers.SepConv2d(24, use_bias=use_bias)
        tm = layers.SepConv2d(16, 24, use_bias=use_bias)
        p = _pair(jm, tm, x, seed=2)
        assert (tm.depthwise.bias is None) == (not use_bias)
        assert max_err(tm(t(x), F32), jm.apply(p, jnp.asarray(x))) <= 1e-5


def test_selayer_matches():
    x = normal(3, (4, 64, 32))
    jm, tm = jlayers.SELayer(), layers.SELayer(32)
    p = _pair(jm, tm, x, seed=4)
    assert sorted(tm.state_dict()) == ["Dense_0.weight", "Dense_1.weight"]
    assert max_err(tm(t(x), F32), jm.apply(p, jnp.asarray(x))) <= 1e-5


@pytest.mark.parametrize("kw", [
    {}, dict(use_qkv_bias=False), dict(token_projection="conv"),
    dict(use_se_layer=True), dict(qk_scale=0.3),
    dict(token_projection="conv", use_qkv_bias=False, use_se_layer=True)],
    ids=["linear", "linear-nobias", "conv", "se", "qk_scale",
         "conv-nobias-se"])
def test_window_attention_matches(kw):
    """The composed WindowAttention on [G, N, C] windows with the shift
    mask (2 images x 4 windows of 8 x 8, 32 channels, 4 heads)."""
    x = normal(5, (8, 64, 32))
    mask = layers.shift_attention_mask(16, 16, 8, 4)
    jm = jlayers.WindowAttention(dim=32, window_size=8, heads=4, **kw)
    tm = layers.WindowAttention(32, 8, 4, **kw)
    p = _pair(jm, tm, x, seed=6)
    ref = jm.apply(p, jnp.asarray(x), mask=jnp.asarray(mask))
    assert max_err(tm(t(x), t(mask), F32), ref) <= 1e-5


def test_leff_and_mlp_match():
    x = normal(7, (2, 8, 8, 16))
    for jm, tm in ((jlayers.LeFF(16, 64), layers.LeFF(16, 64)),
                   (jlayers.MlpFFN(16, 64), layers.MlpFFN(16, 64))):
        p = _pair(jm, tm, x, seed=8)
        assert max_err(tm(t(x), F32), jm.apply(p, jnp.asarray(x))) <= 1e-5


def test_dropout_law_and_identity():
    """flax nn.Dropout's law: each element kept with probability 1 - rate
    and scaled by 1 / (1 - rate), the rest zero; the identity in eval and
    at rate 0; the bits from the caller's generator."""
    x = torch.ones(64, 256)
    d = layers.Dropout(0.25)
    assert d(x) is x and layers.Dropout(0.0)(x, train=True) is x
    a = d(x, train=True, generator=torch.Generator().manual_seed(3))
    b = d(x, train=True, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) == {0.0, float(torch.tensor(1 / 0.75))}
    kept = float((a > 0).float().mean())
    assert abs(kept - 0.75) < 0.02  # 16384 draws: ~0.0034 std


# (options, route, 2-D map size, window, shift)
LAYERS = {
    "published": ({}, "fused", 16, 8, 4),
    "ffn": (dict(token_mlp="ffn"), "fused", 16, 8, 4),
    "nobias": (dict(use_qkv_bias=False), "fused", 16, 8, 4),
    "se": (dict(use_se_layer=True), "composed", 16, 8, 4),
    "conv": (dict(token_projection="conv"), "composed", 16, 8, 4),
    "qk_scale": (dict(qk_scale=0.3), "composed", 16, 8, 4),
    "dropout": (dict(drop_rate=0.1, attn_drop_rate=0.1), "composed", 16, 8,
                4),
    "window10": ({}, "fused", 20, 10, 5),
    "window10-ffn": (dict(token_mlp="ffn"), "fused", 20, 10, 5),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_swin_layer_option_matches(name):
    """Output and every parameter gradient against JAX; the route. At
    window 10 the fused route's attention takes the composed branch (N =
    100 is not a multiple of 8), once per call."""
    kw, route, res, ws, shift = LAYERS[name]
    x = normal(9, (2, res, res, 32))
    w = normal(10, (2, res, res, 32))
    jm = jlayers.SwinLayer(dim=32, input_resolution=(res, res), heads=4,
                           window_size=ws, shift_size=shift, **kw)
    tm = layers.SwinLayer(32, (res, res), 4, window_size=ws,
                          shift_size=shift, **kw)
    assert tm.route == route
    p = _pair(jm, tm, x, seed=11)

    def loss(params, xj):
        out = jm.apply({"params": params}, xj)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        p["params"], jnp.asarray(x))
    composed = attention.fused_window_attention_2d.composed
    before = composed.launches
    out = tm(t(x))
    assert composed.launches - before == (ws == 10)
    assert max_err(out, ref) <= 1e-5
    (out * t(w)).sum().backward()
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, grads))
    got = {k: v.grad for k, v in tm.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, g in want.items():
        scale = max(float(np.abs(g.numpy()).max()), 1e-3)
        assert max_err(got[k], g) <= 1e-4 * scale, k


@pytest.fixture(scope="module")
def embed32():
    return _jax_forward(EMBED32, ("float32", "bfloat16"))


def test_embed32_forward_matches_jax(embed32):
    """FBANet-32's heads: head size 8 at the bottleneck (128 / 16), dec0
    (128 / 16) and dec1 (64 / 8), 32 at enc0 and enc1; every layer on the
    fused route, no composed branch."""
    tmodel, _, burst, outs = embed32
    out_j, feats_j = outs["float32"]
    routes = {m.route for m in tmodel.modules()
              if isinstance(m, layers.SwinLayer)}
    assert routes == {"fused"}
    composed = attention.fused_window_attention_2d.composed
    before = composed.launches
    with torch.no_grad():
        out, feats = tmodel.forward_with_features(t(burst))
    assert composed.launches == before
    assert out.shape == (1, 128, 128, 3)
    assert max_err(feats, feats_j) <= 1e-4
    assert max_err(out, out_j) <= 1e-4


def _assert_bf16_within_ulps(m32, cfg, burst, out_j, feats_j):
    """The port's bf16 forward of `m32`'s parameters against JAX's bf16
    output `out_j` and HG2 features `feats_j`, in bf16 ulps (the limits of
    test_bf16_forward_matches_jax): the port's bf16 features no farther
    from its f32 features than JAX's bf16 features are, in max and mean;
    the two bf16 forwards at most 4 ulps of the largest feature apart and
    2 ulps of the mean feature on average; the outputs within one ulp of
    the largest output value. Returns the bf16 model."""
    tmodel = create_model(cfg.replace(dtype="bfloat16"), device="cpu")
    tmodel.load_state_dict(m32.state_dict(), strict=True)
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
    return tmodel


def test_embed32_bf16_forward_matches_jax(embed32):
    """The bf16 forward at embed 32 within test_bf16_forward_matches_jax's
    limits (`_assert_bf16_within_ulps`)."""
    m32, _, burst, outs = embed32
    _assert_bf16_within_ulps(m32, EMBED32, burst, *outs["bfloat16"])


# the tiny model under the flags, with their routes
ONE_LAYER = (1,) * 9
FLAGS = {
    "ffn-nobias": (dict(token_mlp="ffn", use_qkv_bias=False,
                        depths=ONE_LAYER), "fused", 32),
    "att_se-conv": (dict(use_se_layer=True, token_projection="conv",
                         depths=ONE_LAYER), "composed", 32),
    "window10": (dict(window_size=10), "fused", 40),
}


# the composed route in bf16: the composed modules and the fused entries'
# composed branch (window 10), one JAX compile each (bf16 only)
FLAG_CASES = [(f, "float32") for f in FLAGS] + [("att_se-conv", "bfloat16"),
                                                 ("window10", "bfloat16")]


@pytest.mark.parametrize(
    "flag,dtype", FLAG_CASES,
    ids=[*FLAGS, "att_se-conv-bf16", "window10-bf16"])
def test_flag_model_matches_jax(flag, dtype):
    """f32: the forward within 1e-4 of JAX's, and the parameter names and
    layouts as the JAX package exports them. bf16: the forward of the same
    parameters within `_assert_bf16_within_ulps`'s limits of JAX's bf16
    forward."""
    kw, route, size = FLAGS[flag]
    cfg = TINY.replace(img_size=size, **kw)
    tmodel, params, burst, outs = _jax_forward(cfg, (dtype,))
    assert {m.route for m in tmodel.modules()
            if isinstance(m, layers.SwinLayer)} == {route}
    composed = attention.fused_window_attention_2d.composed
    before = composed.launches
    if dtype == "bfloat16":
        _assert_bf16_within_ulps(tmodel, cfg, burst, *outs[dtype])
        # the bf16 and the f32 forward: 20 composed attentions each
        assert composed.launches - before == (40 if flag == "window10" else 0)
        return
    with torch.no_grad():
        out = tmodel(t(burst))
    # window 10: each of the 20 layers' attention takes the composed branch
    assert composed.launches - before == (20 if flag == "window10" else 0)
    assert max_err(out, outs["float32"][0]) <= 1e-4
    ours = jax_params_to_state_dict(jax.tree.map(np.asarray, params))
    theirs = flax_to_torch_state_dict(params)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    fresh = create_model(cfg, device="cpu")
    fresh.load_state_dict(ours, strict=True)


def test_first_kernel_plans_at_embed32():
    """K1's and K3's plans keep every group of FBANet-32 in f32 on the
    first kernels; in bf16 at B=2 and B=8 both send all five groups (head
    size 32 at enc0 and enc1, 8 at the others) to their wgmma forms, enc0
    (C = 32) on one warpgroup, and so does K2's (enc0 on 16 x 16 tiles);
    the wgmma forms keep FBANet-64's."""
    for batch in (2, 8):
        for (_name, h, c, heads), (_n, h64, c64, heads64) in zip(
                groups(32), groups(64)):
            assert attention._attention_plan(
                batch, h, h, c, heads, 8, False) == attention._K1_BASE_PLAN
            assert attention._attention_bwd_plan(
                batch, h, h, c, heads, 8, False) == attention._K3_BASE_PLAN
            k1 = attention._attention_plan(batch, h, h, c, heads, 8, True)
            k3 = attention._attention_bwd_plan(batch, h, h, c, heads, 8,
                                               True)
            if c == 32:
                assert k1[0] == 1 and k3[0] == 1
                assert leff._leff_plan(batch, h, h, c, 4 * c) == (16, 16, 64)
            else:
                assert k1[0] > 0 and k3[0] > 0
            assert attention._attention_plan(batch, h64, h64, c64,
                                             heads64)[0] > 0
            assert attention._attention_bwd_plan(batch, h64, h64, c64,
                                                 heads64)[0] > 0
    assert attention._supported(64, 128, 16)
    assert attention._supported(64, 32, 1)
    assert not attention._supported(100, 64, 2)  # window 10
    assert not attention._supported(64, 48, 4)  # head size 12


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_token_matmul_plan_at_embed32(bf16):
    """R1's plan at every weight-gradient shape of FBANet-32's B=8 step:
    64 x 64 tiles (128-wide ones only where they divide), the 32-wide
    edges as masked halves, slices covering the tokens in order."""
    shapes = r1_shapes(8, 160, groups(32))
    assert len(shapes) == 25
    assert {(m, n) for *_, m, n in shapes} >= {(32, 32), (64, 32),
                                               (128, 32), (32, 128)}
    for _g, _p, tokens, m, nn in shapes:
        tile_m, tile_n, chunk, splits = reduce._token_matmul_plan(
            tokens, m, nn, bf16)
        assert tile_m in (64, 128) and tile_n in (64, 128)
        assert (tile_m == 64 or m % 128 == 0) and (tile_n == 64 or
                                                   nn % 128 == 0)
        assert (splits - 1) * chunk < tokens <= splits * chunk
        tiles = -(-m // tile_m) * -(-nn // tile_n)
        assert tiles >= 1 and (not bf16 or splits == 1
                               or tiles * splits <= reduce._SMS)


def test_token_matmul_refuses_32_wide_for_its_device():
    """A 32-wide output is R1's shape now: a meta tensor is refused for
    its device, not for its width; a width off the 32 grid still is."""
    def meta(*shape):
        return torch.empty(*shape, dtype=torch.bfloat16, device="meta")

    for a, b in ((meta(128, 32), meta(128, 32)), (meta(128, 128),
                                                  meta(128, 32))):
        with pytest.raises(ValueError, match="one CUDA device"):
            reduce.token_matmul(a, b)
    with pytest.raises(ValueError, match="multiples of 32"):
        reduce.token_matmul(meta(128, 48), meta(128, 32))
