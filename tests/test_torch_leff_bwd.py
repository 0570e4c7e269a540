"""K4's plain version (fbanet_tpu_torch.ops.leff.leff_bwd_reference, reached
through the autograd Function of `fused_leff` on the CPU) against both JAX
Pallas backward kernels of the LeFF run in interpret mode: the row-strip
`_pallas_backward` and the column-blocked `_pallas_backward_2d`, on every
gradient.

Tolerances: f32 1e-5 absolute + 1e-4 relative per element, the JAX tests'
own limits for these kernels against autodiff. bf16 3e-2: dx relative to
max(1, max |dx|), each parameter gradient relative to its max |grad|: both
versions round at the same points (y, g, dz1, h2), so they differ where a
sum in another order flips a rounded intermediate by one ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_leff import C, CH, _params, _torch_params
from torch_parity import n, normal, t

from fbanet_tpu.ops.leff_pallas import (
    _LeffStatic,
    _pallas_backward,
    _pallas_backward_2d,
)
from fbanet_tpu.ops.leff_pallas import fused_leff as jax_fused_leff
from fbanet_tpu_torch.ops import leff as leff_mod
from fbanet_tpu_torch.ops.leff import (
    _leff_math,
    fused_leff,
    leff_bwd,
    leff_bwd_reference,
)

NAMES = ("ln_scale", "ln_bias", "w1", "b1", "wdw", "bdw", "w2", "b2")
SHAPE = (2, 16, 24)


def _to_torch_layout(k, v):
    v = np.asarray(v, np.float32)
    if k in ("w1", "w2"):
        return v.T
    if k == "wdw":  # [3, 3, 1, Ch] -> [Ch, 1, 3, 3]
        return v.reshape(3, 3, 1, CH).transpose(3, 2, 0, 1)
    return v


def _check(got, ref, dtype):
    for k in ref:
        if dtype == "float32":
            np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=1e-4,
                                       err_msg=k)
        else:
            scale = max(1.0, np.abs(ref[k]).max()) if k == "x" \
                else np.abs(ref[k]).max()
            assert np.abs(got[k] - ref[k]).max() <= 3e-2 * scale, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("blocked", [False, True])
def test_plain_backward_matches_pallas_kernels(dtype, blocked):
    """The row-strip kernel (K4) and the column-blocked one (K4b, 8 x 8
    blocks with +-2 / +-1 halos in both dimensions) against the plain
    backward, which works on the whole map."""
    p = _params(seed=10)
    x = normal(11, (*SHAPE, C))
    g = normal(12, (*SHAPE, C))
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    cfg = _LeffStatic(compute_dtype=jd.name, rows=8, interpret=True)
    jargs = [jnp.asarray(p[k]) for k in NAMES[:-1]]
    jx, jg = jnp.asarray(x).astype(jd), jnp.asarray(g).astype(jd)
    if blocked:
        out = _pallas_backward_2d(cfg, jx, jg, *jargs, rows=8, wb=8)
    else:
        out = _pallas_backward(cfg, jx, jg, *jargs)
    ref = {"x": np.asarray(out[0].astype(jnp.float32))}
    ref.update({k: _to_torch_layout(k, v) for k, v in zip(NAMES, out[1:])})

    tp = _torch_params(p)
    grads = leff_bwd_reference(t(x).to(td), t(g).to(td),
                               *[tp[k] for k in NAMES[:-1]])
    assert grads[0].dtype == td
    got = {"x": n(grads[0])}
    got.update({k: n(v) for k, v in zip(NAMES, grads[1:])})
    _check(got, ref, dtype)


def _port_grads(x, g, p, residual, dtype, plain_forward=False):
    td = getattr(torch, dtype)
    xt = t(x).to(td).requires_grad_()
    tp = {k: v.requires_grad_() for k, v in _torch_params(p).items()}
    args = [tp[k] for k in NAMES]
    if plain_forward:  # torch.autograd through the plain forward
        out = _leff_math(xt, *args, td)
        out = (out + xt.float() if residual else out).to(td)
    else:
        out = fused_leff(xt, *args, residual=residual)
    out.backward(t(g).to(td))
    res = {"x": n(xt.grad)}
    res.update({k: n(tp[k].grad) for k in NAMES})
    return res


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_with_residual_matches_jax_vjp(dtype):
    """The whole custom-VJP path with the residual (dx gains g) against
    jax.vjp of the JAX `fused_leff` on its Pallas backward."""
    p = _params(seed=20)
    x = normal(21, (*SHAPE, C))
    g = normal(22, (*SHAPE, C))
    jd = jnp.dtype(dtype)

    def f(x_, *a):
        return jax_fused_leff(x_, *a, compute_dtype=jd, interpret=True,
                              use_pallas_bwd=True, residual=True)

    _, vjp = jax.vjp(f, jnp.asarray(x).astype(jd),
                     *[jnp.asarray(p[k]) for k in NAMES])
    out = vjp(jnp.asarray(g).astype(jd))
    ref = {"x": np.asarray(out[0].astype(jnp.float32))}
    ref.update({k: _to_torch_layout(k, v) for k, v in zip(NAMES, out[1:])})
    _check(_port_grads(x, g, p, True, dtype), ref, dtype)


def test_function_matches_autograd_of_plain_forward():
    """The Function's backward (the plain K4) against torch.autograd
    through the plain forward, f32."""
    p = _params(seed=30)
    x = normal(31, (*SHAPE, C))
    g = normal(32, (*SHAPE, C))
    got = _port_grads(x, g, p, False, "float32")
    ref = _port_grads(x, g, p, False, "float32", plain_forward=True)
    _check(got, ref, "float32")


def test_backward_launches_or_raises_off_the_cpu():
    p = _torch_params(_params())
    p.pop("b2")
    x = torch.empty(1, 8, 8, C, device="meta")
    with pytest.raises(ValueError, match=r"\(1, 8, 8, 16\)"):
        leff_bwd(x, x, **p)


# --- K4's plan and the order of the split's sums (CPU; the kernels run on
# the card, where chip_smoke.py holds them against leff_bwd_reference) ---

SMEM_LIMIT, SMS = 232448, 132
# (H, C) of the five SwinGroups at 160 px: enc0, enc1, bott, dec0, dec1
GROUP_SHAPES = [(160, 64), (80, 128), (40, 256), (80, 256), (160, 128)]


@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("h,c", GROUP_SHAPES,
                         ids=["enc0", "enc1", "bott", "dec0", "dec1"])
def test_leff_bwd_plan_at_the_group_shapes(h, c, batch):
    """The wgmma form's plan fits shared memory, its chunk divides the
    hidden width, its tile divides the map, and a split reaches two blocks
    per SM (it splits only below half a block per SM)."""
    ch = 4 * c
    th, tw, kc, splits = leff_mod._leff_bwd_plan(batch, h, h, c, ch)
    assert (th, tw, kc) in leff_mod._K4_FORMS
    assert 0 < leff_mod._leff_bwd_smem(c, th, tw, kc) <= SMEM_LIMIT
    assert ch % (kc * splits) == 0 and h % th == 0 and h % tw == 0
    tiles = batch * (h // th) * (h // tw)
    if splits > 1:
        assert 2 * tiles < SMS and tiles * splits >= 2 * SMS
    else:
        assert 2 * tiles >= SMS


def test_leff_bwd_plan_refuses_or_takes_the_wmma_form():
    """f32 and shapes the wgmma form does not take get the WMMA form
    (8 x 8 tiles); a map not in multiples of 8 gets no plan, and
    `leff_bwd` raises for it rather than fall back."""
    wmma = leff_mod._WMMA_PLAN
    assert leff_mod._leff_bwd_plan(2, 80, 80, 128, 512, False) == wmma
    assert leff_mod._leff_bwd_plan(2, 16, 24, 16, 64) == wmma  # C = 16
    assert leff_mod._leff_bwd_plan(2, 12, 12, 64, 256) is None
    # the layout's limits: at most four 64 x 64 pieces of dy per tile, and
    # 16 x 8 tiles at C = 256 need 8
    assert leff_mod._leff_bwd_smem(256, 16, 8, 32) == 0
    assert leff_mod._leff_bwd_smem(64, 16, 16, 16) == 0  # not a form
    assert leff_mod._leff_bwd_smem(64, 8, 8, 64) == 0  # not a form
    assert 0 < leff_mod._leff_bwd_smem(256, 8, 8, 32) <= SMEM_LIMIT


def test_leff_bwd_plan_sizes_with_the_given_smem():
    """The plan takes its shared-memory sizes from the function it is
    given (`leff_bwd` passes the kernel's own on the card): a form that
    function refuses is passed over, and with none left bf16 gets the
    WMMA form."""
    def only_8x8(c, th, tw, kc):
        return leff_mod._leff_bwd_smem(c, th, tw, kc) if th == 8 else 0

    def none(c, th, tw, kc):
        return 0

    assert leff_mod._leff_bwd_plan(8, 160, 160, 64, 256)[:3] == (16, 8, 32)
    assert leff_mod._leff_bwd_plan(8, 160, 160, 64, 256,
                                   smem=only_8x8)[:3] == (8, 8, 32)
    assert (leff_mod._leff_bwd_plan(8, 160, 160, 64, 256, smem=none)
            == leff_mod._WMMA_PLAN)


def test_leff_bwd_smem_at_c32_byte_for_byte():
    """The wgmma form's layout at C = 32 (FBANet-32's enc0), byte for byte:
    y and g as 64-byte rows (2 C bytes a row, as the 128-byte atoms at
    C >= 64), the W1 ring's two chunks and the W2^T chunk (kc rows of 2 C
    bytes each), dz1 (NI rows of 2 kc bytes), then h1, gz1 and z2 (f32,
    kc + 4 a row), the taps, b1, bdw, the token statistics, three
    barriers and the base's alignment slack. 16 x 16 tiles exist at
    C = 32 only, 8 x 8 ones at C >= 64 only."""
    def a128(b):
        return -(-b // 128) * 128

    # 16 x 16: NX 400, NG 324 (328 rounded to 8 rows), NI 256
    head = 400 * 64 + 328 * 64 + 512  # y, g, up to the 1024-byte boundary
    ring = 2 * 32 * 64 + 32 * 64 + 256 * 32 * 2  # W1 x 2, W2^T, dz1
    f32 = a128(4 * 400 * 36) + a128(4 * 256 * 36) + a128(4 * 328 * 36)
    rest = a128(36 * 32) + 2 * a128(4 * 32) + 2 * a128(4 * 256) + 24 + 1024
    assert leff_mod._leff_bwd_smem(32, 16, 16, 32) == \
        head + ring + f32 + rest == 215832
    # 16 x 8: NX 240, NG 180 (184), NI 128
    head = 240 * 64 + 184 * 64 + 512
    ring = 2 * 32 * 64 + 32 * 64 + 128 * 32 * 2
    f32 = a128(4 * 240 * 36) + a128(4 * 128 * 36) + a128(4 * 184 * 36)
    rest = a128(36 * 32) + 2 * a128(4 * 32) + 2 * a128(4 * 128) + 24 + 1024
    assert leff_mod._leff_bwd_smem(32, 16, 8, 32) == \
        head + ring + f32 + rest == 124952
    assert leff_mod._leff_bwd_smem(32, 8, 8, 32) == 0  # built at C >= 64
    for c in (64, 128, 256):
        assert leff_mod._leff_bwd_smem(c, 16, 16, 32) == 0  # C = 32 only
    assert leff_mod._leff_bwd_smem(48, 16, 8, 32) == 0
    assert leff_mod._leff_bwd_smem(16, 16, 8, 32) == 0


@pytest.mark.parametrize("batch", [2, 8])
def test_leff_bwd_plan_at_embed32_enc0(batch):
    """FBANet-32's enc0 (160 px, C = 32, hidden 128) takes the wgmma form
    in bf16 with 16 x 16 tiles and no split (B * 100 tiles reach half a
    block an SM); f32 keeps the WMMA form."""
    plan = leff_mod._leff_bwd_plan(batch, 160, 160, 32, 128)
    assert plan == (16, 16, 32, 1)
    assert 2 * batch * 100 >= SMS
    assert leff_mod._leff_bwd_plan(batch, 160, 160, 32, 128, False) == \
        leff_mod._WMMA_PLAN


def test_leff_bwd_launch_refuses_off_the_card_at_c32():
    """K4's launch under an explicit plan takes CUDA tensors only, at
    C = 32 as at every width: any other device gets an error naming the
    shape, never the plain version."""
    c, ch = 32, 128
    x = torch.empty(1, 16, 16, c, device="meta", dtype=torch.bfloat16)
    p = [torch.empty(s, device="meta") for s in (
        (c,), (c,), (ch, c), (ch,), (ch, 1, 3, 3), (ch,), (c, ch))]
    for plan in ((16, 16, 32, 1), (16, 8, 32, 1), leff_mod._WMMA_PLAN):
        with pytest.raises(ValueError, match=r"\(1, 16, 16, 32\)"):
            leff_mod._leff_bwd_launch(x, x, *p, True, plan)


def _split_dy_sum(parts):
    """The split's second pass (`leff_ln_bwd_kernel`, csrc/leff_bwd.cu) in
    plain PyTorch: the f32 dy partials [splits, ..., C] added in split
    order."""
    out = parts[0].clone()
    for k in range(1, parts.shape[0]):
        out += parts[k]
    return out


def _tile_column_sums(v, threads=512):
    """`tile_column_sums` (csrc/leff_bwd.cu) in plain PyTorch, for v
    [n tokens, C] and a block of `threads`: threads / C groups of
    consecutive tokens, each summed in token order, then the groups added
    in order."""
    n_tok, c = v.shape
    k = threads // c
    sums = []
    for i in range(k):
        acc = torch.zeros(c)
        for row in v[i * n_tok // k:(i + 1) * n_tok // k]:
            acc = acc + row
        sums.append(acc)
    out = sums[0]
    for s in sums[1:]:
        out = out + s
    return out


def test_split_and_tile_sums_match_float64():
    """The split's second pass adds the f32 dy partials in split order, and
    the per-tile column sums (of the wgmma form's 512 threads and the split
    pass's 256) add token groups in order: both within f32 rounding of a
    float64 sum."""
    rng = np.random.default_rng(40)
    parts = rng.standard_normal((8, 64, 256)).astype(np.float32)
    np.testing.assert_allclose(n(_split_dy_sum(t(parts))),
                               parts.astype(np.float64).sum(0), rtol=0,
                               atol=1e-5)
    for c in (64, 128, 256):
        v = rng.standard_normal((128, c)).astype(np.float32)
        for threads in (512, 256):
            np.testing.assert_allclose(
                n(_tile_column_sums(t(v), threads)),
                v.astype(np.float64).sum(0), rtol=0, atol=2e-5)
