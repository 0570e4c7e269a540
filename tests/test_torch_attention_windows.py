"""K1b's plain version (fbanet_tpu_torch.ops.attention.fused_window_attention
on the CPU: `window_attention_reference` forward, `window_attention_bwd_
reference` backward through its autograd Function) against the JAX
package's `fused_window_attention(..., interpret=True)`, the Pallas kernel
`_attention_kernel` on `[G, N, C]` windows, and its gradients against
`jax.grad` through the Pallas backward kernel (`use_pallas_bwd=True`).

Tolerances are test_torch_attention.py's and test_torch_attention_bwd.py's:
forward f32 1e-5, bf16 3e-2 absolute; gradients f32 1e-5 absolute + 1e-4
relative, bf16 3e-2 of max(1, max |dx|) for dx and of each parameter
gradient's max |grad| (both round at the same points; a sum in another order
can flip a rounded intermediate by one ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_attention import C, IMG, TOL, WS, _params, _torch_params
from test_torch_attention_bwd import LINEAR, NAMES
from torch_parity import max_err, n, normal, t

from fbanet_tpu.models.layers import shift_attention_mask as jax_mask
from fbanet_tpu.ops.attention_pallas import (
    fused_window_attention as jax_fused_windows,
)
from fbanet_tpu_torch.ops.attention import (
    fused_window_attention,
    fused_window_attention_2d,
    window_partition,
)

NW = (IMG // WS) ** 2  # windows per image
G = 2 * NW  # two images


def _case(heads, masked, seed):
    p = _params(heads, seed=seed)
    x = normal(seed + 50, (G, WS * WS, C))
    mask = jax_mask(IMG, IMG, WS, WS // 2) if masked else None
    return p, x, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("heads", [1, 2])
def test_plain_matches_pallas_kernel(dtype, masked, heads):
    p, x, mask = _case(heads, masked, seed=3 * heads)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    got = fused_window_attention(
        t(x).to(td), **_torch_params(p),
        mask=None if mask is None else t(mask), heads=heads,
        windows_per_image=NW)
    assert got.dtype == td and got.shape == x.shape
    ref = jax_fused_windows(
        jnp.asarray(x).astype(jd), **{k: jnp.asarray(v) for k, v in p.items()},
        mask=None if mask is None else jnp.asarray(mask), heads=heads,
        windows_per_image=NW, compute_dtype=jd, interpret=True)
    assert max_err(got, ref) <= TOL[dtype]
    assert fused_window_attention.launches == 0  # the CPU runs no kernel


def _jax_grads(x, g, p, mask, heads, dtype):
    jd = jnp.dtype(dtype)
    jm = None if mask is None else jnp.asarray(mask)

    def f(xw, *a):
        return jax_fused_windows(xw, *a, mask=jm, heads=heads,
                                 windows_per_image=NW, compute_dtype=jd,
                                 interpret=True, use_pallas_bwd=True)

    _, vjp = jax.vjp(f, jnp.asarray(x).astype(jd),
                     *[jnp.asarray(p[k]) for k in NAMES])
    grads = vjp(jnp.asarray(g).astype(jd))
    res = {"x": np.asarray(grads[0].astype(jnp.float32))}
    for k, v in zip(NAMES, grads[1:]):
        res[k] = np.asarray(v).T if k in LINEAR else np.asarray(v)
    return res


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_gradients_match_jax_grad(dtype, masked):
    heads = 2
    p, x, mask = _case(heads, masked, seed=60)
    g = normal(61, x.shape)
    td = getattr(torch, dtype)
    xt = t(x).to(td).requires_grad_()
    tp = {k: v.requires_grad_() for k, v in _torch_params(p).items()}
    out = fused_window_attention(
        xt, *[tp[k] for k in NAMES], None if mask is None else t(mask),
        heads=heads, windows_per_image=NW)
    out.backward(t(g).to(td))
    got = {"x": n(xt.grad), **{k: n(tp[k].grad) for k in NAMES}}
    ref = _jax_grads(x, g, p, mask, heads, dtype)
    for k in ref:
        if dtype == "float32":
            np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=1e-4,
                                       err_msg=k)
        else:
            scale = max(1.0, np.abs(ref[k]).max()) if k == "x" \
                else np.abs(ref[k]).max()
            assert np.abs(got[k] - ref[k]).max() <= 3e-2 * scale, k


@pytest.mark.parametrize("masked", [False, True])
def test_windows_equal_the_map_kernel_on_its_partition(masked):
    """K1b on the partitioned map is K1 (no residual) partitioned: the same
    block math with other addressing, bitwise in the plain versions too."""
    heads = 2
    p = _torch_params(_params(heads, seed=70))
    x4 = t(normal(71, (2, IMG, IMG, C)))
    mask = t(jax_mask(IMG, IMG, WS, WS // 2)) if masked else None
    win = fused_window_attention(window_partition(x4, WS), **p, mask=mask,
                                 heads=heads, windows_per_image=NW)
    full = fused_window_attention_2d(x4, **p, mask=mask, heads=heads,
                                     window_size=WS)
    assert torch.equal(win, window_partition(full, WS))


def test_mask_must_fit_the_windows():
    """The mask must be [windows_per_image, N, N] with G a multiple of
    windows_per_image, on every device."""
    p = _torch_params(_params(1))
    x = t(normal(0, (G - 1, WS * WS, C)))
    mask = t(jax_mask(IMG, IMG, WS, WS // 2))
    with pytest.raises(ValueError, match=r"windows_per_image=4"):
        fused_window_attention(x, **p, mask=mask, heads=1,
                               windows_per_image=NW)


def test_no_kernel_device_raises():
    """Off the CPU the wrapper launches the kernel or raises, naming the
    shape: never the plain path, never the JAX API's silent XLA fallback."""
    p = _torch_params(_params(1))
    x = torch.empty(G, WS * WS, C, device="meta")
    with pytest.raises(ValueError, match=r"\(8, 16, 32\)"):
        fused_window_attention(x, **p, mask=None, heads=1,
                               windows_per_image=NW)
