"""K3's plain version (fbanet_tpu_torch.ops.attention.
window_attention_bwd_reference, reached through the autograd Function of
`fused_window_attention_2d` on the CPU) against the JAX package's Pallas
backward kernel run in interpret mode (`fused_window_attention_2d(...,
interpret=True, use_pallas_bwd=True)`, as tests/test_attention_pallas.py
runs it), on every gradient.

Tolerances: f32 1e-5 absolute + 1e-4 relative per element, the JAX tests'
own limits for its kernel against autodiff (the same math, sums in another
order). bf16 3e-2: dx relative to max(1, max |dx|), each parameter gradient
relative to its max |grad|. Both versions round at the same points (y, q,
k, v, p, do, dlogits, dq, dk, dv), so they differ where a sum in another
order flips a rounded intermediate by one ulp (2^-8 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_attention import C, IMG, WS, _params, _torch_params
from torch_parity import n, normal, t

from fbanet_tpu.models.layers import shift_attention_mask as jax_mask
from fbanet_tpu.ops.attention_pallas import (
    fused_window_attention_2d as jax_fused_2d,
)
from fbanet_tpu_torch.ops.attention import (
    _plain_2d,
    fused_window_attention_2d,
    window_attention_bwd,
)

NAMES = ("ln_scale", "ln_bias", "wq", "bq", "wkv", "bkv", "wproj", "bproj",
         "bias")
LINEAR = ("wq", "wkv", "wproj")  # JAX [in, out] vs torch [out, in]


def _jax_grads(x, g, p, mask, heads, residual, dtype):
    jd = jnp.dtype(dtype)
    jm = None if mask is None else jnp.asarray(mask)

    def f(x4, *a):
        return jax_fused_2d(x4, *a, mask=jm, heads=heads, window_size=WS,
                            compute_dtype=jd, interpret=True,
                            use_pallas_bwd=True, residual=residual)

    args = [jnp.asarray(p[k]) for k in NAMES]
    out, vjp = jax.vjp(f, jnp.asarray(x).astype(jd), *args)
    grads = vjp(jnp.asarray(g).astype(jd))
    res = {"x": np.asarray(grads[0].astype(jnp.float32))}
    for k, v in zip(NAMES, grads[1:]):
        v = np.asarray(v)
        res[k] = v.T if k in LINEAR else v
    return res


def _port_grads(x, g, p, mask, heads, residual, dtype, plain_forward=False):
    td = getattr(torch, dtype)
    xt = t(x).to(td).requires_grad_()
    tp = {k: v.requires_grad_() for k, v in _torch_params(p).items()}
    args = [tp[k] for k in NAMES]
    mt = None if mask is None else t(mask)
    if plain_forward:  # torch.autograd through the plain forward
        out = _plain_2d(xt, *args, mt, heads, WS, residual)
    else:
        out = fused_window_attention_2d(xt, *args, mt, heads=heads,
                                        window_size=WS, residual=residual)
    out.backward(t(g).to(td))
    res = {"x": n(xt.grad)}
    res.update({k: n(tp[k].grad) for k in NAMES})
    return res


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("residual", [False, True])
def test_plain_backward_matches_pallas_kernel(dtype, masked, residual):
    heads = 2
    p = _params(heads, seed=20)
    x = normal(30, (2, IMG, IMG, C))
    g = normal(31, (2, IMG, IMG, C))
    mask = jax_mask(IMG, IMG, WS, WS // 2) if masked else None
    ref = _jax_grads(x, g, p, mask, heads, residual, dtype)
    got = _port_grads(x, g, p, mask, heads, residual, dtype)
    assert sorted(got) == sorted(ref)
    for k in ref:
        if dtype == "float32":
            np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=1e-4,
                                       err_msg=k)
        else:
            scale = max(1.0, np.abs(ref[k]).max()) if k == "x" \
                else np.abs(ref[k]).max()
            assert np.abs(got[k] - ref[k]).max() <= 3e-2 * scale, k


@pytest.mark.parametrize("masked,residual", [(False, False), (True, True)])
def test_function_matches_autograd_of_plain_forward(masked, residual):
    """The Function's backward (the plain K3) against torch.autograd
    through the plain forward, f32: the same gradients up to sum order
    (the backward forms p = e / sum before the products, the forward
    divides after them)."""
    heads = 4
    p = _params(heads, seed=40)
    x = normal(41, (2, IMG, IMG, C))
    g = normal(42, (2, IMG, IMG, C))
    mask = jax_mask(IMG, IMG, WS, WS // 2) if masked else None
    got = _port_grads(x, g, p, mask, heads, residual, "float32")
    ref = _port_grads(x, g, p, mask, heads, residual, "float32",
                      plain_forward=True)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=1e-4,
                                   err_msg=k)


def test_backward_launches_or_raises_off_the_cpu():
    """K3's wrapper takes CUDA tensors only: any other device gets an error
    naming the shape, never the plain backward."""
    p = _torch_params(_params(1))
    p.pop("bproj")
    x = torch.empty(1, IMG, IMG, C, device="meta")
    with pytest.raises(ValueError, match=r"\(1, 8, 8, 32\)"):
        window_attention_bwd(x, x, **p, mask=None, heads=1, window_size=WS)
