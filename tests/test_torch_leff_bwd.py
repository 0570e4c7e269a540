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
