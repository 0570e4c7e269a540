"""K2's plain version (fbanet_tpu_torch.ops.leff) against the JAX package:
the XLA restatement `leff_reference` and the Pallas kernel itself,
`fused_leff(interpret=True)`.

Tolerances: f32 1e-5 (the same math, sums in another order). bf16 3e-2
absolute against the kernel, whose rounding points the port follows, and 3e-2
relative to the output's largest value against the XLA reference, which
rounds the dense products and the depthwise taps to bf16 where the kernel
keeps f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import max_err, n, normal, t

from fbanet_tpu.ops.leff_pallas import fused_leff as jax_fused_leff
from fbanet_tpu.ops.leff_pallas import leff_reference as jax_reference
from fbanet_tpu_torch.ops.leff import fused_leff, leff_reference

C, CH = 16, 64
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _params(seed: int = 0):
    """JAX layouts: dense kernels [in, out], depthwise kernel [3, 3, 1, Ch]."""
    return dict(
        ln_scale=1.0 + normal(seed, (C,), 0.1), ln_bias=normal(seed + 1, (C,), 0.1),
        w1=normal(seed + 2, (C, CH), C ** -0.5), b1=normal(seed + 3, (CH,), 0.1),
        wdw=normal(seed + 4, (3, 3, 1, CH), 1 / 3), bdw=normal(seed + 5, (CH,), 0.1),
        w2=normal(seed + 6, (CH, C), CH ** -0.5), b2=normal(seed + 7, (C,), 0.1))


def _torch_params(p):
    out = {k: t(v) for k, v in p.items()}
    out["w1"], out["w2"] = t(p["w1"].T.copy()), t(p["w2"].T.copy())
    out["wdw"] = t(p["wdw"].transpose(3, 2, 0, 1).copy())  # [Ch, 1, 3, 3]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 24, 8)])
def test_plain_matches_pallas_kernel_and_reference(dtype, residual, shape):
    p = _params()
    x = normal(shape[1], (*shape, C))
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jx = jnp.asarray(x).astype(jd)

    got = fused_leff(t(x).to(td), **_torch_params(p), residual=residual)
    assert got.dtype == td and got.shape == x.shape
    kernel = jax_fused_leff(jx, **jp, compute_dtype=jd, interpret=True,
                            residual=residual)
    assert max_err(got, kernel) <= TOL[dtype]

    branch = leff_reference(t(x).to(td), **_torch_params(p))
    ref = jax_reference(jx, **jp, compute_dtype=jd)
    assert max_err(branch, ref) <= TOL[dtype] * max(1.0, np.abs(n(ref)).max())
    if residual:
        np.testing.assert_allclose(
            n(got), n(branch.float() + t(x).to(td).float()),
            atol=TOL[dtype] * 2)


def test_gelu_is_the_tanh_approximation():
    import jax

    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    ours = torch.nn.functional.gelu(t(x), approximate="tanh")
    assert max_err(ours, jax.nn.gelu(jnp.asarray(x))) <= 1e-6


def test_no_kernel_device_raises():
    p = _torch_params(_params())
    x = torch.empty(1, 8, 8, C, device="meta")
    with pytest.raises(ValueError, match=r"\(1, 8, 8, 16\)"):
        fused_leff(x, **p)
