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


def _params(seed: int = 0, c: int = C, ch: int = CH):
    """JAX layouts: dense kernels [in, out], depthwise kernel [3, 3, 1, Ch]."""
    return dict(
        ln_scale=1.0 + normal(seed, (c,), 0.1), ln_bias=normal(seed + 1, (c,), 0.1),
        w1=normal(seed + 2, (c, ch), c ** -0.5), b1=normal(seed + 3, (ch,), 0.1),
        wdw=normal(seed + 4, (3, 3, 1, ch), 1 / 3), bdw=normal(seed + 5, (ch,), 0.1),
        w2=normal(seed + 6, (ch, c), ch ** -0.5), b2=normal(seed + 7, (c,), 0.1))


def _torch_params(p):
    out = {k: t(v) for k, v in p.items()}
    out["w1"], out["w2"] = t(p["w1"].T.copy()), t(p["w2"].T.copy())
    out["wdw"] = t(p["wdw"].transpose(3, 2, 0, 1).copy())  # [Ch, 1, 3, 3]
    return out


# (map [B, H, W], C, residual, dtype): the tiny width C = 16 (hidden 64) on
# two maps, each residual and dtype; then FBANet-32's enc0 width (C = 32,
# hidden 128, the shape K2's C = 32 forms take on the card) in bf16 with
# the residual
CASES = [((b, h, w), C, residual, dtype)
         for b, h, w in ((2, 16, 16), (1, 24, 8))
         for residual in (False, True) for dtype in ("float32", "bfloat16")]
CASES.append(((1, 16, 16), 32, True, "bfloat16"))
IDS = [f"shape{i // 4}-{r}-{d}" for i, (_s, _c, r, d) in enumerate(CASES[:8])]
IDS.append("enc0-c32-True-bfloat16")


@pytest.mark.parametrize("shape,c,residual,dtype", CASES, ids=IDS)
def test_plain_matches_pallas_kernel_and_reference(shape, c, residual, dtype):
    p = _params(c=c, ch=4 * c)
    x = normal(shape[1], (*shape, c))
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
