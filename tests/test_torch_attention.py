"""K1's plain version (fbanet_tpu_torch.ops.attention) against the JAX
package: the XLA restatement `window_attention_reference` and the Pallas
kernel itself, `fused_window_attention_2d(interpret=True)`.

Tolerances: f32 1e-5 (the same math, sums in another order). bf16 against
the Pallas kernel 3e-2 absolute (one bf16 ulp of O(1) values is 8e-3; the
port follows the kernel's rounding points, its sums run in another order).
bf16 against the XLA reference 3e-2 relative to the output's largest value:
that reference rounds every product to bf16 where the kernel keeps f32, so
the two differ by a few ulps of the largest outputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import max_err, n, normal, t

from fbanet_tpu.models.layers import relative_position_index
from fbanet_tpu.models.layers import shift_attention_mask as jax_mask
from fbanet_tpu.ops.attention_pallas import (
    fused_window_attention_2d as jax_fused_2d,
)
from fbanet_tpu.ops.attention_pallas import (
    window_attention_reference as jax_reference,
)
from fbanet_tpu_torch.ops.attention import (
    fused_window_attention_2d,
    window_attention_reference,
    window_partition,
    window_reverse,
)

WS, IMG, C = 4, 8, 32
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _params(heads: int, seed: int = 0):
    """JAX-layout parameters ([in, out] dense kernels) and the gathered
    relative-position bias."""
    nn_ = WS * WS
    table = normal(seed + 7, ((2 * WS - 1) ** 2, heads), 0.5)
    idx = relative_position_index(WS).reshape(-1)
    bias = table[idx].reshape(nn_, nn_, heads).transpose(2, 0, 1)
    return dict(
        ln_scale=1.0 + normal(seed, (C,), 0.1), ln_bias=normal(seed + 1, (C,), 0.1),
        wq=normal(seed + 2, (C, C), C ** -0.5), bq=normal(seed + 3, (C,), 0.1),
        wkv=normal(seed + 4, (C, 2 * C), C ** -0.5),
        bkv=normal(seed + 5, (2 * C,), 0.1),
        wproj=normal(seed + 6, (C, C), C ** -0.5),
        bproj=normal(seed + 8, (C,), 0.1), bias=np.ascontiguousarray(bias))


def _torch_params(p):
    out = {k: t(v) for k, v in p.items()}
    for k in ("wq", "wkv", "wproj"):  # [in, out] -> torch Linear [out, in]
        out[k] = t(p[k].T.copy())
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("heads", [1, 2, 4])
def test_plain_matches_pallas_kernel_and_reference(dtype, masked, residual,
                                                   heads):
    p = _params(heads)
    x = normal(heads, (2, IMG, IMG, C))
    mask = jax_mask(IMG, IMG, WS, WS // 2) if masked else None
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jx = jnp.asarray(x).astype(jd)
    jm = None if mask is None else jnp.asarray(mask)

    got = fused_window_attention_2d(
        t(x).to(td), **_torch_params(p), mask=None if mask is None else t(mask),
        heads=heads, window_size=WS, residual=residual)
    assert got.dtype == td and got.shape == x.shape
    kernel = jax_fused_2d(jx, **jp, mask=jm, heads=heads, window_size=WS,
                          compute_dtype=jd, interpret=True, residual=residual)
    assert max_err(got, kernel) <= TOL[dtype]

    # the XLA reference works on windows and has no residual
    win = window_attention_reference(
        window_partition(t(x).to(td), WS), **_torch_params(p),
        mask=None if mask is None else t(mask), heads=heads)
    ref = jax_reference(jx.reshape(2, 2, WS, 2, WS, C).transpose(
        0, 1, 3, 2, 4, 5).reshape(8, WS * WS, C), **jp, mask=jm, heads=heads,
        compute_dtype=jd)
    assert max_err(win, ref) <= TOL[dtype] * max(1.0, np.abs(n(ref)).max())
    branch = window_reverse(win, WS, IMG, IMG)
    if residual:
        np.testing.assert_allclose(
            n(got), n(branch.float() + t(x).to(td).float()),
            atol=TOL[dtype] * 2)


def test_partition_roundtrip_and_layout():
    x = t(normal(0, (2, 8, 12, 3)))
    w = window_partition(x, 4)
    assert w.shape == (12, 16, 3)
    np.testing.assert_array_equal(n(w[1, 0]), n(x[0, 0, 4]))
    np.testing.assert_array_equal(n(window_reverse(w, 4, 8, 12)), n(x))


def test_no_kernel_device_raises():
    """Off the CPU the dispatcher launches the kernel or raises: a device
    with no kernel gets an error naming the shape, never the plain path."""
    p = _torch_params(_params(1))
    x = torch.empty(1, IMG, IMG, C, device="meta")
    with pytest.raises(ValueError, match=r"\(1, 8, 8, 32\)"):
        fused_window_attention_2d(x, **p, mask=None, heads=1, window_size=WS)
