"""The port's evaluation step and metrics against the JAX package.

`eval_step(..., online_align="ecc")` = online ECC registration -> forward
-> clamp to [0, 1] -> per-image PSNR and SSIM with the 40-px boundary
crop, the jitted step of fbanet_tpu/evaluate.py:62-70. Tiny model, random parameters, f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import TINY, flax_params_like, max_err, n, rng, t

import bench
from fbanet_tpu import metrics as jmetrics
from fbanet_tpu.models import create_model as jax_create_model
from fbanet_tpu.ops.registration import online_register
from fbanet_tpu.train import to_unit_f32 as jax_to_unit_f32
from fbanet_tpu_torch import metrics
from fbanet_tpu_torch.evaluate import eval_step
from fbanet_tpu_torch.models import create_model
from fbanet_tpu_torch.utils.weights import random_state_dict


def test_eval_step_matches_jax():
    tmodel = create_model(TINY, device="cpu")
    sd = random_state_dict(tmodel, seed=21)
    tmodel.load_state_dict(sd, strict=True)
    lr = np.asarray(bench.make_realistic_bursts(2, 3, 32, seed=9))
    hr = rng(9).uniform(0.2, 0.8, (2, 128, 128, 3)).astype(np.float32)
    lr8 = np.round(lr * 255).astype(np.uint8)  # the storage-integer wire
    jmodel = jax_create_model(TINY)
    params = flax_params_like(jmodel, jnp.asarray(lr), state_dict=sd)

    @jax.jit
    def step(p, lr, hr):
        lr, hr = jax_to_unit_f32(lr), jax_to_unit_f32(hr)
        lr = online_register(lr, "ecc")
        pred = jnp.clip(jmodel.apply({"params": p}, lr, deterministic=True),
                        0.0, 1.0)
        return (pred, jmetrics.psnr(pred, hr, boundary_ignore=40),
                jmetrics.ssim(pred, hr, boundary_ignore=40))

    pred_j, psnr_j, ssim_j = step(params, lr8, hr)
    pred, p, s, hr_unit = eval_step(tmodel, t(lr8), t(hr), online_align="ecc")
    assert pred.shape == (2, 128, 128, 3) and hr_unit.dtype == torch.float32
    assert 0.0 <= float(pred.min()) and float(pred.max()) <= 1.0
    assert max_err(pred, pred_j) <= 2e-3  # ECC stop points may differ (eps)
    np.testing.assert_allclose(n(p), np.asarray(psnr_j), atol=1e-2)
    np.testing.assert_allclose(n(s), np.asarray(ssim_j), atol=1e-3)


@pytest.mark.parametrize("boundary", [None, 4])
def test_psnr_ssim_match_jax(boundary):
    a = rng(1).uniform(0, 1, (3, 24, 20, 3)).astype(np.float32)
    b = np.clip(a + rng(2).normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    for ours, theirs, tol in ((metrics.psnr, jmetrics.psnr, 1e-4),
                              (metrics.ssim, jmetrics.ssim, 1e-5)):
        got = ours(t(a), t(b), boundary_ignore=boundary)
        ref = theirs(jnp.asarray(a), jnp.asarray(b), boundary_ignore=boundary)
        assert got.shape == (3,)
        np.testing.assert_allclose(n(got), np.asarray(ref), atol=tol)


def test_finite_average_and_wire_normalisation():
    vals = [30.0, float("nan"), 20.0, float("inf")]
    assert metrics.finite_average(vals) == jmetrics.finite_average(vals) == 12.5
    assert metrics.finite_average(torch.tensor([1.0, 3.0]), 4) == 1.0
    for dtype in (np.uint8, np.uint16):
        x = rng(3).integers(0, np.iinfo(dtype).max, (4, 5)).astype(dtype)
        np.testing.assert_array_equal(
            n(metrics.to_unit_f32(torch.from_numpy(x.astype(np.int32)).to(
                torch.uint8 if dtype == np.uint8 else torch.uint16))),
            np.asarray(jax_to_unit_f32(jnp.asarray(x))))
    f = torch.rand(3)
    assert metrics.to_unit_f32(f) is f
