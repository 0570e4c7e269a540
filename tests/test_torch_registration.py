"""Translation ECC registration of the port against the JAX package.

Realistic bursts (smooth fields with subpixel shifts, bench.py's
generator) go through both `align_burst`s. The recovered translations agree
within 2e-3 px: the sums run in another order, so an eps-terminated frame can
stop one iteration earlier or later. Frame 0 stays bit-identical.
"""

import jax
import numpy as np
import pytest
import torch
from torch_parity import n, t

import bench
import chip_smoke
from fbanet_tpu.ops import registration as jreg
from fbanet_tpu_torch.ops import registration as reg


@pytest.fixture(scope="module")
def burst():
    return np.asarray(bench.make_realistic_bursts(2, 4, 32, seed=3))


@pytest.mark.parametrize("eps", [1e-5, 0.0])
def test_align_burst_matches_jax(burst, eps):
    aligned_j, mats_j, rhos_j = jax.jit(lambda b: jreg.align_burst(
        b, motion="translation", levels=3, iters_per_level=25, eps=eps))(burst)
    aligned, mats, rhos = reg.align_burst(t(burst), eps=eps)
    assert aligned.shape == burst.shape and mats.shape == (2, 4, 3, 3)
    np.testing.assert_allclose(n(mats), np.asarray(mats_j), atol=2e-3)
    np.testing.assert_allclose(n(rhos), np.asarray(rhos_j), atol=1e-3)
    np.testing.assert_allclose(n(aligned), np.asarray(aligned_j), atol=2e-3)
    np.testing.assert_array_equal(n(aligned[:, 0]), burst[:, 0])
    # the shifts are real: registration moved the frames
    assert np.abs(n(mats)[:, 1:, :2, 2]).max() > 0.5


def test_online_register_and_single_burst(burst):
    out = reg.online_register(t(burst))
    ref = jax.jit(lambda b: jreg.online_register(b, "ecc"))(burst)
    np.testing.assert_allclose(n(out), np.asarray(ref), atol=2e-3)
    one, mats, _ = reg.align_burst(t(burst[1]), eps=1e-5)
    assert one.shape == burst.shape[1:] and mats.shape == (4, 3, 3)
    with pytest.raises(NotImplementedError):
        reg.align_burst(t(burst), motion="affine")


def test_pyramid_and_gradients_match_jax(burst):
    gray = n(reg.rgb_to_gray(t(burst)))
    np.testing.assert_allclose(gray, np.asarray(jreg.rgb_to_gray(burst)),
                               atol=1e-6)
    img = gray[0, 1]
    np.testing.assert_allclose(
        n(reg._blur_and_halve(t(img[None])))[0],
        np.asarray(jreg._blur_and_halve(img)), atol=1e-6)
    for a, b in zip(reg._image_gradients(t(img[None])),
                    jreg._image_gradients(img)):
        np.testing.assert_allclose(n(a)[0], np.asarray(b), atol=1e-6)


def test_translation_warp_matches_matrix_form(burst):
    stack = burst[0, 1].transpose(2, 0, 1)  # [3, H, W]
    p = np.array([1.37, -2.81], np.float32)  # beyond the edge on two sides
    ref = jreg._warp_translation_mm(stack, p)
    got = reg.warp_translation(t(stack[None].copy()), t(p[None]))[0]
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-6)


def test_chip_smoke_bursts_are_bench_bursts():
    """chip_smoke.py carries a numpy copy of the bench generator (the card
    has no JAX); it must stay the same generator."""
    ours = chip_smoke.make_realistic_bursts(2, 3, 16, seed=4)
    np.testing.assert_array_equal(
        ours, np.asarray(bench.make_realistic_bursts(2, 3, 16, seed=4)))
    lr, hr = chip_smoke.make_realistic_bursts(2, 3, 16, seed=4, hr_scale=4)
    np.testing.assert_array_equal(lr, ours)
    assert hr.shape == (2, 64, 64, 3) and 0 <= hr.min() and hr.max() <= 1
    # the HR field is the clean frame 0: its 4x box-average matches the LR
    # frame up to the sensor noise
    box = hr.reshape(2, 16, 4, 16, 4, 3).mean((2, 4))
    assert np.abs(box - lr[:, 0]).mean() < 0.02
    assert torch.from_numpy(hr).isfinite().all()
