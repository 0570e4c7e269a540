"""ECC registration of the port against the JAX package, every motion.

Realistic bursts (smooth fields with subpixel shifts, bench.py's
generator) go through both translation `align_burst`s; bursts that show one
scene through known homographies (chip_smoke's generator) go through the
euclidean, similarity, affine and homography ones. The recovered matrices
agree within 2e-3 px at the frame corners: the sums run in another order, so
an eps-terminated frame can stop one iteration earlier or later. Frame 0
stays bit-identical. The parameter <-> matrix maps agree to 1e-6 and the
closed-form Jacobian of the warped positions with `jax.jacfwd` to 1e-5
relative (f32 rounding of the same derivative).
"""

import jax
import numpy as np
import pytest
import torch
from torch_parity import n, rng, t

import bench
import chip_smoke
from fbanet_tpu.ops import registration as jreg
from fbanet_tpu_torch.ops import registration as reg


@pytest.fixture(scope="module")
def burst():
    return np.asarray(bench.make_realistic_bursts(2, 4, 32, seed=3))


@pytest.fixture(scope="module")
def jax_translation(burst):
    """JAX's translation align_burst at eps 1e-5 and its online_register
    ("ecc"), which runs that same align: compiled once, in one jit, for the
    two tests that compare against them."""
    return jax.jit(lambda b: (jreg.align_burst(
        b, motion="translation", levels=3, iters_per_level=25, eps=1e-5),
        jreg.online_register(b, "ecc")))(burst)


@pytest.mark.parametrize("eps", [1e-5, 0.0])
def test_align_burst_matches_jax(burst, eps, request):
    if eps == 1e-5:
        aligned_j, mats_j, rhos_j = request.getfixturevalue(
            "jax_translation")[0]
    else:
        aligned_j, mats_j, rhos_j = jax.jit(lambda b: jreg.align_burst(
            b, motion="translation", levels=3, iters_per_level=25,
            eps=eps))(burst)
    aligned, mats, rhos = reg.align_burst(t(burst), eps=eps)
    assert aligned.shape == burst.shape and mats.shape == (2, 4, 3, 3)
    np.testing.assert_allclose(n(mats), np.asarray(mats_j), atol=2e-3)
    np.testing.assert_allclose(n(rhos), np.asarray(rhos_j), atol=1e-3)
    np.testing.assert_allclose(n(aligned), np.asarray(aligned_j), atol=2e-3)
    np.testing.assert_array_equal(n(aligned[:, 0]), burst[:, 0])
    # the shifts are real: registration moved the frames
    assert np.abs(n(mats)[:, 1:, :2, 2]).max() > 0.5


def test_online_register_and_single_burst(burst, jax_translation):
    out = reg.online_register(t(burst))
    ref = jax_translation[1]
    np.testing.assert_allclose(n(out), np.asarray(ref), atol=2e-3)
    one, mats, _ = reg.align_burst(t(burst[1]), eps=1e-5)
    assert one.shape == burst.shape[1:] and mats.shape == (4, 3, 3)
    with pytest.raises(ValueError):  # as params_to_matrix in JAX
        reg.align_burst(t(burst), motion="projective")


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


MOTIONS = ["euclidean", "similarity", "affine", "homography"]


def _params(motion, seed, count=3):
    """Parameters near the identity: the identity's plus small noise."""
    p0 = np.asarray(jreg.identity_params(motion))
    scale = np.full(p0.shape, 0.02, np.float32)
    if motion != "euclidean":  # translations of a few px
        scale[{"similarity": [2, 3], "affine": [2, 5],
               "homography": [2, 5]}[motion]] = 2.0
    if motion == "homography":
        scale[6:] = 1e-4
    noise = rng(seed).standard_normal((count, p0.size)) * scale
    return (p0 + noise).astype(np.float32)


@pytest.mark.parametrize("motion", MOTIONS)
def test_params_matrix_maps_match_jax(motion):
    ps = _params(motion, seed=1)
    mats = reg.params_to_matrix(t(ps), motion)
    for p, m in zip(ps, n(mats)):
        np.testing.assert_allclose(
            m, np.asarray(jreg.params_to_matrix(p, motion)), atol=1e-6)
        np.testing.assert_allclose(
            n(reg.matrix_to_params(t(m), motion)),
            np.asarray(jreg.matrix_to_params(m, motion)), atol=1e-6)
    np.testing.assert_allclose(n(reg.matrix_to_params(mats, motion)), ps,
                               atol=1e-6)
    np.testing.assert_array_equal(n(reg.identity_params(motion)),
                                  np.asarray(jreg.identity_params(motion)))
    with pytest.raises(ValueError):
        reg.params_to_matrix(t(ps), "projective")


@pytest.mark.parametrize("motion", MOTIONS)
def test_warp_jacobian_matches_jacfwd(motion):
    h, w = 6, 7
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    grid = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w, np.float32)])
    ps = _params(motion, seed=2)
    cx, cy, jx, jy = reg._warp_coords(t(ps), t(grid[0]), t(grid[1]), motion)
    for i, p in enumerate(ps):
        ref = np.asarray(jreg._warp_coords(p, grid, motion))
        jac = np.asarray(jax.jacfwd(
            lambda q: jreg._warp_coords(q, grid, motion))(p))  # [2, N, P]
        np.testing.assert_allclose(n(cx[i]), ref[0], rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(n(cy[i]), ref[1], rtol=1e-6, atol=1e-5)
        for got, want in ((jx[i], jac[0]), (jy[i], jac[1])):
            np.testing.assert_allclose(n(got), want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def homography_burst():
    """B=2 bursts of 3 frames at 48 px with known homographies (shifts up
    to 1.5 px): every motion converges here at 3 pyramid levels."""
    return chip_smoke.make_homography_bursts(2, 3, 48, seed=6, shift=1.5)


@pytest.mark.parametrize("motion", MOTIONS)
def test_align_burst_matches_jax_every_motion(homography_burst, motion):
    burst, truth = homography_burst
    aligned_j, mats_j, rhos_j = jax.jit(lambda b: jreg.align_burst(
        b, motion=motion, levels=3, iters_per_level=25, eps=1e-6))(burst)
    aligned, mats, rhos = reg.align_burst(t(burst), motion=motion, eps=1e-6)
    assert aligned.shape == burst.shape and mats.shape == (2, 3, 3, 3)
    mats_j = np.asarray(mats_j)
    assert chip_smoke.corner_error(n(mats), np.linalg.inv(mats_j), 48) < 2e-3
    np.testing.assert_allclose(n(rhos), np.asarray(rhos_j), atol=1e-3)
    np.testing.assert_allclose(n(aligned), np.asarray(aligned_j), atol=2e-3)
    np.testing.assert_array_equal(n(aligned[:, 0]), burst[:, 0])
    # the registration is real: each matrix undoes its frame's homography
    assert chip_smoke.corner_error(n(mats)[:, 1:], truth[:, 1:], 48) < 0.35
    assert chip_smoke.corner_error(np.eye(3), truth[:, 1:], 48) > 1.0


@pytest.mark.parametrize("motion", ["translation", "affine"])
def test_ecc_align_pair_matches_jax(homography_burst, motion):
    """One [H, W] pair with an initial matrix, at fixed iteration counts."""
    gray = np.asarray(jreg.rgb_to_gray(homography_burst[0][0]))
    init = np.eye(3, dtype=np.float32)
    init[0, 2] = 0.5
    m_j, rho_j = jax.jit(lambda a, b: jreg.ecc_align(
        a, b, motion=motion, levels=2, iters_per_level=10,
        init_matrix=jax.numpy.asarray(init)))(gray[0], gray[2])
    m, rho = reg.ecc_align(t(gray[0]), t(gray[2]), motion=motion, levels=2,
                           iters_per_level=10, init_matrix=t(init))
    assert m.shape == (3, 3) and rho.shape == ()
    assert chip_smoke.corner_error(n(m), np.linalg.inv(np.asarray(m_j)),
                                   48) < 2e-3
    assert abs(float(rho) - float(rho_j)) < 1e-3


@pytest.mark.parametrize("interp", ["nearest", "bicubic"])
def test_align_burst_other_interpolations_match_jax(homography_burst, interp):
    burst = homography_burst[0][:1]
    aligned_j, mats_j, _ = jax.jit(lambda b: jreg.align_burst(
        b, motion="affine", levels=2, iters_per_level=10, interp=interp))(
            burst)
    aligned, mats, _ = reg.align_burst(t(burst), motion="affine", levels=2,
                                       iters_per_level=10, interp=interp)
    np.testing.assert_allclose(n(mats), np.asarray(mats_j), atol=1e-4)
    np.testing.assert_allclose(n(aligned), np.asarray(aligned_j), atol=2e-3)
    np.testing.assert_array_equal(n(aligned[:, 0]), burst[:, 0])
